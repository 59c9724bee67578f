"""Roofline terms of a dry-run step (port of :mod:`repro.roofline.analysis`).

Three terms per (arch x shape x mesh), all per chip:

    t_compute    = flops / peak_FLOP/s
    t_memory     = bytes / HBM_bw
    t_collective = collective_bytes / link_bw

The reference reads flops and bytes from XLA's ``cost_analysis()`` and
parses collectives out of the optimized HLO. The port has no compiler to
ask: :class:`StepCounter`, a ``TorchDispatchMode``, watches the step run
once on DTensors over fake tensors (:mod:`repro_torch.launch.dryrun`). It
lets every DTensor op through to DTensor's own dispatch and records what
that issues on each rank's local shards:

* **flops** and **bytes**: each local op is recorded as a node (its class,
  its flops, the buffers it reads and writes by serial number and bytes;
  a view is its base's buffer, a slice read counts its part), and
  :meth:`StepCounter.report` charges the nodes as XLA:CPU's cost analysis
  charges the fused module (:mod:`repro_torch.roofline.cost_model`:
  fusion of elementwise chains, dots, split reductions, whole-operand
  gathers, scatters, TopK, XLA:CPU's fp32 upcast of 16-bit products,
  collectives' operands and results). Shapes are LOCAL, so a sharded
  product counts the rank's share (``FlopCounterMode`` around a DTensor
  op counts the global op). A composite op (softmax, norms, ``var``) is
  recorded through its decomposition, as the instructions XLA sees;
* **collectives**: the c10d functional collectives (all_gather_into_tensor,
  all_reduce, reduce_scatter_tensor, all_to_all_single, DTensor's
  shard_dim_alltoall, and any point-to-point) with the reference's ring
  accounting by group size G on the result bytes r:

    all-gather          r (G-1)/G
    all-reduce          2 r (G-1)/G
    reduce-scatter      r (G-1)          (operand = G r)
    all-to-all          r (G-1)/G
    permute / p2p       r

  A group whose ranks span more than one node of ``hw.node_size``
  consecutive ranks is charged at ``hw.cross_node_bw`` (``cross`` bytes);
* **memory**: the peak of the bytes the step's local ops hold alive at
  once (arguments excluded; the dry-run adds their exact per-chip bytes).

Cells with a closed-form cost (``Cell.analytic``, the LM cells) take their
flops and bytes from it, as the reference's dry-run does.

Hardware: ``HW_H100`` is one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet):
989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM, NVLink 450e9 B/s each way
inside a node of 8, and one 400 Gb/s NDR port (50e9 B/s) per GPU across
nodes. ``HW_V5E`` keeps the reference's TPU constants for comparisons only.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .cost_model import VARIADIC_REDUCE_FLOPS, Node, charge, reduce_mid

__all__ = ["Hardware", "HW_H100", "HW_V5E", "roofline_terms",
           "ring_bytes", "StepCounter", "COLLECTIVES"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, bf16 dense
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link inside a node
    cross_node_bw: float | None = None   # bytes/s per chip across nodes
    node_size: int = 0         # chips per node (0: one node holds all)


HW_H100 = Hardware(name="h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                   ici_bw=450e9, cross_node_bw=50e9, node_size=8)
HW_V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                  ici_bw=50e9)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_bytes(op: str, result_bytes: float, g: int) -> float:
    """Bytes one chip moves for a ring collective over ``g`` ranks whose
    result is ``result_bytes`` (the reference's accounting)."""
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)                    # permute / p2p


def roofline_terms(
    *, flops: float, bytes_accessed: float, collective_bytes: float,
    n_devices: int, hw: Hardware = HW_H100, cross_node_bytes: float = 0.0,
) -> dict:
    """The three terms in seconds + the dominant bottleneck. Inputs are per
    chip; ``cross_node_bytes`` (a part of ``collective_bytes``) moves at
    ``hw.cross_node_bw``."""
    del n_devices  # inputs already per chip; kept for the report signature
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    cross_bw = hw.cross_node_bw or hw.ici_bw
    t_coll = ((collective_bytes - cross_node_bytes) / hw.ici_bw
              + cross_node_bytes / cross_bw)
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
    }
    dom = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)
    terms["bottleneck"] = dom.replace("t_", "").replace("_s", "")
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    """The tensors of a tree of lists, tuples and dicts (an op's
    arguments or results), in no fixed order."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _ordered(tree) -> list:
    """The tensors of an op's arguments in argument order."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_ordered(x))
    return out


def _extent(t) -> int:
    """Bytes a read of view ``t`` touches: its elements, a broadcast
    (stride 0) dim counted once, at most its storage."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return min(n, t.untyped_storage().nbytes()) if t.numel() else 0


_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
}
# ops that move no bytes of their own
_FREE = {"detach", "empty", "empty_strided", "empty_like", "lift_fresh",
         "device", "wait_tensor", "_wrap_tensor_autograd", "sym_size",
         "sym_stride", "sym_numel", "_local_scalar_dense", "is_same_size",
         "new_empty", "new_empty_strided", "detach_", "resolve_conj",
         "resolve_neg", "record_stream"}

# XLA:CPU's instruction classes for the ops outside torch's pointwise tag
# (see :mod:`repro_torch.roofline.cost_model`)
_REDUCES = {"sum", "mean", "amax", "amin", "prod", "any", "all", "max",
            "min", "argmax", "argmin", "nansum"}
_VARIADIC = {"argmax", "argmin"}
_GATHERS = {"index_select", "embedding", "index", "gather"}
_SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_reduce", "scatter_reduce_", "index_copy",
             "index_copy_"}
_SORTS = {"sort"}
# fusible ops outside torch's pointwise tag
_FUSIBLE = {"_to_copy", "to", "copy", "copy_", "cat", "stack",
            "constant_pad_nd", "select_backward", "slice_backward",
            "zeros", "ones", "full", "zeros_like", "ones_like",
            "new_zeros", "fill_", "zero_", "scalar_tensor", "arange",
            "tril_indices", "repeat", "floor_divide"}
# fusible ops that only move data: no flops
_MOVES = _FUSIBLE - {"_to_copy", "to", "floor_divide"} | {"clone"}
# transcendentals: ``HloCostAnalysis`` counts them apart from flops
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log2",
                   "log10", "log1p", "tanh", "tanh_", "sigmoid", "sigmoid_",
                   "sqrt", "sqrt_", "rsqrt", "rsqrt_", "sin", "cos", "tan",
                   "erf", "erfc", "erfinv", "atan2", "logit", "cbrt"}
# pointwise ops that are several HLO instructions (flops an element)
_MULTI = {"addcmul": 2, "addcmul_": 2, "addcdiv": 2, "addcdiv_": 2,
          "lerp": 3, "lerp_": 3, "threshold_backward": 2, "clamp": 2,
          "clamp_": 2, "leaky_relu": 3, "leaky_relu_": 3,
          "remainder": 6, "floor_divide": 8}
_DIVIDES = {"div", "div_", "reciprocal", "reciprocal_", "remainder",
            "floor_divide"}
_BIASED = {"addmm", "baddbmm", "addmv"}           # the bias is argument 0
# ops whose written argument is overwritten, not read
_OVERWRITE = {"copy_", "fill_", "zero_"}


def _pointwise_flops(name: str, args, kwargs) -> float:
    """HLO instructions an element of a pointwise aten op becomes."""
    if name in _TRANSCENDENTAL:
        return 0.0
    if name.startswith("pow"):
        e = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(e, (int, float)) and float(e).is_integer() and e >= 1:
            return float(max(int(e) - 1, 1))
        return 0.0
    n = float(_MULTI.get(name, 1))
    alpha = kwargs.get("alpha", args[2] if len(args) > 2 and name in (
        "add", "add_", "sub", "sub_") else 1)
    if name in ("addcmul", "addcmul_", "addcdiv", "addcdiv_"):
        alpha = kwargs.get("value", args[3] if len(args) > 3 else 1)
    if isinstance(alpha, (int, float)) and alpha != 1:
        n += 1
    return n


def _reduced_dims(args, kwargs, x) -> list[int]:
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if isinstance(dim, bool) or not isinstance(dim, (int, list, tuple)) \
            or (isinstance(dim, (list, tuple)) and not dim):
        return list(range(x.dim()))
    dims = [dim] if isinstance(dim, int) else list(dim)
    return sorted({d % max(x.dim(), 1) for d in dims})


# ops recorded through torch's decomposition (the instructions XLA sees)
_DECOMPOSE = {"_softmax", "_log_softmax", "_softmax_backward_data",
              "_log_softmax_backward_data", "linalg_vector_norm",
              "leaky_relu_backward"}


def _var(x, dim=None, *, correction=1, keepdim=False):
    """``var`` as the reference's ``jnp.var``: a mean, the centred
    squares, their sum."""
    dims = list(range(x.dim())) if dim is None else (
        [dim] if isinstance(dim, int) else list(dim))
    n = 1
    for d in dims:
        n *= x.shape[d]
    c = x - torch.mean(x, dims, keepdim=True)
    return torch.sum(c * c, dims, keepdim=keepdim) / max(
        n - (1 if correction is None else correction), 1)


class StepCounter(TorchDispatchMode):
    """Records one rank's local ops, collectives and peak live bytes as the
    step runs under it; :meth:`report` charges the recorded ops as XLA:CPU's
    cost analysis would (see the module docstring)."""

    def __init__(self, hw: Hardware = HW_H100, fake_mode=None):
        super().__init__()
        self.hw = hw
        self.fake_mode = fake_mode
        self.collective = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.cross_node = 0.0
        self.live = 0
        self.peak = 0
        self.replicated: set[str] = set()
        self.nodes: list[Node] = []
        self.roots: dict | None = None
        self._held: dict[int, int] = {}
        self._in_dtensor = False
        self._serial: dict[int, int] = {}     # id(storage) -> serial
        self._serial_log: list[int] = []      # serial -> storage bytes
        self._value: dict[int, int] = {}      # serial -> its current value
        self._born: set[int] = set()          # storages the step made
        self._updated: set[int] = set()       # step inputs it writes
        self._n_values = 0

    # ------------------------------------------------------------- report
    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())

    @property
    def ops(self) -> int:
        return len(self.nodes)

    def outputs(self, tree) -> None:
        """Name the step's results: a node none of whose results reaches
        them (or a step input it updates in place) is dead code."""
        self.roots = {}
        for t in _tensors(tree):
            if self._known(t):
                v, r, w, _ = self._read(t)
                self.roots[v] = (r, w)
        for serial, v in self._value.items():
            if serial in self._updated:
                self.roots.setdefault(v, (1, 1))

    def report(self) -> dict:
        cost = charge(self.nodes, self.roots)
        return {**cost,
                "collective_bytes": self.collective_bytes,
                "cross_node_bytes": self.cross_node,
                "collective_detail": dict(self.collective),
                "collective_counts": dict(self.counts),
                "peak_step_bytes": self.peak, "local_ops": self.ops,
                "replicated_ops": sorted(self.replicated)}

    # ------------------------------------------------------------ values
    def _storage_serial(self, t) -> tuple[int, bool]:
        """The serial number of ``t``'s storage (a fresh one the first time
        a storage is seen; freed storages' ids are reused, so the entry
        goes with the storage) and whether it is new."""
        st = t.untyped_storage()
        key = id(st)
        serial = self._serial.get(key)
        if serial is not None:
            return serial, False
        serial = len(self._serial_log)
        self._serial_log.append(st.nbytes())
        self._serial[key] = serial
        weakref.finalize(st, self._serial.pop, key, None)
        return serial, True

    def _alias(self, src, outs) -> None:
        """Results of a view or a free op (``wait_tensor``, DTensor's
        autograd wrap) on a storage of their own are ``src``'s buffer."""
        if not self._known(src):
            return
        serial = self._storage_serial(src)[0]
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in self._serial:
                self._serial[id(st)] = serial
                weakref.finalize(st, self._serial.pop, id(st), None)

    def _known(self, t) -> bool:
        try:
            return id(t.untyped_storage()) in self._serial
        except (RuntimeError, NotImplementedError):
            return False

    def _new_value(self, serial: int) -> int:
        self._n_values += 1
        self._value[serial] = self._n_values
        return self._n_values

    def _read(self, t):
        """(value id, bytes read, whole bytes, view key) of a read of ``t``."""
        serial, new = self._storage_serial(t)
        v = self._new_value(serial) if new else self._value[serial]
        return (v, _extent(t), self._serial_log[serial],
                (t.storage_offset(), tuple(t.shape), tuple(t.stride())))

    def _write(self, t):
        """(value id, bytes written) of a result ``t``: a new value of its
        storage."""
        serial, new = self._storage_serial(t)
        if new:
            self._born.add(serial)
        elif serial not in self._born:
            self._updated.add(serial)
        return self._new_value(serial), _extent(t)

    def _synthetic(self, nbytes):
        self._n_values += 1
        return self._n_values, nbytes

    def _group(self, args, kwargs):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        for a in list(args) + list(kwargs.values()):
            if isinstance(a, str):
                try:
                    pg = _resolve_process_group(a)
                except (ValueError, RuntimeError, KeyError):
                    continue
                return dist.get_process_group_ranks(pg)
        return list(range(dist.get_world_size()))

    def _collective(self, op, ranks, out) -> None:
        g = len(ranks)
        moved = ring_bytes(op, sum(_nbytes(t) for t in _tensors(out)), g)
        self.collective[op] += moved
        self.counts[op] += 1
        node = self.hw.node_size
        if node and len({r // node for r in ranks}) > 1:
            self.cross_node += moved

    def _hold(self, outs) -> None:
        """Count each new storage an op returns (``outs``, its result
        tensors) as live until the tensor that first held it is freed (an
        in-place result is not new)."""
        for t in outs:
            try:
                key = t.untyped_storage()._cdata
            except (RuntimeError, NotImplementedError):
                continue
            if key in self._held:
                continue
            n = t.untyped_storage().nbytes()
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def _unfaked(self):
        """DTensor's own dispatch runs outside the dry-run's fake mode: its
        bookkeeping tensors are small and real (it reads their values),
        while the local shards stay fake and their ops fake."""
        import contextlib

        from torch._subclasses.fake_tensor import unset_fake_temporarily

        return (unset_fake_temporarily() if self.fake_mode is not None
                else contextlib.nullcontext())

    def _snapshot(self):
        return (dict(self.collective), dict(self.counts), self.cross_node,
                len(self.nodes))

    def _restore(self, snap) -> None:
        self.collective, self.counts = dict(snap[0]), dict(snap[1])
        self.cross_node = snap[2]
        del self.nodes[snap[3]:]

    def _dtensor_op(self, func, args, kwargs):
        """A DTensor op: DTensor's own dispatch with this mode pushed again,
        so its local ops and collectives are counted. Where DTensor cannot
        place it (no sharding rule, or a layout its propagation refuses),
        the counts of the failed try are dropped and the op runs on
        replicated inputs (an in-place op whose layout DTensor changed keeps
        its own layout, as it keeps its own local shard): every DTensor argument is gathered (the implied
        all-gathers are counted), the op runs locally, an in-place op hands
        back its own (unchanged) DTensor and any other returns replicated
        DTensors. The op's name goes to ``replicated``."""
        snap = self._snapshot()
        self._in_dtensor = True
        mutated = args[0] if (func._schema.is_mutable and args and type(
            args[0]).__name__ == "DTensor") else None
        spec = None if mutated is None else mutated._spec
        try:
            with self._unfaked(), self:
                return func(*args, **kwargs)
        except Exception:  # noqa: BLE001 — any refusal; the retry re-raises
            pass
        finally:
            self._in_dtensor = False
            if mutated is not None and mutated._spec is not spec:
                # an in-place op DTensor ran on a redistributed copy: the
                # tensor keeps its own local shard, so it keeps its layout
                mutated._spec = spec
        self._restore(snap)
        self.replicated.add(str(func))
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map

        mesh = next(a.device_mesh for a in _tensors((args, kwargs))
                    if isinstance(a, DTensor))
        rep = [Replicate()] * mesh.ndim

        def local(x):
            if isinstance(x, DTensor):
                return x.redistribute(mesh, rep).to_local()
            return x

        self._in_dtensor = True
        try:
            with self._unfaked(), self:
                out = func(*tree_map(local, args), **tree_map(local, kwargs))
        finally:
            self._in_dtensor = False
        if func._schema.is_mutable and args and isinstance(args[0], DTensor):
            return args[0]
        return tree_map(lambda t: DTensor.from_local(t, mesh, rep,
                                                     run_check=False)
                        if isinstance(t, torch.Tensor) else t, out)

    def _mine(self, tensors) -> bool:
        """Whether an op is the rank's work: DTensor's bookkeeping (real
        tensors, or its own fake tensors of global shapes that it runs an
        op on to learn the output's metadata) is not."""
        return self.fake_mode is None or any(
            getattr(t, "fake_mode", None) is self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            if self._in_dtensor:
                return NotImplemented     # DTensor's own dispatch runs it
            return self._dtensor_op(func, args, kwargs)
        name = func._overloadpacket.__name__
        decomp = _decomposition(func, name)
        if decomp is not None and self._mine(_tensors((args, kwargs))):
            with self:
                return decomp(*args, **kwargs)
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self._mine(ins + outs):
            return out
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "_dtensor", "c10d") and name in _C10D:
            op = _C10D[name]
            self._collective(op, self._group(args, kwargs), out)
            res = _ordered([out])
            self.nodes.append(Node(
                "collective", name,
                float(sum(t.numel() for t in res))
                if op in ("all-reduce", "reduce-scatter") else 0.0,
                [self._read(t) for t in _ordered(args)],
                [self._write(t) for t in res]))
            return out
        if name in _FREE or func.is_view:
            if ins:
                self._alias(ins[0], outs)
            return out
        if self._record(func, name, args, kwargs, out):
            self._hold(outs)
        return out

    # ------------------------------------------------------------ record
    def _record(self, func, name, args, kwargs, out) -> bool:
        """Append the op's :class:`Node`; False when it only hands back an
        input (an alias: no work)."""
        schema = func._schema
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        reads, overwritten = [], []
        for an, v in [(a.name, v) for a, v in zip(schema.arguments, args)] \
                + list(kwargs.items()):
            if an in written and (name in _OVERWRITE or an.startswith("out")):
                overwritten += _ordered([v])
            else:
                reads += _ordered([v])
        res = _ordered([out])
        if not schema.is_mutable:
            mine = {id(t.untyped_storage()) for t in reads}
            res = [t for t in res if id(t.untyped_storage()) not in mine]
            if not res:
                return False
        cls, flops, expensive = _classify(func, name, args, kwargs, reads,
                                          res)
        if cls == "dot" and name in _BIASED:
            self._biased_dot(kwargs, reads, res, flops)
            return True
        if cls == "dot" and len(reads) == 2 and len(res) == 1:
            self._dot(flops, reads, self._write(res[0]), res[0].dtype)
            return True
        ins = [self._read(t) for t in reads]
        if cls == "gather" and ins:           # the table is read whole
            ins[0] = (ins[0][0], ins[0][2], ins[0][2], ins[0][3])
        partial = False
        for t in overwritten:
            v, r, w, key = self._read(t)
            if r < w:                          # a write into part of a buffer
                ins.append((v, 0, w, key))
                partial = True
        mid = 0.0
        if cls == "reduce" and name not in _VARIADIC and len(res) == 1:
            x = reads[0]
            mid = reduce_mid(tuple(x.shape), _reduced_dims(args, kwargs, x),
                             res[0].element_size())
        if cls == "reduce" and not mid:
            cls = "fuse"                       # a reduce XLA fuses whole
        outs = [self._write(t) for t in res]
        partial = partial or any(
            b < self._serial_log[self._storage_serial(t)[0]]
            for t, (_, b) in zip(res, outs))
        self.nodes.append(Node(
            cls, name, flops, ins, outs, expensive=expensive, mid=mid,
            size=res[0].numel(),
            partial=partial and cls == "fuse",
            sort_f32_desc=cls == "sort" and _topk_like(args, kwargs,
                                                       reads[0])))
        return True

    def _biased_dot(self, kwargs, reads, res, flops) -> None:
        """``addmm``-style: a dot, then the bias added by a fusible op (XLA
        does not fuse the add into a matrix-matrix dot)."""
        bias, mats, out = reads[0], reads[1:], res[0]
        tmp = self._synthetic(_nbytes(out))
        self._dot(flops, mats, tmp, out.dtype)
        extra = sum(1 for k in ("beta", "alpha") if kwargs.get(k, 1) != 1)
        self.nodes.append(Node(
            "fuse", "add", float(out.numel() * (1 + extra)),
            [(tmp[0], tmp[1], tmp[1], None), self._read(bias)],
            [self._write(out)]))

    def _dot(self, flops, mats, out, dtype) -> None:
        """A product of two operands into value ``out``. XLA:CPU computes
        a 16-bit product its dot library does not take in fp32: each
        operand converted first (a fusible op, so it joins the operand's
        producer) and a 16-bit result converted back."""
        ins = [self._read(t) for t in mats]
        if mats[0].dtype not in (torch.bfloat16, torch.float16) or \
                _native_low_dot(*mats, dtype):
            self.nodes.append(Node("dot", "mm", flops, ins, [out]))
            return
        wide = []
        for t, r in zip(mats, ins):
            w = self._synthetic(4 * t.numel())
            self.nodes.append(Node("fuse", "_to_copy", float(t.numel()),
                                   [r], [w]))
            wide.append((w[0], w[1], w[1], None))
        if dtype == torch.float32:
            self.nodes.append(Node("dot", "mm", flops, wide, [out]))
            return
        f32 = self._synthetic(2 * out[1])
        self.nodes.append(Node("dot", "mm", flops, wide, [f32]))
        self.nodes.append(Node("fuse", "_to_copy", float(out[1] // 2),
                               [(f32[0], f32[1], f32[1], None)], [out]))


def _native_low_dot(a, b, dtype) -> bool:
    """Whether XLA:CPU's dot library takes a 16-bit product as it is: an
    fp32 result, the left operand contracted along its minor dim, and no
    batch of matrix-vector products."""
    if dtype != torch.float32:
        return False
    if a.dim() > 2 and (a.shape[-2] == 1 or b.shape[-1] == 1):
        return False
    return a.stride(-1) == 1 or a.shape[-1] == 1


def _decomposition(func, name):
    """The decomposition an op is recorded through, or None."""
    if name == "var":
        return _var
    if name not in _DECOMPOSE:
        return None
    from torch._decomp import decomposition_table

    return decomposition_table.get(func)


def _topk_like(args, kwargs, x) -> bool:
    """A sort XLA's TopkRewriter may take: descending, f32, along the last
    dim of a tensor of rank at most 2."""
    dim = kwargs.get("dim", -1)
    desc = kwargs.get("descending", False)
    return (bool(desc) and x.dtype == torch.float32 and x.dim() <= 2
            and dim % max(x.dim(), 1) == x.dim() - 1)


def _classify(func, name, args, kwargs, reads, res):
    """(class, flops, expensive) of a local op."""
    from torch.utils.flop_counter import flop_registry

    n_out = sum(t.numel() for t in res)
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
        args = [a for a in args if not isinstance(a, torch.dtype)]
        kwargs = {k: v for k, v in kwargs.items() if k != "out_dtype"}
        return "dot", float(formula(*args, **kwargs, out_val=(
            res[0] if len(res) == 1 else tuple(res)))), True
    if name in _REDUCES:
        x, n = reads[0], res[0].numel()
        k = VARIADIC_REDUCE_FLOPS if (name in _VARIADIC or len(res) > 1) \
            else 1
        return "reduce", float(k * (x.numel() - n)
                               + (n if name == "mean" else 0)), True
    if name in _GATHERS:
        return "gather", 0.0, True
    if name in _SCATTERS:
        adds = name in ("index_add", "index_add_", "scatter_add",
                        "scatter_add_") or (
            name.startswith(("index_put", "_index_put")) and bool(
                kwargs.get("accumulate", len(args) > 3 and args[3])))
        return "scatter", float(reads[-1].numel() if adds else 0), True
    if name in _SORTS:
        n = reads[0].numel()
        return "sort", float(n * math.ceil(math.log2(n)) if n > 1 else 0), \
            True
    if name == "topk":
        return "topk", 0.0, True
    if torch.Tag.pointwise not in func.tags and name not in _FUSIBLE:
        return "other", 0.0, True
    if name in _MOVES:
        return "fuse", 0.0, False
    if name in ("_to_copy", "to"):
        same = bool(reads) and reads[0].dtype == res[0].dtype
        return "fuse", 0.0 if same else float(n_out), False
    per = _pointwise_flops(name, args, kwargs)
    floating = bool(res) and res[0].is_floating_point()
    expensive = (name in _TRANSCENDENTAL or (floating and name in _DIVIDES)
                 or (name.startswith("pow") and per == 0))
    return "fuse", per * n_out, expensive
