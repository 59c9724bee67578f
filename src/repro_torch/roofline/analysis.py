"""Roofline terms of a dry-run step (port of :mod:`repro.roofline.analysis`).

Three terms per (arch x shape x mesh), all per chip:

    t_compute    = flops / peak_FLOP/s
    t_memory     = bytes / HBM_bw
    t_collective = collective_bytes / link_bw

The reference reads flops and bytes from XLA's ``cost_analysis()`` and
parses collectives out of the optimized HLO. The port has no compiler to
ask: :class:`StepCounter`, a ``TorchDispatchMode``, watches the step run
once on DTensors over fake tensors (:mod:`repro_torch.launch.dryrun`). It
lets every DTensor op through to DTensor's own dispatch and counts what
that issues on each rank's local shards:

* **flops**: torch's flop formulas (``torch.utils.flop_counter``: matmuls,
  convolutions, attention) on the LOCAL shapes, so a sharded product counts
  the rank's share (``FlopCounterMode`` around a DTensor op counts the
  global op);
* **bytes**: every local op's input and output bytes, views and factories
  without a fill excluded. This is an unfused upper bound, unlike XLA's
  post-fusion ``bytes accessed``;
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
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


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
         "sym_stride", "sym_numel", "_local_scalar_dense", "is_same_size"}


class StepCounter(TorchDispatchMode):
    """Counts one rank's flops, bytes, collectives and peak live bytes of
    the local ops run under it (see the module docstring)."""

    def __init__(self, hw: Hardware = HW_H100, fake_mode=None):
        super().__init__()
        self.hw = hw
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.collective = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.cross_node = 0.0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.replicated: set[str] = set()
        self._held: dict[int, int] = {}
        self._in_dtensor = False

    # ------------------------------------------------------------- report
    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())

    def report(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "cross_node_bytes": self.cross_node,
                "collective_detail": dict(self.collective),
                "collective_counts": dict(self.counts),
                "peak_step_bytes": self.peak, "local_ops": self.ops,
                "replicated_ops": sorted(self.replicated)}

    # ------------------------------------------------------------ helpers
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

    def _hold(self, out) -> None:
        """Count each new storage an op returns as live until the tensor
        that first held it is freed (an in-place result is not new)."""
        for t in _tensors(out):
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

    def _snapshot(self):
        return (self.flops, self.bytes, dict(self.collective),
                dict(self.counts), self.cross_node, self.ops)

    def _restore(self, snap) -> None:
        (self.flops, self.bytes, self.collective, self.counts,
         self.cross_node, self.ops) = snap[0], snap[1], dict(snap[2]), \
            dict(snap[3]), snap[4], snap[5]

    def _unfaked(self):
        """DTensor's own dispatch runs outside the dry-run's fake mode: its
        bookkeeping tensors are small and real (it reads their values),
        while the local shards stay fake and their ops fake."""
        import contextlib

        from torch._subclasses.fake_tensor import unset_fake_temporarily

        return (unset_fake_temporarily() if self.fake_mode is not None
                else contextlib.nullcontext())

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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            if self._in_dtensor:
                return NotImplemented     # DTensor's own dispatch runs it
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self.fake_mode is not None and not any(
                getattr(t, "fake_mode", None) is self.fake_mode
                for t in _tensors((args, kwargs, out))):
            # DTensor's bookkeeping (real tensors, or its own fake tensors
            # of global shapes that it runs an op on to learn the output's
            # metadata): not the rank's work
            return out
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor",
                  "c10d") and name in _C10D:
            self._collective(_C10D[name], self._group(args, kwargs), out)
            return out
        if name in _FREE or func.is_view:
            return out
        self.ops += 1
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._hold(out)
        return out
