"""Named-sharding rules per model family (port of
:mod:`repro.runtime.sharding`).

The production mesh is ``(data=16, model=16)`` per pod, ``(pod=2, data=16,
model=16)`` across pods (:mod:`repro_torch.launch.mesh`). Strategy for LMs,
as the reference's:

* **FSDP** over ``(pod, data)``: the d_model dimension of every weight is
  sharded over the data axes and gathered just in time (ZeRO-3);
* **TP** over ``model``: attention heads / FFN hidden / experts / vocab;
* **batch** over ``(pod, data)``;
* **KV cache** (decode): batch over ``data``, sequence over ``model`` (and
  ``pod`` at 500k).

A spec is a :class:`P`: one entry per tensor dim, each None, one axis name,
or a tuple of axis names (major to minor), the reference's
``PartitionSpec``. :func:`spec_for` drops any axis that does not divide a
dim evenly, as the reference's does. The specs are the source of truth;
:func:`to_placements` turns one into DTensor placements.

DTensor shards a tensor dim over several mesh dims in the order of the
mesh's dims. The reference orders a tuple entry major to minor as
written, so for an entry whose axes are not in mesh order (the recsys
tables' ``("model", "pod", "data")``) :func:`to_placements` gives the
axes nested inside later mesh axes as ``_StridedShard``: the DTensor then
describes the reference's rows of each rank, which :func:`local_rows`
gives (``restore_pytree(shardings=)`` slices by it).

A mesh here is anything with the reference's ``mesh.shape`` mapping (axis
name -> size, in mesh order): the port's ``AbstractMesh`` or a
``torch.distributed.device_mesh.DeviceMesh`` (read by :func:`mesh_axes`).
"""

from __future__ import annotations

from typing import Mapping, Sequence

__all__ = [
    "P", "NamedSharding", "mesh_axes", "axis_size", "data_axes", "spec_for",
    "named",
    "to_placements", "local_shape", "local_rows", "lm_param_rules",
    "lm_use_rules", "lm_param_rules_zero3", "lm_use_rules_zero3",
    "lm_train_shardings", "lm_decode_shardings",
]


class P(tuple):
    """A partition spec: the reference's ``PartitionSpec`` as a tuple.

    ``P()`` is replicated; ``P("data", None)`` shards dim 0 over ``data``;
    ``P(("pod", "data"), None)`` over ``pod`` then ``data``, major to
    minor. Dims past the entries are replicated."""

    def __new__(cls, *parts):
        # a one-axis tuple is that axis, as JAX's PartitionSpec holds it
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, (tuple, list)) and len(p) == 1
            else tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The axes dim ``dim`` is sharded over (major first)."""
        if dim >= len(self) or self[dim] is None:
            return ()
        e = self[dim]
        return (e,) if isinstance(e, str) else tuple(e)


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_axes(mesh)
    out = 1
    for n in names:
        out *= sizes[n]
    return out


def data_axes(mesh) -> tuple[str, ...]:
    """Batch/FSDP axes: ('pod', 'data') when a pod axis exists."""
    sizes = mesh_axes(mesh)
    return tuple(n for n in ("pod", "data") if n in sizes)


def spec_for(mesh, shape: Sequence[int], axes_per_dim) -> P:
    """Build a :class:`P`, dropping axes that don't divide the dim.

    ``axes_per_dim``: one entry per dim — None, an axis name, or a tuple of
    axis names (applied greedily left-to-right while divisibility holds).
    """
    sizes = mesh_axes(mesh)
    spec = []
    for dim, want in zip(shape, axes_per_dim):
        if want is None:
            spec.append(None)
            continue
        axes = (want,) if isinstance(want, str) else tuple(want)
        used = []
        rem = dim
        for a in axes:
            s = sizes[a]
            if rem % s == 0:
                used.append(a)
                rem //= s
        if not used:
            spec.append(None)
        elif len(used) == 1:
            spec.append(used[0])
        else:
            spec.append(tuple(used))
    return P(*spec)


class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); a leaf, not a
    tree node, for ``restore_pytree(shardings=)``."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_axes(self.mesh)}, {self.spec})"


def named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def to_placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec``: per mesh dim, a shard of the tensor
    dim ``d`` that names the axis, else ``Replicate()``. DTensor splits a
    dim over its mesh dims in mesh order; where the spec orders a dim's
    axes otherwise (major to minor as written), an axis that the spec
    nests inside axes that come later in the mesh is a
    ``_StridedShard`` whose split factor is those axes' size, so the
    DTensor holds the reference's rows (:func:`local_rows`)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    order = list(mesh_axes(mesh))
    out = []
    for a in order:
        d = next((d for d in range(len(spec)) if a in spec.axes(d)), None)
        if d is None:
            out.append(Replicate())
            continue
        axes = spec.axes(d)
        outer = [b for b in axes[:axes.index(a)]
                 if order.index(b) > order.index(a)]
        sf = axis_size(mesh, outer) if outer else 1
        out.append(_StridedShard(d, split_factor=sf) if sf > 1 else Shard(d))
    return tuple(out)


def local_shape(mesh, shape: Sequence[int], spec: P) -> tuple[int, ...]:
    """The per-chip shape of a ``shape`` tensor under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        k = axis_size(mesh, spec.axes(d)) if spec.axes(d) else 1
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {spec.axes(d)} ({k})")
        out.append(n // k)
    return tuple(out)


def local_rows(mesh, coords: Mapping[str, int], n: int, axes) -> slice:
    """The rows of an ``n``-row dim sharded over ``axes`` (major to minor,
    the reference's order) that the chip at mesh coordinates ``coords``
    (axis name -> index) holds."""
    sizes = mesh_axes(mesh)
    block = 0
    for a in axes:
        block = block * sizes[a] + coords[a]
    rows = n // axis_size(mesh, tuple(axes)) if axes else n
    return slice(block * rows, (block + 1) * rows)


# ----------------------------------------------------------------- LM rules
def _sublayer_rules(cfg, mesh, *, with_moe: bool, stored: bool) -> dict:
    """Rules for one sublayer, by leaf name (``wq``, ``mlp.w1``,
    ``moe.shared.w1``, ...). ``stored=True`` -> FSDP storage layout (data
    axes on a big dim, stacked block dim prepended); ``stored=False`` ->
    TP-only USE layout (no stacked dim, no data axes)."""
    da = data_axes(mesh) if stored else ()
    d, h, kv, dh, f = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
    )

    def s(shape, axes):
        if stored:
            shape = (0, *shape)          # stacked block dim (size unused)
            axes = (None, *axes)
        return spec_for(mesh, [1 if x == 0 else x for x in shape], axes)

    da_or_none = da if stored else None
    out = {
        "ln1": s((d,), (None,)),
        "ln2": s((d,), (None,)),
        "wq": s((d, h, dh), (da_or_none, "model", None)),
        "wk": s((d, kv, dh), (da_or_none, "model", None)),
        "wv": s((d, kv, dh), (da_or_none, "model", None)),
        "wo": s((h, dh, d), ("model", None, da_or_none)),
    }
    if cfg.qk_norm:
        out["q_norm"] = s((dh,), (None,))
        out["k_norm"] = s((dh,), (None,))
    if with_moe:
        m = cfg.moe
        e, fe = m.n_experts, m.d_expert
        out["moe.router"] = s((d, e), (da_or_none, None))
        out["moe.w1"] = s((e, d, fe), ("model", da_or_none, None))
        out["moe.w2"] = s((e, fe, d), ("model", None, da_or_none))
        if cfg.mlp_type == "swiglu":
            out["moe.w3"] = s((e, d, fe), ("model", da_or_none, None))
        if m.n_shared > 0:
            fs = fe * m.n_shared
            out["moe.shared.w1"] = s((d, fs), (da_or_none, "model"))
            out["moe.shared.w2"] = s((fs, d), ("model", da_or_none))
            if cfg.mlp_type == "swiglu":
                out["moe.shared.w3"] = s((d, fs), (da_or_none, "model"))
    else:
        out["mlp.w1"] = s((d, f), (da_or_none, "model"))
        out["mlp.w2"] = s((f, d), ("model", da_or_none))
        if cfg.mlp_type == "swiglu":
            out["mlp.w3"] = s((d, f), (da_or_none, "model"))
    return out


def _block_rules(cfg, mesh, *, stored: bool) -> dict:
    """``layers.sub<i>.<leaf>`` -> spec for every sublayer of a block."""
    from ..models.transformer import _n_sub, _sub_uses_moe

    out = {}
    for i in range(_n_sub(cfg)):
        rules = _sublayer_rules(cfg, mesh, with_moe=_sub_uses_moe(cfg, i),
                                stored=stored)
        out.update({f"layers.sub{i}.{k}": v for k, v in rules.items()})
    return out


def lm_param_rules(cfg, mesh) -> dict:
    """STORAGE spec by parameter name (``transformer.param_specs(cfg)``'s
    names): FSDP dim -> data axes, TP dim -> model axis, stacked block dim
    unsharded."""
    d, v = cfg.d_model, cfg.vocab
    da = data_axes(mesh)
    return {
        # embed sharded on d_model over 'model' only (the token gather then
        # needs no vocab-dim resharding)
        "embed": spec_for(mesh, (v, d), (None, "model")),
        **_block_rules(cfg, mesh, stored=True),
        "ln_f": spec_for(mesh, (d,), (None,)),
        "unembed": spec_for(mesh, (d, v), (da, "model")),
    }


def lm_use_rules(cfg, mesh) -> dict:
    """USE specs (TP-only, per block — no stacked dim, no data axes), by
    name: ``layers.sub<i>.<leaf>`` and ``unembed``. Passed to
    forward/prefill as ``use_specs``: params are STORED FSDP-sharded
    (:func:`lm_param_rules`) and gathered to these specs per block."""
    return {
        **_block_rules(cfg, mesh, stored=False),
        "unembed": spec_for(mesh, (cfg.d_model, cfg.vocab), (None, "model")),
    }


def lm_param_rules_zero3(cfg, mesh) -> dict:
    """Full-shard storage: every big dim spread over ALL mesh axes; MoE
    experts keep the expert dim on 'model' (expert parallelism) and shard
    their largest other dim over the data axes; ``embed`` stays
    gather-friendly (d over model)."""
    from ..models.transformer import param_specs

    base = lm_param_rules(cfg, mesh)
    shapes = param_specs(cfg)
    flat = data_axes(mesh) + ("model",)

    def one(spec, dims):
        if len(dims) < 2:
            return P()
        parts = [None] * len(dims)
        if spec and len(spec) > 1 and spec[1] == "model" and len(dims) >= 4:
            parts[1] = "model"              # stacked experts: (blk, E, ..)
            big = max(range(2, len(dims)), key=lambda i: dims[i])
            return spec_for(mesh, dims, tuple(parts[:big]) + (data_axes(mesh),)
                            + tuple(parts[big + 1:]))
        big = max(range(1, len(dims)), key=lambda i: dims[i])
        axes = [None] * len(dims)
        axes[big] = flat
        return spec_for(mesh, dims, tuple(axes))

    out = {name: one(base[name], shapes[name]) for name in base}
    out["embed"] = spec_for(mesh, shapes["embed"], (None, "model"))
    return out


def lm_use_rules_zero3(cfg, mesh) -> dict:
    """USE specs under ZeRO-3: everything gathered to REPLICATED except the
    routed MoE experts (kept expert-parallel on 'model') and the unembed
    (vocab on 'model')."""
    out = {}
    for name, spec in _block_rules(cfg, mesh, stored=False).items():
        leaf = name.split(".", 2)[2]
        routed = leaf.startswith("moe.") and leaf.count(".") == 1 \
            and leaf != "moe.router"
        out[name] = spec if routed else P()
    out["unembed"] = spec_for(mesh, (cfg.d_model, cfg.vocab), (None, "model"))
    return out


def lm_train_shardings(cfg, mesh, *, global_batch: int, seq_len: int):
    """(param specs by name, batch spec) for the train step."""
    da = data_axes(mesh)
    params = lm_param_rules(cfg, mesh)
    batch = {
        "tokens": spec_for(mesh, (global_batch, seq_len), (da, None)),
        "labels": spec_for(mesh, (global_batch, seq_len), (da, None)),
    }
    return params, batch


def lm_decode_shardings(cfg, mesh, *, batch: int):
    """(param specs, cache specs, token spec) for decode. Cache sequence dim
    sharded over 'model' (+ 'pod', 'data' greedily for batch=1 long
    context); batch over data axes when it divides."""
    da = data_axes(mesh)
    params = lm_param_rules(cfg, mesh)
    L, S, KV, DH = cfg.n_layers, cfg.max_seq_len, cfg.n_kv_heads, cfg.d_head
    if batch >= axis_size(mesh, da):
        b_axes, s_axes = da, ("model",)
    else:
        b_axes, s_axes = None, da + ("model",)
    kv_spec = spec_for(mesh, (L, batch, S, KV, DH),
                       (None, b_axes, s_axes, None, None))
    cache = {"k": kv_spec, "v": kv_spec, "length": P()}
    token = spec_for(mesh, (batch,), (b_axes,))
    return params, cache, token
