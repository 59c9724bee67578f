"""Embedding tables and EmbeddingBag, the recsys substrate (port of
:mod:`repro.models.embedding`).

Each table is one ``(V, E)`` tensor named ``table_<i>`` as in the
reference's parameter dict. A one-hot lookup is a plain gather (the
reference's ``jnp.take``, outside any kernel); a multi-hot bag goes through
:func:`embed_bag`, the counterpart of ``embed_bag_jax``
(``src/repro/models/embedding.py:89``), which launches the hand-written
CUDA kernel ``kernels/csrc/embed_bag.cu`` on a CUDA tensor and runs its
plain version on a CPU tensor.

Under grad mode :func:`embed_bag` is differentiable: its forward is the
kernel (or its plain version), its backward plain PyTorch (the JAX package
has no backward kernel for it; XLA differentiates ``embed_bag_jax``'s
``take`` + ``einsum`` into a scatter-add). The table's gradient is dense,
``(V, E)``, as XLA's is. :func:`table_shardings` gives each table's
partition spec: tables of ``row_shard_threshold`` rows and up are
row-sharded, the rest replicated.

On a plain tensor :func:`gather_rows` (and so :func:`lookup`) is
``table[ids]``. On a DTensor table whose rows are sharded over mesh dims
``S`` (the dry-run's recsys cells: every mesh dim), with ids whose batch is
sharded over mesh dims ``Bd``, it runs the lowering the reference's
compile shows for a row-sharded ``jnp.take`` (its HLO, per table), on each
rank's local shards (:class:`_ShardedRows`), with ``G = S & Bd``:

* **ids plan** (the rule): all-gather the ids over ``G`` (one
  ``s32[B_G, ...]`` all-gather per dim, per table); gather the ids that
  fall in the rank's own row block from its shard, zeros elsewhere;
  all-reduce the ``(B_G, ..., E)`` rows over ``S`` in one group (all the
  tables' rows in one tuple in the reference: the same bytes); keep the
  rank's own batch rows. Backward: all-gather the rows' gradient over
  ``G`` and scatter-add it into the rank's own rows: no table gather and
  no reduction of the table's gradient;
* **table plan**: where the ids plan's all-reduced rows would exceed
  :data:`ROWS_ALLREDUCE_LIMIT` bytes (the reference's BST ``serve_bulk``
  and MIND's history at ``train_batch`` and ``serve_bulk``, 704 MB to
  3.4 GB, take it; every lookup of 176 MB or less keeps the ids plan), the
  table is all-gathered over ``G`` instead, the rank's own ids gather from
  its rows of ``S - G``, and the rows are all-reduced over ``S - G``.
  Backward: scatter-add into the gathered rows, all-reduce them over ``G``
  and keep the rank's own block.

A table's gradient is partial over the batch dims that do not shard it
(``Bd - S``): the step's gradient placement reduces it.
:func:`embed_bag` on a DTensor table takes the ids plan and all-reduces
the ``(B_G, E)`` bag sums.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels.embed_bag import embed_bag as _embed_bag_kernel
from ..runtime import spmd

__all__ = [
    "EmbedTablesConfig",
    "TableSpec",
    "table_specs",
    "table_shardings",
    "init_tables",
    "lookup",
    "gather_rows",
    "ROWS_ALLREDUCE_LIMIT",
    "embed_bag",
    "embed_bag_backward",
]


@dataclasses.dataclass(frozen=True)
class EmbedTablesConfig:
    vocab_sizes: tuple[int, ...]
    embed_dim: int
    dtype = torch.float32
    row_shard_threshold: int = 262_144   # rows; above this -> row-sharded


class TableSpec(NamedTuple):
    shape: tuple[int, int]
    dtype: torch.dtype


def table_specs(cfg: EmbedTablesConfig) -> dict[str, TableSpec]:
    """Shape and dtype of each table, allocating nothing."""
    return {
        f"table_{i}": TableSpec((v, cfg.embed_dim), cfg.dtype)
        for i, v in enumerate(cfg.vocab_sizes)
    }


def table_shardings(cfg: EmbedTablesConfig, *, model_axes=("model",)):
    """Partition spec per table: row-sharded over ``model_axes`` if big,
    replicated if small."""
    from ..runtime.sharding import P

    return {
        f"table_{i}": (P(tuple(model_axes), None)
                       if v >= cfg.row_shard_threshold else P(None, None))
        for i, v in enumerate(cfg.vocab_sizes)
    }


def init_tables(cfg: EmbedTablesConfig, generator: torch.Generator, *,
                device=None) -> dict[str, torch.Tensor]:
    """``N(0, 1) / sqrt(E)`` tables drawn from ``generator`` on its own
    device (draw with a CUDA generator to fill large tables on the card),
    then moved to ``device`` (default: the generator's)."""
    dev = generator.device if device is None else torch.device(device)
    return {
        name: (torch.randn(spec.shape, generator=generator,
                           device=generator.device)
               * cfg.embed_dim ** -0.5).to(dev, spec.dtype)
        for name, spec in table_specs(cfg).items()
    }


def lookup(tables: dict, ids: torch.Tensor) -> torch.Tensor:
    """Per-field single-id lookup. ids (B, F) -> (B, F, E)."""
    return torch.stack(
        [gather_rows(tables[f"table_{i}"], ids[:, i])
         for i in range(ids.shape[1])],
        dim=1,
    )


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: ids of any shape -> ``(*ids.shape, E)``. A DTensor
    table runs the reference's row-sharded lowering (see the module
    docstring)."""
    if spmd.is_dtensor(table):
        plan = _RowPlan.of(table, ids)
        if plan is not None:
            return _ShardedRows.apply(table, plan.ids, plan)
    return table[ids.long()]


# Bytes of full-batch rows above which a row-sharded lookup gathers the
# table over the batch's mesh dims instead of the ids (between the largest
# ids plan, 176 MB, and the smallest table plan, 704 MB, of the reference's
# compiled recsys cells).
ROWS_ALLREDUCE_LIMIT = 256 << 20


class _RowPlan:
    """The mesh dims and blocks of one row-sharded lookup (the module
    docstring's ``S``, ``Bd``, ``G``), and which plan it takes."""

    @classmethod
    def of(cls, table, ids, *, bag: bool = False):
        """The plan, with ``ids`` as a DTensor whose only split is its
        rows; None when the table is not row-sharded (DTensor's then)."""
        from torch.distributed.tensor import Replicate, Shard

        def rows_or_whole(p):
            return type(p) is Replicate or (type(p) is Shard and p.dim == 0)

        mesh = table.device_mesh
        if not all(rows_or_whole(p) for p in table.placements):
            return None
        if not spmd.is_dtensor(ids):
            ids = spmd.from_local(ids, mesh, [Replicate()] * mesh.ndim)
        keep = [p if rows_or_whole(p) else Replicate()
                for p in ids.placements]
        if list(ids.placements) != keep:
            ids = ids.redistribute(mesh, keep)
        return cls(table, ids, bag)

    def __init__(self, table, ids, bag: bool = False):
        mesh = self.mesh = table.device_mesh
        self.ids = ids
        self.table_placements = table.placements
        self.ids_placements = ids.placements
        self.s = spmd.shard_dims(table.placements, 0)
        self.bd = spmd.shard_dims(ids.placements, 0)
        self.g = [d for d in self.s if d in self.bd]
        self.rows = table.shape[0] // max(1, int(torch.Size(
            [mesh.size(d) for d in self.s]).numel()))
        self.out_shape = ((ids.shape[0], table.shape[1]) if bag
                          else (*ids.shape, table.shape[1]))
        full = int(torch.Size(self.out_shape).numel()) * table.element_size()
        self.gather_table = (not bag and bool(self.g)
                             and full > ROWS_ALLREDUCE_LIMIT)

    def grad_placements(self):
        """The table's placements, partial over ``Bd - S``."""
        from torch.distributed.tensor import Partial

        return [Partial() if i in self.bd and i not in self.s else p
                for i, p in enumerate(self.table_placements)]

    def local_ids(self, ids):
        """(mask, index into the rank's rows) of global row ids ``ids`` for
        the rows the rank holds: its own block of ``S``, or under the
        table plan its blocks of ``S - G`` for every coordinate of ``G``
        (gathered in mesh order)."""
        mesh, rows = self.mesh, self.rows
        block, inside = ids // rows, ids % rows
        coord = mesh.get_coordinate()
        mask = torch.ones_like(ids, dtype=torch.bool)
        pos = torch.zeros_like(ids)
        stride, g_stride = 1, 1
        for d in reversed(self.s):            # minor mesh dim first
            c = (block // stride) % mesh.size(d)
            stride *= mesh.size(d)
            if self.gather_table and d in self.g:
                pos = pos + c * g_stride      # its gathered block
                g_stride *= mesh.size(d)
            else:
                mask = mask & (c == coord[d])
        return mask, torch.where(mask, pos * rows + inside, 0)


class _ShardedRows(torch.autograd.Function):
    """``table[ids]`` on a row-sharded DTensor table: the plan's
    collectives on each rank's local shards (module docstring)."""

    @staticmethod
    def forward(ctx, table, ids, plan):
        mesh = plan.mesh
        tab, idl = table.to_local(), ids.to_local()
        if plan.gather_table:
            tab = spmd.all_gather(tab, mesh, plan.g)
            mask, local = plan.local_ids(idl.long())
            out = torch.where(mask[..., None], tab[local], 0)
            out = spmd.all_reduce(out, mesh, [d for d in plan.s
                                              if d not in plan.g])
        else:
            idg = spmd.all_gather(idl, mesh, plan.g).long()
            mask, local = plan.local_ids(idg)
            out = torch.where(mask[..., None], tab[local], 0)
            out = spmd.all_reduce(out, mesh, plan.s)
            n = idl.shape[0]
            me = spmd.block_of(mesh, plan.g)
            out = out[me * n:(me + 1) * n]
        ctx.plan = plan
        ctx.tab_shape, ctx.tab_dtype = tab.shape, tab.dtype
        ctx.save_for_backward(mask, local)
        return spmd.from_local(out, mesh, plan.ids_placements,
                               plan.out_shape)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        mesh = plan.mesh
        mask, local = ctx.saved_tensors
        if list(grad.placements) != list(plan.ids_placements):
            grad = grad.redistribute(mesh, plan.ids_placements)
        g = grad.to_local()
        if not plan.gather_table:
            g = spmd.all_gather(g, mesh, plan.g)
        e = g.shape[-1]
        g = torch.where(mask[..., None], g, 0).reshape(-1, e)
        d_tab = torch.zeros(ctx.tab_shape, dtype=ctx.tab_dtype,
                            device=g.device).index_add_(
            0, local.reshape(-1), g.to(ctx.tab_dtype))
        if plan.gather_table:
            d_tab = spmd.all_reduce(d_tab, mesh, plan.g)
            me = spmd.block_of(mesh, plan.g)
            d_tab = d_tab[me * plan.rows:(me + 1) * plan.rows]
        return (spmd.from_local(d_tab, mesh, plan.grad_placements()),
                None, None)


def embed_bag(
    table: torch.Tensor,                  # (V, E)
    indices: torch.Tensor,                # (B, L) int32 / int64, -1 padding
    weights: torch.Tensor | None = None,  # (B, L) per-sample weights
    *,
    combiner: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag -> ``(B, E)`` in the table's dtype (the counterpart of
    ``embed_bag_jax``). The sum is carried in fp32 and rounded once; on a
    bf16 table ``mean`` also divides in fp32, where the reference rounds to
    bf16 before its division (one bf16 rounding apart). Differentiable in
    ``table`` and ``weights`` (:class:`_EmbedBag`); on a row-sharded
    DTensor table in ``table`` only (:class:`_ShardedBag`)."""
    if spmd.is_dtensor(table):
        plan = _RowPlan.of(table, indices, bag=True)
        if plan is not None:
            if weights is not None:
                weights = _RowPlan.of(table, weights, bag=True).ids
            return _ShardedBag.apply(table, plan.ids, weights, combiner, plan)
    return _EmbedBag.apply(table, indices, weights, combiner)


def embed_bag_backward(table, indices, weights, grad_out, *,
                       combiner="sum", table_grad=True, weights_grad=False):
    """The gradients of :func:`embed_bag` -> ``(d_table, d_weights)``
    (``None`` where not asked for), in plain PyTorch with no host sync.
    Over the slots with ``0 <= idx < V``, with ``g_b = grad_out[b]``
    divided by the bag's count of valid slots for ``mean``:

    * table: a zero fp32 ``(V, E)`` tensor, ``index_add_`` of ``w[b,l] *
      g_b`` at row ``idx[b,l]``, cast to the table's dtype (dense, as XLA's
      gradient of ``embed_bag_jax`` is);
    * weights: ``<table[idx[b,l]], g_b>`` in fp32, rounded to the table's
      dtype (the forward casts the weights to it), 0 at padding.
    """
    valid = (indices >= 0) & (indices < table.shape[0])
    safe = torch.where(valid, indices, 0).long()                # (B, L)
    g = grad_out.float()                                        # (B, E)
    if combiner == "mean":
        g = g / valid.sum(dim=-1, keepdim=True).clamp(min=1).float()
    d_table = d_weights = None
    if table_grad:
        w = valid.float()                # padding adds zeros to row 0
        if weights is not None:
            w = w * weights.to(table.dtype).float()
        contrib = g[:, None, :] * w[:, :, None]                 # (B, L, E)
        d_table = torch.zeros(table.shape, dtype=torch.float32,
                              device=table.device)
        d_table.index_add_(0, safe.reshape(-1),
                           contrib.reshape(-1, table.shape[1]))
        d_table = d_table.to(table.dtype)
    if weights_grad:
        dots = torch.einsum("ble,be->bl", table[safe].float(), g)
        d_weights = torch.where(valid, dots, 0.0).to(table.dtype).to(
            weights.dtype)
    return d_table, d_weights


class _EmbedBag(torch.autograd.Function):
    """Forward: the ``embed_bag`` wrapper (one kernel launch on a CUDA
    tensor, counted there). Backward: :func:`embed_bag_backward`."""

    @staticmethod
    def forward(ctx, table, indices, weights, combiner):
        ctx.combiner = combiner
        ctx.save_for_backward(table, indices, weights)
        return _embed_bag_kernel(table, indices, weights, combiner=combiner)

    @staticmethod
    def backward(ctx, grad_out):
        table, indices, weights = ctx.saved_tensors
        want_table, _, want_weights, _ = ctx.needs_input_grad
        d_table, d_weights = embed_bag_backward(
            table, indices, weights, grad_out, combiner=ctx.combiner,
            table_grad=want_table, weights_grad=want_weights)
        return d_table, None, d_weights, None


class _ShardedBag(torch.autograd.Function):
    """:func:`embed_bag` on a row-sharded DTensor table: the ids plan, with
    the bag sums (fp32) all-reduced in place of the rows; ``mean`` divides
    by each bag's count of valid ids over the whole table."""

    @staticmethod
    def forward(ctx, table, ids, weights, combiner, plan):
        mesh = plan.mesh
        tab, idl = table.to_local(), ids.to_local()
        idg = spmd.all_gather(idl, mesh, plan.g).long()
        valid = (idg >= 0) & (idg < table.shape[0])
        mask, local = plan.local_ids(torch.where(valid, idg, 0))
        w = (valid & mask).float()
        if weights is not None:
            w = w * spmd.all_gather(weights.to_local(), mesh, plan.g).to(
                tab.dtype).float()
        out = torch.einsum("ble,bl->be", tab[local].float(), w)
        out = spmd.all_reduce(out, mesh, plan.s)
        scale = None
        if combiner == "mean":
            scale = 1.0 / valid.sum(dim=-1, keepdim=True).clamp(min=1).float()
            out = out * scale
        n = idl.shape[0]
        me = spmd.block_of(mesh, plan.g)
        ctx.plan, ctx.tab_shape, ctx.tab_dtype = plan, tab.shape, tab.dtype
        ctx.save_for_backward(local, w, scale)
        return spmd.from_local(out[me * n:(me + 1) * n].to(tab.dtype), mesh,
                               plan.ids_placements, plan.out_shape)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        mesh = plan.mesh
        local, w, scale = ctx.saved_tensors
        if list(grad.placements) != list(plan.ids_placements):
            grad = grad.redistribute(mesh, plan.ids_placements)
        g = spmd.all_gather(grad.to_local().float(), mesh, plan.g)
        if scale is not None:
            g = g * scale
        contrib = g[:, None, :] * w[:, :, None]                 # (B, L, E)
        d_tab = torch.zeros(ctx.tab_shape, dtype=torch.float32,
                            device=g.device).index_add_(
            0, local.reshape(-1), contrib.reshape(-1, g.shape[-1]))
        return (spmd.from_local(d_tab.to(ctx.tab_dtype), mesh,
                                plan.grad_placements()),
                None, None, None, None)
