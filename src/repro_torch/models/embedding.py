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
``(V, E)``, as XLA's is. Row sharding of the big tables
(``table_shardings``) waits for the dry-run slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels.embed_bag import embed_bag as _embed_bag_kernel

__all__ = [
    "EmbedTablesConfig",
    "TableSpec",
    "table_specs",
    "init_tables",
    "lookup",
    "embed_bag",
    "embed_bag_backward",
]


@dataclasses.dataclass(frozen=True)
class EmbedTablesConfig:
    vocab_sizes: tuple[int, ...]
    embed_dim: int
    dtype = torch.float32


class TableSpec(NamedTuple):
    shape: tuple[int, int]
    dtype: torch.dtype


def table_specs(cfg: EmbedTablesConfig) -> dict[str, TableSpec]:
    """Shape and dtype of each table, allocating nothing."""
    return {
        f"table_{i}": TableSpec((v, cfg.embed_dim), cfg.dtype)
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
        [tables[f"table_{i}"][ids[:, i].long()] for i in range(ids.shape[1])],
        dim=1,
    )


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
    ``table`` and ``weights`` (:class:`_EmbedBag`)."""
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
