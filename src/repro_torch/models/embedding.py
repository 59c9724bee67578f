"""Embedding tables and EmbeddingBag, the recsys substrate (port of
:mod:`repro.models.embedding`).

Each table is one ``(V, E)`` tensor named ``table_<i>`` as in the
reference's parameter dict. A one-hot lookup is a plain gather (the
reference's ``jnp.take``, outside any kernel); a multi-hot bag goes through
:func:`embed_bag`, the counterpart of ``embed_bag_jax``
(``src/repro/models/embedding.py:89``), which launches the hand-written
CUDA kernel ``kernels/csrc/embed_bag.cu`` on a CUDA tensor and runs its
plain version on a CPU tensor.

The kernel has no backward yet: a call whose table requires grad while
grad mode is on raises, rather than return an output with no ``grad_fn``
that would leave the tables untouched in a training step. Row sharding of
the big tables (``table_shardings``) waits for the dry-run slice.
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
    bf16 before its division (one bf16 rounding apart)."""
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError(
            "embed_bag has no backward yet: call it under torch.no_grad() "
            "or torch.inference_mode(), or on a table that does not "
            "require grad"
        )
    return _embed_bag_kernel(table, indices, weights, combiner=combiner)
