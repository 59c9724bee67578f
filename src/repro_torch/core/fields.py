"""Multi-field vector spaces for semi-structured records (PyTorch port of
:mod:`repro.core.fields`).

A record has ``s`` fields (title / authors / abstract), each in its own
vector space of dimension ``dims[i]``. Every field vector is unit-normalised
and the corpus is stored concatenated as one dense ``(n, D)`` tensor with
``D = sum(dims)``, so the weighted aggregate score is one dot product
against the weighted query (:mod:`repro_torch.core.weights`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = ["FieldSpec", "normalize_fields", "concat_fields", "split_fields"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of the per-field vector spaces of a corpus."""

    names: tuple[str, ...]
    dims: tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.dims):
            raise ValueError(
                f"names/dims mismatch: {len(self.names)} vs {len(self.dims)}"
            )
        if any(d <= 0 for d in self.dims):
            raise ValueError(f"field dims must be positive, got {self.dims}")

    @property
    def s(self) -> int:
        """Number of fields (sources of evidence)."""
        return len(self.dims)

    @property
    def total_dim(self) -> int:
        return int(sum(self.dims))

    @property
    def offsets(self) -> tuple[int, ...]:
        """Start offset of each field inside the concatenated layout."""
        return tuple(int(o) for o in np.cumsum((0,) + tuple(self.dims[:-1])))

    def slices(self) -> tuple[slice, ...]:
        return tuple(
            slice(o, o + d) for o, d in zip(self.offsets, self.dims)
        )

    def field_mask(self) -> np.ndarray:
        """(D,) int array mapping each concat coordinate to its field id."""
        return np.repeat(np.arange(self.s), np.asarray(self.dims))


def normalize_fields(x: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """L2-normalise each field block of a concatenated ``(..., D)`` tensor;
    zero blocks stay zero."""
    parts = []
    for sl in spec.slices():
        f = x[..., sl]
        norm = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
        parts.append(f / torch.clamp(norm, min=_EPS))
    return torch.cat(parts, dim=-1)


def concat_fields(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-field tensors ``[(..., d_i)]`` into ``(..., D)``."""
    return torch.cat([torch.as_tensor(f) for f in fields], dim=-1)


def split_fields(x: torch.Tensor, spec: FieldSpec) -> list[torch.Tensor]:
    """Split a concatenated tensor back into per-field blocks."""
    return [x[..., sl] for sl in spec.slices()]
