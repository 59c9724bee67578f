"""Query-side dynamic weight embedding (PyTorch port of
:mod:`repro.core.weights`, the paper's §4 reduction).

For unit per-field queries ``q_i`` and non-negative weights ``w_i``,
``WS(w, q, p) = sum_i w_i (q_i · p_i) = Q_w · p`` with
``Q_w = [w_1 q_1, ..., w_s q_s]``. Normalising ``Q'_w = Q_w / |Q_w|`` turns
the weighted multi-field search into a plain cosine search of the
unweighted concatenated corpus, so an index built without weights serves
any weights.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..runtime.trace import span
from .fields import FieldSpec, concat_fields, split_fields

__all__ = [
    "weighted_query",
    "aggregate_similarity",
    "cosine_distance",
    "expand_weights",
    "nwd",
    "validate_weights",
]

_EPS = 1e-12


def validate_weights(w, spec: FieldSpec | None = None) -> np.ndarray:
    """Check per-field weights at the API boundary; return them as float32.

    Accepts ``(s,)`` or ``(nq, s)``. Negative, non-finite or all-zero rows
    raise ``ValueError`` naming the offending values; nothing is repaired.
    """
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    arr = np.asarray(w, np.float32)
    if spec is not None and (arr.ndim == 0 or arr.shape[-1] != spec.s):
        raise ValueError(
            f"weights must have one entry per field "
            f"({spec.s}: {list(spec.names)}), got shape {arr.shape}"
        )
    if not np.all(np.isfinite(arr)):
        raise ValueError(f"field weights must be finite, got {arr.tolist()}")
    if np.any(arr < 0):
        raise ValueError(
            f"field weights must be non-negative, got {arr.tolist()}"
        )
    if np.any(np.sum(arr, axis=-1) <= 0):
        raise ValueError(
            "field weights must include at least one positive entry "
            f"(all-zero weights have no defined ranking), got {arr.tolist()}"
        )
    return arr


def expand_weights(w: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Expand per-field weights ``(..., s)`` to concat coords ``(..., D)``."""
    w = torch.as_tensor(w)
    reps = torch.as_tensor(spec.dims, device=w.device)
    return torch.repeat_interleave(w, reps, dim=-1,
                                   output_size=spec.total_dim)


def weighted_query(
    q: torch.Tensor | Sequence[torch.Tensor],
    w: torch.Tensor,
    spec: FieldSpec,
    *,
    normalize: bool = True,
) -> torch.Tensor:
    """Build the (normalised) weighted query ``Q'_w``.

    ``q`` is a concatenated ``(..., D)`` query or a list/tuple of per-field
    blocks; ``w`` is ``(..., s)``. Only a genuine list or tuple counts as
    per-field blocks: a bare ``(nq, D)`` array is a batch of concatenated
    queries, never a list of fields.
    """
    with span("entry.weighted_query"):
        if isinstance(q, (list, tuple)):
            q = concat_fields(list(q))
        else:
            q = torch.as_tensor(q)
        w = torch.as_tensor(w, dtype=q.dtype, device=q.device)
        qw = q * expand_weights(w, spec)
        if not normalize:
            return qw
        norm = torch.linalg.vector_norm(qw, dim=-1, keepdim=True)
        return qw / torch.clamp(norm, min=_EPS)


def aggregate_similarity(
    q: torch.Tensor, w: torch.Tensor, p: torch.Tensor, spec: FieldSpec
) -> torch.Tensor:
    """Direct ``WS(w, q, p) = sum_i w_i (q_i · p_i)`` — the definitional
    form, the oracle for the reduced one."""
    q_f = split_fields(q, spec)
    p_f = split_fields(p, spec)
    sims = [w[..., i] * torch.sum(q_f[i] * p_f[i], dim=-1)
            for i in range(spec.s)]
    return sum(sims)


def cosine_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``d(x, y) = 1 - x·y`` for unit vectors (``sqrt(d)`` is a metric)."""
    return 1.0 - torch.sum(x * y, dim=-1)


def nwd(q: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
        spec: FieldSpec) -> torch.Tensor:
    """Normalised weighted distance ``NWD(w, q, p) = 1 - Q'_w · p``."""
    qn = weighted_query(q, w, spec)
    return 1.0 - torch.einsum("...d,...d->...", qn.expand(p.shape), p)
