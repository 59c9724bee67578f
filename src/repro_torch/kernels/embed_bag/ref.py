"""Plain PyTorch version of the EmbeddingBag kernel.

The function of the TPU kernel ``embed_bag_kernel``
(``src/repro/kernels/embed_bag/kernel.py:25``): ``out[b] = Σ_l w[b,l] ·
table[idx[b,l]]`` over the slots with ``0 <= idx < V`` (``-1`` pads a
bag), ``mean`` dividing by ``max(valid slots, 1)``. As the CUDA kernel, the
sum is carried in fp32 and rounded to the table's dtype once; the weights
are first cast to the table's dtype, as the reference casts them.
"""

from __future__ import annotations

import torch

__all__ = ["embed_bag_ref"]


def embed_bag_ref(
    table: torch.Tensor,                  # (V, E) fp32 / bf16
    indices: torch.Tensor,                # (B, L) int, -1 padding
    weights: torch.Tensor | None = None,  # (B, L) per-sample weights
    *,
    combiner: str = "sum",
):
    """``(B, E)`` per-bag reductions, in the table's dtype."""
    v = table.shape[0]
    valid = (indices >= 0) & (indices < v)
    safe = torch.where(valid, indices, 0).long()
    rows = table[safe].float()                              # (B, L, E)
    w = valid.float()
    if weights is not None:
        w = w * weights.to(table.dtype).float()
    out = torch.einsum("ble,bl->be", rows, w)
    if combiner == "mean":
        out = out / valid.sum(dim=-1, keepdim=True).clamp(min=1).float()
    return out.to(table.dtype)
