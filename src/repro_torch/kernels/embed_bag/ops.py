"""Wrapper of the EmbeddingBag kernel (counterpart of
:mod:`repro.kernels.embed_bag.ops`).

A CPU tensor goes to the plain version (:mod:`.ref`); a CUDA tensor goes
to the hand-written CUDA kernel ``csrc/embed_bag.cu`` (built with ``nvcc``
for ``sm_90a`` on first use, bound with ``ctypes``) or the call raises.
Launches are counted in ``embed_bag.launches``.

A call is bound by launch latency and host work (its byte bound is under a
microsecond), so the card path does no work the kernel can do: the output
is ``torch.empty`` (the kernel writes every element), no weights is a null
pointer (weight 1), int32 and int64 indices go as they are, fp32 and bf16
weights as they are (the kernel rounds a fp32 weight of a bf16 table), and
the runtime's device is switched only when it is not the table's.
"""

from __future__ import annotations

import torch

from ..common import check_status, cuda_function, launch_on, on_cuda
from .ref import embed_bag_ref

__all__ = ["embed_bag"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INDEX_CODES = {torch.int32: 0, torch.int64: 1}


def embed_bag(
    table: torch.Tensor,                  # (V, E) fp32 / bf16
    indices: torch.Tensor,                # (B, L) int, -1 padding
    weights: torch.Tensor | None = None,  # (B, L) per-sample weights
    *,
    combiner: str = "sum",
):
    """EmbeddingBag: ``(B, E)`` per-bag sums (or means) of table rows, in
    the table's dtype. Slots with ``idx < 0`` pad a bag; ``mean`` divides by
    ``max(valid slots, 1)`` (the weights do not count toward it)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be sum|mean, got {combiner}")
    if table.dim() != 2 or table.dtype not in _DTYPE_CODES:
        raise ValueError(f"table must be (V, E) float32 or bfloat16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if indices.dim() != 2 or indices.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"indices must be (B, L) int32/int64, got "
                         f"{tuple(indices.shape)} {indices.dtype}")
    if weights is not None and weights.shape != indices.shape:
        raise ValueError(f"weights must be {tuple(indices.shape)}, got "
                         f"{tuple(weights.shape)}")
    if not on_cuda(table, indices, weights):
        return embed_bag_ref(table, indices, weights, combiner=combiner)
    (v, e), (b, l) = table.shape, indices.shape
    out = torch.empty((b, e), dtype=table.dtype, device=table.device)
    if b == 0 or e == 0:
        return out
    if l == 0:
        return out.zero_()
    tbl = table.contiguous()
    idx = indices.contiguous()
    w = weights
    if w is not None:
        if w.dtype not in _DTYPE_CODES:
            w = w.to(table.dtype)
        w = w.contiguous()
    status = launch_on(
        table.device, cuda_function("embed_bag", "embed_bag_launch", 4, 8),
        tbl.data_ptr(), idx.data_ptr(), None if w is None else w.data_ptr(),
        out.data_ptr(), b, l, v, e, _DTYPE_CODES[tbl.dtype],
        _INDEX_CODES[idx.dtype], 0 if w is None else _DTYPE_CODES[w.dtype],
        int(combiner == "mean"),
    )
    check_status("embed_bag", status)
    embed_bag.launches += 1
    return out


embed_bag.launches = 0
