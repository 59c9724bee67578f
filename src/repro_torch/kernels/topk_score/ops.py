"""Wrapper of the brute-force score + top-k kernel (counterpart of
:mod:`repro.kernels.topk_score.ops`).

A CPU tensor goes to the plain version (:mod:`.ref`); a CUDA tensor goes
to the hand-written CUDA kernel ``csrc/topk_score.cu`` (built with ``nvcc``
for ``sm_90a`` on first use, bound with ``ctypes``) or the call raises.
Launches are counted in ``topk_score.launches`` (one per call: the kernel's
two launches, partial lists then their merge, count once).
"""

from __future__ import annotations

import torch

from ..common import (SMEM_BYTES_PER_BLOCK, check_status, count_launch,
                      cuda_function, launch_on, on_cuda, pad_to)
from .ref import topk_score_ref

__all__ = ["topk_score"]
_QT = 64           # kQT in the CUDA source: queries per CTA
_RB = 128          # kRB: doc rows per block
_STAGE = _RB * 272 + _QT * 64 * 4  # kStage: one row stage + one query stage
_CTAS_PER_SM = 2   # doc splits are sized to give about this many CTAs per SM
_MAX_SPLITS = 4096  # bounds the merge launch's shared memory
_DTYPES = (torch.float32, torch.bfloat16)


def _split_rows(nq: int, n: int, n_sms: int) -> int:
    """Doc rows per CTA of the first launch: enough splits of the doc axis
    that the 64-query tiles times the splits fill ``n_sms`` SMs about
    ``_CTAS_PER_SM`` deep, in whole 128-row blocks."""
    tiles = -(-nq // _QT)
    splits = max(1, min(_MAX_SPLITS, -(-_CTAS_PER_SM * n_sms // tiles)))
    return max(_RB, pad_to(-(-n // splits), _RB))


def _smem_bytes(k_list: int, lists_in_smem: bool) -> int:
    """Shared memory of one CTA of the first launch (``partial_smem_bytes``
    in the CUDA source): two column stages of 128 rows and 64 queries (the
    score block lies over them), the block's ids, the tile's excluded ids,
    and the 64 partial lists when they are kept there. It does not grow
    with ``D``."""
    lists = 8 * _QT * k_list if lists_in_smem else 0
    return 2 * _STAGE + 4 * (_RB + _QT) + lists


def topk_score(
    queries: torch.Tensor,               # (nq, D) fp32 or bf16
    docs: torch.Tensor,                  # (n, D) the same dtype
    *,
    k: int,
    exclude: torch.Tensor | None = None,  # (nq,) doc id or -1
    mask: torch.Tensor | None = None,     # (n,) bool, False = ineligible
    chunk: int = 8192,
    round_bf16: bool = False,
):
    """Exact brute-force top-k: ``(scores (nq, k) f32, ids (nq, k) i32)``,
    ordered by score descending then doc id ascending; ``-inf`` / ``-1``
    past the eligible documents. Any ``k >= 1``. fp32 or bf16 inputs, scored
    in fp32; ``round_bf16`` rounds each score to bf16 (nearest even) before
    the masks and the top-k. ``chunk`` is the doc rows per step of the
    plain version (the CPU path) and does not change the answer."""
    if queries.dim() != 2 or queries.dtype not in _DTYPES:
        raise ValueError(f"queries must be (nq, D) float32 or bfloat16, got "
                         f"{tuple(queries.shape)} {queries.dtype}")
    nq, d = queries.shape
    if (docs.dim() != 2 or docs.shape[1] != d
            or docs.dtype != queries.dtype):
        raise ValueError(f"docs must be (n, {d}) {queries.dtype}, got "
                         f"{tuple(docs.shape)} {docs.dtype}")
    n = docs.shape[0]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if exclude is not None and tuple(exclude.shape) != (nq,):
        raise ValueError(f"exclude must be ({nq},), got "
                         f"{tuple(exclude.shape)}")
    if mask is not None and (tuple(mask.shape) != (n,)
                             or mask.dtype != torch.bool):
        raise ValueError(f"mask must be ({n},) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if not on_cuda(queries, docs, exclude, mask):
        return topk_score_ref(queries, docs, k=k, exclude=exclude, mask=mask,
                              chunk=chunk, round_bf16=round_bf16)
    dev = queries.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    if n == 0:
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    rows = _split_rows(nq, n, torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    n_splits = -(-n // rows)
    k_list = min(k, rows)
    in_smem = _smem_bytes(k_list, True) <= SMEM_BYTES_PER_BLOCK
    nq_pad = pad_to(nq, _QT)
    part_s = torch.empty((n_splits, nq_pad, k_list), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((n_splits, nq_pad, k_list), dtype=torch.int32,
                         device=dev)
    q = queries.contiguous()
    x = docs.contiguous()
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    ex = exclude.to(torch.int32).contiguous()
    mk = None if mask is None else mask.contiguous()
    status = launch_on(
        dev, cuda_function("topk_score", "topk_score_launch", 8, 9),
        q.data_ptr(), x.data_ptr(), ex.data_ptr(),
        None if mk is None else mk.data_ptr(),
        part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), nq, n, d, k, rows, k_list, int(in_smem),
        int(queries.dtype == torch.bfloat16), int(round_bf16),
    )
    check_status("topk_score", status)
    count_launch(topk_score)
    return out_s, out_i


topk_score.launches = 0
