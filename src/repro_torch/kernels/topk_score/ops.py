"""Wrapper of the brute-force score + top-k kernel (counterpart of
:mod:`repro.kernels.topk_score.ops`).

A CPU tensor goes to the plain version (:mod:`.ref`); a CUDA tensor goes
to the hand-written CUDA kernel ``csrc/topk_score.cu`` (built with ``nvcc``
for ``sm_90a`` on first use, bound with ``ctypes``) or the call raises.
Launches are counted in ``topk_score.launches`` (one per call: the kernel's
two launches, partial lists then their merge, count once).

Two cores compute launch 1 (:func:`_core` picks one by shape, never after
a failure): bf16 inputs with ``D % 8 == 0``, 16-byte aligned rows and
``k <= 32`` take the tensor-core core (``csrc/topk_score_tc.cuh``: wgmma
fed by TMA, the top-k fused into its epilogue), counted also in
``topk_score.tc_launches``; everything else (fp32, and the other bf16
calls) takes the CUDA-core core of ``csrc/topk_score.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from ...runtime import trace
from ..common import (SMEM_BYTES_PER_BLOCK, check_status, count_launch,
                      cuda_function, launch_on, load_cuda_library, on_cuda,
                      pad_to)
from .ref import topk_score_ref

__all__ = ["topk_score"]
_QT = 64           # kQT in the CUDA source: queries per CTA
_RB = 128          # kRB: doc rows per block
_STAGE = _RB * 272 + _QT * 64 * 4  # kStage: one row stage + one query stage
_CTAS_PER_SM = 2   # doc splits are sized to give about this many CTAs per SM
_MAX_SPLITS = 4096  # bounds the merge launch's shared memory
_DTYPES = (torch.float32, torch.bfloat16)
# the tensor-core core (topk_tc:: in csrc/topk_score_tc.cuh)
_TC_BM = 128       # kBM: doc rows a tile
_TC_BN = 256       # kBN: queries a tile
_TC_STAGES = 3     # kStages, each kBK = 64 columns of docs and queries
_TC_STAGE = (_TC_BM + _TC_BN) * 64 * 2
_TC_MISC = 5 * _TC_BN * 4 + 2 * _TC_STAGES * 8  # kMiscBytes
_TC_MAX_K = 32     # kMaxK
_TC_CAP_MAX = 32   # kCapMax
_TC_STAGED_MAX = 8  # kStagedMax
_TC_CLUSTER = 2    # kCluster: CTAs a cluster, one tile of a unit each
_tc_ctas: dict = {}  # (device index, k) -> co-resident CTAs, from the card


def _core(dtype: torch.dtype, d: int, k: int, aligned: bool) -> str:
    """The core of launch 1: ``"tc"`` (tensor cores) for bf16 rows that TMA
    can read (``D % 8 == 0``: a row stride of whole 16 bytes; 16-byte
    aligned base pointers) and lists of at most 32 entries, else ``"fma"``
    (the CUDA cores; fp32 always)."""
    if (dtype == torch.bfloat16 and d % 8 == 0 and aligned
            and 1 <= k <= _TC_MAX_K):
        return "tc"
    return "fma"


def _tc_spare(k_list: int) -> int:
    """8-byte slots a query (``spare_slots``) that a block's shared memory
    holds beside the stage ring, the lists and the counters."""
    return ((SMEM_BYTES_PER_BLOCK - _TC_STAGES * _TC_STAGE - _TC_MISC
             - _TC_BN * 8 * k_list) // (_TC_BN * 8))


def _tc_staged(k_list: int) -> int:
    """Elements a consumer thread stages before it appends them
    (``staged_max``): 8, or half the spare slots."""
    return min(_TC_STAGED_MAX, _tc_spare(k_list) // 2)


def _tc_cap(k_list: int) -> int:
    """Candidate slots a query (``cand_cap``): the other spare slots, at
    most 32."""
    return min(_TC_CAP_MAX, _tc_spare(k_list) - _tc_staged(k_list))


def _tc_smem_bytes(k_list: int) -> int:
    """Shared memory of a CTA of the tensor-core core (``smem_bytes``): the
    stage ring, the 256 lists and candidate buffers, the 256 threads'
    staging slots, the counters, the excluded ids, the lists' last entries
    and the barriers."""
    return (_TC_STAGES * _TC_STAGE + _TC_MISC + _TC_BN * 8
            * (k_list + _tc_cap(k_list) + _tc_staged(k_list)))


def _tc_plan(nq: int, n: int, n_ctas: int) -> tuple[int, int, int]:
    """``(query tiles, doc ranges, grid)`` of the tensor-core core: 256-query
    tiles; the 128-row doc tiles grouped in units of ``_TC_CLUSTER`` (one
    tile a CTA of a cluster) and cut into contiguous ranges so that the
    (query tile, range) items fill the ``n_ctas`` CTAs the card holds at
    once; one persistent cluster an item at most (a cluster takes items
    the cluster count apart)."""
    q_tiles = -(-nq // _TC_BN)
    n_tiles = -(-n // _TC_BM)
    units = -(-n_tiles // _TC_CLUSTER)
    clusters = max(1, n_ctas // _TC_CLUSTER)
    ranges = min(units, max(1, clusters // q_tiles))
    return q_tiles, ranges, _TC_CLUSTER * min(clusters, q_tiles * ranges)


def _tc_range(r: int, ranges: int, units: int) -> tuple[int, int]:
    """Units ``[begin, end)`` of range ``r`` (``range_begin``)."""
    return r * units // ranges, (r + 1) * units // ranges


def _tc_max_ctas(dev: torch.device, k: int) -> int:
    """CTAs of the tensor-core core the card holds at once (whole
    clusters, ``cudaOccupancyMaxActiveClusters``), asked once a device."""
    key = (dev.index, k)
    if key not in _tc_ctas:
        fn = load_cuda_library("topk_score").topk_score_tc_max_ctas
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        with torch.cuda.device(dev):
            got = fn(k)
        if got <= 0:
            raise RuntimeError(f"topk_score: no cluster of the tensor-core "
                               f"core fits the card (cudaError {-got})")
        _tc_ctas[key] = got
    return _tc_ctas[key]


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
    core: str | None = None,
):
    """Exact brute-force top-k: ``(scores (nq, k) f32, ids (nq, k) i32)``,
    ordered by score descending then doc id ascending; ``-inf`` / ``-1``
    past the eligible documents. Any ``k >= 1``. fp32 or bf16 inputs, scored
    in fp32; ``round_bf16`` rounds each score to bf16 (nearest even) before
    the masks and the top-k. ``chunk`` is the doc rows per step of the
    plain version (the CPU path) and does not change the answer. ``core``
    (``"tc"`` or ``"fma"``) forces a core of the CUDA path, for tests and
    timings only; ``"tc"`` on inputs it does not take raises."""
    with trace.span("kernels.topk_score"):
        if queries.dim() != 2 or queries.dtype not in _DTYPES:
            raise ValueError(f"queries must be (nq, D) float32 or bfloat16, "
                             f"got {tuple(queries.shape)} {queries.dtype}")
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
        if core not in (None, "tc", "fma"):
            raise ValueError(f"core must be 'tc' or 'fma', got {core!r}")
        if not on_cuda(queries, docs, exclude, mask):
            return topk_score_ref(queries, docs, k=k, exclude=exclude,
                                  mask=mask, chunk=chunk,
                                  round_bf16=round_bf16)
        dev = queries.device
        out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
        if nq == 0:
            return out_s, out_i
        if n == 0:
            return out_s.fill_(float("-inf")), out_i.fill_(-1)
        q = queries.contiguous()
        x = docs.contiguous()
        if exclude is None:
            exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
        ex = exclude.to(torch.int32).contiguous()
        mk = None if mask is None else mask.contiguous()
        pick = _core(queries.dtype, d, k,
                     q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
        if core == "tc" and pick != "tc":
            raise ValueError("core='tc' takes bf16 inputs with D % 8 == 0, "
                             "16-byte aligned rows and 1 <= k <= 32")
        if (core or pick) == "tc":
            q_tiles, ranges, grid = _tc_plan(nq, n, _tc_max_ctas(dev, k))
            splits = _TC_CLUSTER * ranges
            part_s = torch.empty((splits, q_tiles * _TC_BN, k),
                                 dtype=torch.float32, device=dev)
            part_i = torch.empty((splits, q_tiles * _TC_BN, k),
                                 dtype=torch.int32, device=dev)
            status = launch_on(
                dev, cuda_function("topk_score", "topk_score_tc_launch", 8, 7),
                q.data_ptr(), x.data_ptr(), ex.data_ptr(),
                None if mk is None else mk.data_ptr(),
                part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), nq, n, d, k, ranges, grid, int(round_bf16),
            )
            check_status("topk_score", status)
            count_launch(topk_score)
            count_launch(topk_score, "tc_launches")
            return out_s, out_i
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
topk_score.tc_launches = 0
