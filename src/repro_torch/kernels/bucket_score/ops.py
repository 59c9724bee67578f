"""Wrappers for the bucket scoring kernels, the probe-dedup scheduler and
the bucket-major packing helpers.

Counterpart of :mod:`repro.kernels.bucket_score.ops`.

``bucket_score_tiled``
    A CPU tensor goes to the plain version (:mod:`.ref`); a CUDA tensor goes
    to the hand-written CUDA kernel ``csrc/bucket_score_tiled.cu`` (built
    with ``nvcc`` for ``sm_90a`` on first use, bound with ``ctypes``) or the
    call raises. Any ``D`` and any query tile: a tile wider than the kernel
    takes (16, or 8 where 16 does not fit shared memory) runs as sub-tiles
    that share the schedule row. Launches are counted in
    ``bucket_score_tiled.launches``.
``bucket_score``
    The v1 per-query path (``csrc/bucket_score.cu``; fp32 and bf16 packs):
    one CTA per query over its ``P`` probes, no schedule. The reference's
    only caller is the kernels bench. Launches: ``bucket_score.launches``.
``build_probe_schedule`` / ``build_probe_schedule_device``
    The host numpy oracle and the on-device segmented dedup (stable sort ->
    first-occurrence marks -> cumsum -> scatter); same contract.
``pick_query_tile``
    Re-derived for Hopper: the tile must fit the kernel's shared memory
    (:func:`smem_bytes`), not the TPU's VMEM budget.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..common import (SMEM_BYTES_PER_BLOCK, check_status, cuda_function,
                      on_cuda, pad_to)
from .ref import bucket_score_ref, bucket_score_tiled_ref

__all__ = [
    "bucket_score",
    "bucket_score_tiled",
    "build_probe_schedule",
    "build_probe_schedule_device",
    "schedule_length",
    "schedule_block_reads",
    "pick_query_tile",
    "smem_bytes",
    "split_query_tiles",
    "pack_bucket_major",
    "quantize_bucket_major",
    "dequantize_bucket_major",
    "SMEM_BYTES_PER_BLOCK",
]

# Tile sizes the kernel is instantiated for (register-resident accumulators).
KERNEL_TILES = (8, 16)
_CHUNK = 256          # kChunk in the CUDA source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def smem_bytes(qtm: int, d: int, k_pad: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA — mirrors ``smem_bytes`` in the CUDA
    source: the tile's queries (``D`` padded to one warp-wide load), one
    ``(QT, 256)`` score chunk, the chunk's ids, the membership row, and the
    running top-k with its pre-bucket snapshot."""
    blk = 32 * 16 // itemsize
    dp = pad_to(d, blk)
    return 4 * (qtm * dp + qtm * _CHUNK) + 4 * (_CHUNK + qtm) + 12 * qtm * k_pad


def pick_query_tile(
    d: int, b: int, *, k_pad: int = 16, pack_itemsize: int = 4,
    budget_bytes: int = SMEM_BYTES_PER_BLOCK,
) -> int:
    """The largest tile the CUDA kernel is built for (16, else 8) whose
    shared memory fits one block.

    ``b`` does not enter: the kernel streams a bucket in 256-row chunks, so
    the bucket size costs no shared memory (it is kept in the signature to
    match the reference's). Raises ``ValueError`` when even 8 queries of
    width ``d`` do not fit (fp32 at ``k_pad = 16``: ``D > 6912``).
    """
    del b
    for qt in sorted(KERNEL_TILES, reverse=True):
        if smem_bytes(qt, d, k_pad, pack_itemsize) <= budget_bytes:
            return qt
    raise ValueError(
        f"D={d} with k_pad={k_pad} does not fit the kernel's shared memory "
        f"even at {min(KERNEL_TILES)} queries per tile"
    )


def schedule_length(query_tile: int, n_probes: int, n_buckets: int) -> int:
    """Power-of-two bound on any tile's unique bucket count,
    ``pow2ceil(min(QT·P, n_buckets))`` — as the reference."""
    tight = max(1, min(int(query_tile) * int(n_probes), int(n_buckets)))
    return 1 << (tight - 1).bit_length()


def build_probe_schedule(
    probes: np.ndarray, query_tile: int, *, pad_multiple: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Host numpy probe-dedup scheduler (the oracle for the device path).

    Returns ``(schedule (n_tiles, S) int32, member (n_tiles, S, QT) int32)``
    with ``S`` the max per-tile unique count rounded up to ``pad_multiple``.
    Padded slots point at bucket 0 with zero membership; entries < 0 are
    ignored.
    """
    probes = np.asarray(probes)
    nq, _ = probes.shape
    qt = int(query_tile)
    n_tiles = max(1, -(-nq // qt))
    pad = n_tiles * qt - nq
    pp = np.pad(probes, ((0, pad), (0, 0)), constant_values=-1)
    tiles = pp.reshape(n_tiles, qt, -1)
    uniq = [np.unique(t[t >= 0]) for t in tiles]
    s_len = pad_to(max(1, max(u.size for u in uniq)), pad_multiple)
    sched = np.zeros((n_tiles, s_len), np.int32)
    member = np.zeros((n_tiles, s_len, qt), np.int32)
    for ti, u in enumerate(uniq):
        sched[ti, : u.size] = u
        member[ti, : u.size] = np.any(
            tiles[ti][None, :, :] == u[:, None, None], axis=-1
        )
    return sched, member


def build_probe_schedule_device(
    probes: torch.Tensor, *, query_tile: int, s_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device probe-dedup scheduler: per tile, stable-sort the ``QT·P``
    flat probes (``-1`` entries sink to the front), mark first occurrences,
    prefix-sum them into slots, scatter values into ``schedule`` and ones
    into ``member``. ``s_len`` must bound every tile's unique count
    (:func:`schedule_length`). Unused slots keep bucket 0, membership 0."""
    nq, p = probes.shape
    qt = int(query_tile)
    dev = probes.device
    n_tiles = max(1, -(-nq // qt))
    pad = n_tiles * qt - nq
    pp = F.pad(probes.to(torch.int32), (0, 0, 0, pad), value=-1)
    flat = pp.reshape(n_tiles, qt * p)
    v, order = torch.sort(flat, dim=-1, stable=True)
    qidx = torch.arange(qt, device=dev).repeat_interleave(p)[order]
    valid = v >= 0
    prev = torch.cat(
        [torch.full((n_tiles, 1), -2, dtype=v.dtype, device=dev), v[:, :-1]],
        dim=-1,
    )
    first = valid & (v != prev)
    pos = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    pos = torch.where(valid, pos, s_len)                  # invalid -> dump slot
    sched = torch.zeros((n_tiles, s_len + 1), dtype=torch.int32, device=dev)
    sched.scatter_(1, torch.where(first, pos, s_len), v)
    member = torch.zeros((n_tiles, s_len + 1, qt), dtype=torch.int32,
                         device=dev)
    rows = torch.arange(n_tiles, device=dev)[:, None].expand_as(pos)
    member[rows, pos, qidx] = 1
    return sched[:, :s_len], member[:, :s_len]


def schedule_block_reads(member: torch.Tensor) -> int:
    """Live block reads of a schedule: slots with at least one member."""
    return int(torch.as_tensor(member).any(dim=-1).sum())


def _check_tiled(queries, bucket_data, bucket_ids, schedule, member, exclude,
                 scales):
    if queries.dim() != 2 or queries.dtype != torch.float32:
        raise ValueError(f"queries must be (nq, D) float32, got "
                         f"{tuple(queries.shape)} {queries.dtype}")
    nq, d = queries.shape
    if bucket_data.dim() != 3 or bucket_data.shape[2] != d:
        raise ValueError(f"bucket_data must be (K, B, {d}), got "
                         f"{tuple(bucket_data.shape)}")
    if bucket_data.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported pack dtype {bucket_data.dtype} "
                         f"(float32, bfloat16 or int8)")
    n_buckets, b, _ = bucket_data.shape
    if tuple(bucket_ids.shape) != (n_buckets, b):
        raise ValueError(f"bucket_ids must be ({n_buckets}, {b}), got "
                         f"{tuple(bucket_ids.shape)}")
    n_tiles, s_len = schedule.shape
    if member.dim() != 3 or tuple(member.shape[:2]) != (n_tiles, s_len):
        raise ValueError(f"member must be ({n_tiles}, {s_len}, QT), got "
                         f"{tuple(member.shape)}")
    qt = member.shape[-1]
    if n_tiles * qt < nq:
        raise ValueError(
            f"schedule covers {n_tiles}x{qt} query rows, batch has {nq}"
        )
    if bucket_data.dtype == torch.int8 and scales is None:
        raise ValueError(
            "int8 bucket_data requires the per-bucket scales= operand "
            "(see quantize_bucket_major)"
        )
    if scales is not None and tuple(scales.shape) != (n_buckets,):
        raise ValueError(f"scales must be ({n_buckets},), got "
                         f"{tuple(scales.shape)}")
    if exclude is not None and tuple(exclude.shape) != (nq,):
        raise ValueError(f"exclude must be ({nq},), got "
                         f"{tuple(exclude.shape)}")


def bucket_score_tiled(
    queries: torch.Tensor,        # (nq, D) fp32
    bucket_data: torch.Tensor,    # (K, B, D) bucket-major (fp32/bf16/int8)
    bucket_ids: torch.Tensor,     # (K, B) int32, -1 padding
    schedule: torch.Tensor,       # (n_tiles, S) int32 dedup'd bucket schedule
    member: torch.Tensor,         # (n_tiles, S, QT) int32 membership mask
    *,
    k: int,
    exclude: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,   # (K,) fp32 — required for int8
):
    """Query-tiled cluster-prune scoring: ``(scores (nq, k), ids (nq, k))``.

    Row ``t`` of ``schedule`` is the deduplicated union of the probe lists
    of queries ``[t·QT, (t+1)·QT)``; ``member[t, s, q]`` says whether tile
    query ``q`` probes ``schedule[t, s]``. Ragged tails are padded to the
    tile with zero membership and sliced off. ``k_pad = min(pad8(k), B·S)``
    as in the reference.
    """
    _check_tiled(queries, bucket_data, bucket_ids, schedule, member, exclude,
                 scales)
    if not on_cuda(queries, bucket_data, bucket_ids, schedule, member,
                   exclude, scales):
        return bucket_score_tiled_ref(
            queries, bucket_data, bucket_ids, schedule, member,
            k=k, exclude=exclude, scales=scales,
        )
    d = queries.shape[1]
    n_buckets, b, _ = bucket_data.shape
    s_len = schedule.shape[1]
    dev = queries.device
    k_pad = min(pad_to(k, 8), b * s_len)
    cap = pick_query_tile(d, b, k_pad=k_pad,
                          pack_itemsize=bucket_data.element_size())
    q, sched, mem, ex, unsplit = split_query_tiles(
        queries, schedule, member, exclude, cap)
    if scales is None:
        scales = torch.ones((n_buckets,), dtype=torch.float32, device=dev)
    data = bucket_data.contiguous()
    ids = bucket_ids.to(torch.int32).contiguous()
    sc = scales.to(torch.float32).contiguous()
    out_s = torch.empty((q.shape[0], k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((q.shape[0], k_pad), dtype=torch.int32, device=dev)
    launch = cuda_function("bucket_score_tiled", "bucket_score_tiled_launch",
                           9, 7)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = launch(
            q.data_ptr(), data.data_ptr(), ids.data_ptr(), sc.data_ptr(),
            sched.data_ptr(), mem.data_ptr(), ex.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            sched.shape[0], s_len, mem.shape[-1], b, d, k_pad,
            _DTYPE_CODES[data.dtype], stream,
        )
    check_status("bucket_score_tiled", status)
    bucket_score_tiled.launches += 1
    return unsplit(out_s)[:, :k], unsplit(out_i)[:, :k]


bucket_score_tiled.launches = 0


def split_query_tiles(queries, schedule, member, exclude, cap: int):
    """Cut each query tile of a schedule into balanced sub-tiles of at most
    ``cap`` queries. Each sub-tile is a tile of its own: it repeats the
    parent's schedule row and takes its own columns of ``member`` (the
    answers do not change: membership is per query). Returns ``(queries,
    schedule, member, exclude, unsplit)``, the tensors padded and
    contiguous, ``unsplit`` mapping ``(n_sub_tiles · st, c)`` results back
    to ``(nq, c)``."""
    nq, d = queries.shape
    n_tiles, s_len, qt = member.shape
    n_sub = -(-qt // cap)
    st = -(-qt // n_sub)
    wide = n_sub * st
    pad = n_tiles * qt - nq
    q = F.pad(F.pad(queries, (0, 0, 0, pad)).reshape(n_tiles, qt, d),
              (0, 0, 0, wide - qt)).reshape(n_tiles * wide, d).contiguous()
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32,
                             device=queries.device)
    ex = F.pad(F.pad(exclude.to(torch.int32), (0, pad), value=-1)
               .reshape(n_tiles, qt), (0, wide - qt), value=-1)
    mem = F.pad(member.to(torch.int32), (0, wide - qt))
    mem = mem.reshape(n_tiles, s_len, n_sub, st).permute(0, 2, 1, 3)
    sched = schedule.to(torch.int32).repeat_interleave(n_sub, dim=0)

    def unsplit(x):
        c = x.shape[-1]
        return x.reshape(n_tiles, wide, c)[:, :qt].reshape(-1, c)[:nq]

    return (q, sched.contiguous(),
            mem.reshape(n_tiles * n_sub, s_len, st).contiguous(),
            ex.reshape(-1).contiguous(), unsplit)


def bucket_score(
    queries: torch.Tensor,        # (nq, D) fp32
    bucket_data: torch.Tensor,    # (K, B, D) bucket-major, fp32 or bf16
    bucket_ids: torch.Tensor,     # (K, B) int32, -1 padding
    probes: torch.Tensor,         # (nq, P) int32 bucket ids in [0, K)
    *,
    k: int,
    exclude: torch.Tensor | None = None,
):
    """v1 per-query cluster-prune scoring: ``(scores (nq, k), ids (nq, k))``.

    Query ``q`` scores buckets ``probes[q, 0..P)`` in order against its fp32
    row (a bf16 pack is widened, the query is not rounded), masking padding,
    ``exclude[q]`` and ids already in its running top-k; ``k_pad =
    min(pad8(k), B·P)`` as in the reference. int8 packs are refused: the v1
    kernel has no scales operand (use :func:`bucket_score_tiled`).
    """
    if queries.dim() != 2 or queries.dtype != torch.float32:
        raise ValueError(f"queries must be (nq, D) float32, got "
                         f"{tuple(queries.shape)} {queries.dtype}")
    nq, d = queries.shape
    if bucket_data.dim() != 3 or bucket_data.shape[2] != d:
        raise ValueError(f"bucket_data must be (K, B, {d}), got "
                         f"{tuple(bucket_data.shape)}")
    if bucket_data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"bucket_score (v1) takes float32 or bfloat16 packs, got "
            f"{bucket_data.dtype}; an int8 pack needs its scales "
            f"(bucket_score_tiled)")
    n_buckets, b, _ = bucket_data.shape
    if tuple(bucket_ids.shape) != (n_buckets, b):
        raise ValueError(f"bucket_ids must be ({n_buckets}, {b}), got "
                         f"{tuple(bucket_ids.shape)}")
    if probes.dim() != 2 or probes.shape[0] != nq or probes.shape[1] < 1:
        raise ValueError(f"probes must be ({nq}, P >= 1), got "
                         f"{tuple(probes.shape)}")
    if exclude is not None and tuple(exclude.shape) != (nq,):
        raise ValueError(f"exclude must be ({nq},), got "
                         f"{tuple(exclude.shape)}")
    if not on_cuda(queries, bucket_data, bucket_ids, probes, exclude):
        return bucket_score_ref(queries, bucket_data, bucket_ids, probes,
                                k=k, exclude=exclude)
    p = probes.shape[1]
    dev = queries.device
    k_pad = min(pad_to(k, 8), b * p)
    if _v1_smem_bytes(d, k_pad, bucket_data.element_size()) \
            > SMEM_BYTES_PER_BLOCK:
        raise ValueError(f"D={d} with k_pad={k_pad} does not fit the v1 "
                         f"kernel's shared memory")
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    q = queries.contiguous()
    data = bucket_data.contiguous()
    ids = bucket_ids.to(torch.int32).contiguous()
    pr = probes.to(torch.int32).contiguous()
    ex = exclude.to(torch.int32).contiguous()
    out_s = torch.empty((nq, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k_pad), dtype=torch.int32, device=dev)
    launch = cuda_function("bucket_score", "bucket_score_launch", 7, 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = launch(
            q.data_ptr(), data.data_ptr(), ids.data_ptr(), pr.data_ptr(),
            ex.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            nq, p, b, d, k_pad, _DTYPE_CODES[data.dtype], stream,
        )
    check_status("bucket_score", status)
    bucket_score.launches += 1
    return out_s[:, :k], out_i[:, :k]


bucket_score.launches = 0


def _v1_smem_bytes(d: int, k_pad: int, itemsize: int) -> int:
    """Dynamic shared memory of one v1 CTA (``smem_bytes`` in
    ``csrc/bucket_score.cu``): the query, one score chunk and its ids, and
    the running top-k with its snapshot."""
    dp = pad_to(d, 32 * 16 // itemsize)
    return 4 * (dp + _CHUNK) + 4 * (_CHUNK + 1) + 12 * k_pad


def quantize_bucket_major(data: torch.Tensor, *, chunk: int = 64):
    """Symmetric per-bucket int8 quantisation of ``(..., B, D)`` fp32.

    One scale ``max|v| / 127`` per bucket (scale 1 for an all-zero bucket);
    ``round(v / scale)`` rounds half to even, as ``jnp.round`` does, so the
    values and scales are bit-identical to the reference's. Buckets are
    processed ``chunk`` at a time to bound temporaries on the card.
    Returns ``(int8 values, fp32 scales (...,))``.
    """
    lead = data.shape[:-2]
    flat = data.reshape(-1, *data.shape[-2:])
    values = torch.empty(flat.shape, dtype=torch.int8, device=data.device)
    scales = torch.empty(flat.shape[:1], dtype=torch.float32,
                         device=data.device)
    for i in range(0, flat.shape[0], chunk):
        blk = flat[i:i + chunk].float()
        absmax = blk.abs().amax(dim=(-2, -1))
        sc = torch.where(absmax > 0, absmax / 127.0,
                         torch.ones_like(absmax))
        values[i:i + chunk] = torch.clamp(
            torch.round(blk / sc[:, None, None]), -127, 127
        ).to(torch.int8)
        scales[i:i + chunk] = sc
    return values.reshape(data.shape), scales.reshape(lead)


def dequantize_bucket_major(values: torch.Tensor, scales: torch.Tensor):
    """Inverse of :func:`quantize_bucket_major` (to fp32)."""
    return values.float() * scales[..., None, None]


def pack_bucket_major(docs: torch.Tensor, buckets: torch.Tensor, *,
                      dtype=None, chunk: int = 64):
    """``(n, D)`` corpus + ``(K, B)`` id pack (``-1`` padding) -> ``(K, B, D)``
    bucket-major tensor in ``dtype`` (None keeps fp32; ``torch.bfloat16``
    casts; ``torch.int8`` quantises per bucket). Padded slots point at row 0
    and keep id -1. Gathers ``chunk`` buckets at a time so a quantised pack
    never holds the whole fp32 pack on the card. Returns
    ``(data, ids, scales | None)``."""
    ids = torch.where(buckets >= 0, buckets, -1).to(torch.int32)
    safe = torch.where(buckets >= 0, buckets, 0).long()
    lead, b = tuple(buckets.shape[:-1]), buckets.shape[-1]
    flat = safe.reshape(-1, b)
    out_dtype = docs.dtype if dtype is None else dtype
    data = torch.empty((flat.shape[0], b, docs.shape[1]), dtype=out_dtype,
                       device=docs.device)
    scales = None
    if out_dtype == torch.int8:
        scales = torch.empty((flat.shape[0],), dtype=torch.float32,
                             device=docs.device)
    for i in range(0, flat.shape[0], chunk):
        blk = docs[flat[i:i + chunk]]
        if out_dtype == torch.int8:
            data[i:i + chunk], scales[i:i + chunk] = quantize_bucket_major(blk)
        else:
            data[i:i + chunk] = blk.to(out_dtype)
    data = data.reshape(*lead, b, docs.shape[1])
    if scales is not None:
        scales = scales.reshape(lead)
    return data, ids, scales
