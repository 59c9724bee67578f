"""Wrappers for the bucket scoring kernels, the probe-dedup scheduler and
the bucket-major packing helpers.

Counterpart of :mod:`repro.kernels.bucket_score.ops`.

``bucket_score_tiled``
    A CPU tensor goes to the plain version (:mod:`.ref`); a CUDA tensor goes
    to the hand-written CUDA kernel ``csrc/bucket_score_tiled.cu`` (built
    with ``nvcc`` for ``sm_90a`` on first use, bound with ``ctypes``) or the
    call raises. The kernel is two launches, scoring over the whole card
    then an in-order merge (:class:`TiledCall`); a schedule whose scoring
    scratch would exceed :data:`SCRATCH_BYTES` runs in segments. Any ``D``
    and any query tile: a tile wider than 16 runs as sub-tiles that share
    the schedule row. Launches are counted in ``bucket_score_tiled.launches``
    (one per call, whatever the segments).
``bucket_score``
    The v1 per-query path (``csrc/bucket_score.cu``; fp32, bf16 and int8
    packs, an int8 pack widened with no scale, as the reference). On the
    card: the probe lists inverted on the device (:func:`invert_probes`),
    a scoring launch that reads each probed block once for a group of up
    to 16 (query, probe) entries, and the tiled kernel's slot-ordered merge
    with each query's probe list as its schedule (:class:`V1Call`); the
    scratch is bounded as the tiled kernel's. The reference's only caller
    is the kernels bench. Launches: ``bucket_score.launches`` (one per
    call, whatever the segments).
``build_probe_schedule`` / ``build_probe_schedule_device``
    The host numpy oracle and the on-device segmented dedup (stable sort ->
    first-occurrence marks -> cumsum -> scatter); same contract.
``pick_query_tile``
    Re-derived for Hopper: 16, the rows of the scoring launch's register
    tile, for every shape (:func:`smem_bytes` does not grow with ``D``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..common import (SMEM_BYTES_PER_BLOCK, check_status, count_launch,
                      cuda_function, launch_on, on_cuda, pad_to)
from .ref import bucket_score_ref, bucket_score_tiled_ref

__all__ = [
    "bucket_score",
    "bucket_score_tiled",
    "build_probe_schedule",
    "build_probe_schedule_device",
    "schedule_length",
    "schedule_block_reads",
    "pick_query_tile",
    "plan_segments",
    "smem_bytes",
    "split_query_tiles",
    "TiledCall",
    "V1Call",
    "invert_probes",
    "v1_smem_bytes",
    "pack_bucket_major",
    "quantize_bucket_major",
    "dequantize_bucket_major",
    "SMEM_BYTES_PER_BLOCK",
]

# The CUDA kernel's query tile: each scoring CTA computes a (16 queries x
# 128 bucket rows) score block, 4 queries x 4 rows per thread.
KERNEL_TILE = 16
_RB = 128                  # kRB in the CUDA source: bucket rows per CTA
_STAGE_BYTES = 128         # kStageBytes: bytes of each row per stage
# Bound on the scoring launch's global scratch (masked scores, [tile][slot]
# [query][row] fp32, and their block maxima); a schedule that needs more
# runs in segments of slots (and groups of tiles).
SCRATCH_BYTES = 256 * 2**20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# v1's scoring launch scores each block once for a group of at most this
# many (query, probe) entries of one bucket (kG in csrc/bucket_score.cu).
V1_GROUP = 16


def smem_bytes(itemsize: int) -> int:
    """Dynamic shared memory of one scoring CTA — mirrors
    ``score_smem_bytes`` in the CUDA source: two 128-byte column stages of
    the block's 128 rows (each padded to 144 bytes, 160 for bf16) and of the
    tile's 16 fp32 queries (padded by 16 values), the block's ids, the
    tile's membership flags and the 4 warps' block maxima. ``D``, ``B`` and
    ``k_pad`` do not enter (43.8 KB fp32, 52.0 KB bf16, 56.1 KB int8)."""
    ke = _STAGE_BYTES // itemsize
    row = _STAGE_BYTES + (32 if itemsize == 2 else 16)
    return (2 * _RB * row + 2 * KERNEL_TILE * (ke + 16) * 4
            + 4 * (_RB + KERNEL_TILE) + 4 * 4 * KERNEL_TILE)


def pick_query_tile(d: int, b: int, *, k_pad: int = 16,
                    pack_itemsize: int = 4) -> int:
    """The query tile of the CUDA kernel: 16 for every shape.

    Re-derived from the new kernel's resources. A scoring CTA holds a
    (16 x 128) score block in registers (16 sums a thread) and streams the
    columns through 128-byte shared stages (:func:`smem_bytes`), so neither
    ``d`` nor ``b`` costs it anything; the running lists live in the merge
    launch, one per query, so ``k_pad`` does not enter either. 16 is also
    the m16 of the bf16 / int8 path's ``mma.sync`` tiles. A wider tile
    would read each bucket block once for more queries (fewer bytes per
    flop) at the cost of registers; that trade is not measured yet. Never
    raises, as the reference's. The arguments are the reference's
    signature.
    """
    del d, b, k_pad, pack_itemsize
    return KERNEL_TILE


def plan_segments(n_tiles: int, s_len: int, qt: int, b: int) -> tuple[int, int]:
    """``(tiles per group, slots per segment)`` for one call: the scoring
    scratch of a segment — ``qt · (B + ceil(B/128)) · 4`` bytes per (tile,
    slot) — stays within :data:`SCRATCH_BYTES` (read at call time). All
    tiles at once when one slot of every tile fits, else groups of tiles
    one slot at a time."""
    per = qt * (b + -(-b // _RB)) * 4
    fit = max(1, SCRATCH_BYTES // per)
    if fit >= n_tiles:
        return n_tiles, min(s_len, fit // n_tiles)
    return fit, 1


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
    call = TiledCall(queries, bucket_data, bucket_ids, schedule, member, k=k,
                     exclude=exclude, scales=scales)
    for seg in call.segments:
        call.score(seg)
        call.merge(seg)
    count_launch(bucket_score_tiled)
    return call.result()


bucket_score_tiled.launches = 0


class TiledCall:
    """One :func:`bucket_score_tiled` call on the card, phase by phase:
    for each ``seg`` of ``segments`` (``(t0, tiles, s0, slots)``, tile
    groups in order and, within one, slot segments in order), ``score(seg)``
    then ``merge(seg)``; then ``result()``. The wrapper runs exactly that;
    the pieces are public so a timing tool can put events between the two
    launches. Holds every tensor the launches read until it is dropped."""

    def __init__(self, queries, bucket_data, bucket_ids, schedule, member, *,
                 k: int, exclude=None, scales=None):
        self.dev = queries.device
        self.d = queries.shape[1]
        _, self.b, _ = bucket_data.shape
        self.s_len = schedule.shape[1]
        self.k = k
        self.k_pad = min(pad_to(k, 8), self.b * self.s_len)
        (self.q, self.sched, self.mem, self.ex,
         self.unsplit) = split_query_tiles(queries, schedule, member, exclude,
                                           KERNEL_TILE)
        self.n_tiles, _, self.qt = self.mem.shape
        self.data = bucket_data.contiguous()
        self.ids = bucket_ids.to(torch.int32).contiguous()
        self.scales = (scales.to(torch.float32).contiguous()
                       if self.data.dtype == torch.int8 else None)
        tiles, slots = plan_segments(self.n_tiles, self.s_len, self.qt, self.b)
        self.segments = [
            (t0, min(tiles, self.n_tiles - t0), s0, min(slots, self.s_len - s0))
            for t0 in range(0, self.n_tiles, tiles)
            for s0 in range(0, self.s_len, slots)
        ]
        nrb = -(-self.b // _RB)
        f32 = dict(dtype=torch.float32, device=self.dev)
        self.scores = torch.empty(tiles * slots * self.qt * self.b, **f32)
        self.bmax = torch.empty(tiles * slots * self.qt * nrb, **f32)
        rows = self.n_tiles * self.qt
        self.out_s = torch.empty((rows, self.k_pad), **f32)
        self.out_i = torch.empty((rows, self.k_pad), dtype=torch.int32,
                                 device=self.dev)
        # the merge keeps a query's list and its snapshot in shared memory
        # (12 bytes an entry) when they fit, else in global memory
        self.snap = (None if 12 * self.k_pad <= SMEM_BYTES_PER_BLOCK else
                     torch.empty((rows, self.k_pad), dtype=torch.int32,
                                 device=self.dev))

    def score(self, seg):
        t0, tiles, s0, slots = seg
        status = launch_on(
            self.dev,
            cuda_function("bucket_score_tiled", "bucket_score_tiled_score",
                          9, 9),
            self.q.data_ptr(), self.data.data_ptr(), self.ids.data_ptr(),
            None if self.scales is None else self.scales.data_ptr(),
            self.sched.data_ptr(), self.mem.data_ptr(), self.ex.data_ptr(),
            self.scores.data_ptr(), self.bmax.data_ptr(),
            t0, tiles, self.s_len, s0, slots, self.qt, self.b, self.d,
            _DTYPE_CODES[self.data.dtype])
        check_status("bucket_score_tiled (scoring)", status)

    def merge(self, seg):
        t0, tiles, s0, slots = seg
        status = launch_on(
            self.dev,
            cuda_function("bucket_score_tiled", "bucket_score_tiled_merge",
                          9, 9),
            self.scores.data_ptr(), self.bmax.data_ptr(), self.ids.data_ptr(),
            self.sched.data_ptr(), self.mem.data_ptr(), self.ex.data_ptr(),
            self.out_s.data_ptr(), self.out_i.data_ptr(),
            None if self.snap is None else self.snap.data_ptr(),
            t0, tiles, self.s_len, s0, slots, self.qt, self.b, self.k_pad,
            int(s0 == 0))
        check_status("bucket_score_tiled (merge)", status)

    def result(self):
        """``(scores (nq, k), ids (nq, k))`` from the output lists."""
        return (self.unsplit(self.out_s)[:, :self.k],
                self.unsplit(self.out_i)[:, :self.k])


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


def v1_smem_bytes(itemsize: int) -> int:
    """Dynamic shared memory of one v1 scoring CTA — mirrors
    ``score_smem_bytes`` in ``csrc/bucket_score.cu``: two 128-byte column
    stages of the block's 128 rows (each padded to 144 bytes) and of the
    group's 16 fp32 query rows, the block's ids, the group's query rows,
    scratch rows and excluded ids, and the 4 warps' per-query maxima
    (41.9 KB fp32, 46.0 KB bf16, 54.2 KB int8)."""
    ke = _STAGE_BYTES // itemsize
    return (2 * _RB * (_STAGE_BYTES + 16) + 2 * V1_GROUP * ke * 4
            + 4 * (_RB + 3 * V1_GROUP) + 4 * 4 * V1_GROUP)


def invert_probes(probes: torch.Tensor, n_buckets: int, *, tiles: int,
                  slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """v1's probe lists inverted on the tensors' device, no host sync:
    ``(order, gsize)``, both ``(nq·P,)`` int32.

    The flat entries ``q·P + p`` are stable-sorted by (segment, bucket) —
    segments of ``tiles`` queries × ``slots`` probe slots, in the order
    :func:`plan_segments`'s loop runs them — so segment ``j``'s entries are
    one contiguous range and, within it, the entries that probe one bucket
    sit together in ``(q, p)`` order. ``order[e]`` is the flat index of the
    ``e``-th sorted entry. Each run of one bucket is cut into groups of at
    most :data:`V1_GROUP` entries: ``gsize[e]`` is the group's size at its
    first entry and 0 elsewhere. A bucket repeated in one list is two
    entries of its run."""
    nq, p = probes.shape
    n = nq * p
    keys = probes.reshape(-1).to(torch.int64)
    if tiles < nq or slots < p:
        e = torch.arange(n, device=probes.device)
        seg = (e // p // tiles) * -(-p // slots) + e % p // slots
        keys = seg * n_buckets + keys
    keys, order = torch.sort(keys, stable=True)
    return order.to(torch.int32), _probe_groups(keys)


def _probe_groups(keys: torch.Tensor) -> torch.Tensor:
    """``gsize`` (int32) of :func:`invert_probes` from its sorted int64
    keys: the CUDA kernel ``bucket_score_v1_groups`` for a CUDA tensor (a
    binary search for each entry's run start), these plain PyTorch ops for
    a CPU tensor."""
    n = keys.shape[0]
    if on_cuda(keys):
        gsize = torch.empty(n, dtype=torch.int32, device=keys.device)
        status = launch_on(
            keys.device,
            cuda_function("bucket_score", "bucket_score_v1_groups", 2, 1),
            keys.data_ptr(), gsize.data_ptr(), n)
        check_status("bucket_score (groups)", status)
        return gsize
    e = torch.arange(n)
    start = torch.searchsorted(keys, keys)
    end = torch.searchsorted(keys, keys, right=True)
    return torch.where((e - start) % V1_GROUP == 0,
                       torch.clamp(end - e, max=V1_GROUP), 0).to(torch.int32)


def bucket_score(
    queries: torch.Tensor,        # (nq, D) fp32
    bucket_data: torch.Tensor,    # (K, B, D) bucket-major, fp32/bf16/int8
    bucket_ids: torch.Tensor,     # (K, B) int32, -1 padding
    probes: torch.Tensor,         # (nq, P) int32 bucket ids in [0, K)
    *,
    k: int,
    exclude: torch.Tensor | None = None,
):
    """v1 per-query cluster-prune scoring: ``(scores (nq, k), ids (nq, k))``.

    Query ``q`` scores buckets ``probes[q, 0..P)`` in order against its fp32
    row (a bf16 or int8 pack is widened, the query is not rounded, and an
    int8 pack takes no scale: the v1 kernel has no scales operand, so its
    scores are ``q · float(int8 row)``, as the reference's), masking
    padding, ``exclude[q]`` and ids already in its running top-k; ``k_pad =
    min(pad8(k), B·P)`` as in the reference.
    """
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
    if probes.dim() != 2 or probes.shape[0] != nq or probes.shape[1] < 1:
        raise ValueError(f"probes must be ({nq}, P >= 1), got "
                         f"{tuple(probes.shape)}")
    if exclude is not None and tuple(exclude.shape) != (nq,):
        raise ValueError(f"exclude must be ({nq},), got "
                         f"{tuple(exclude.shape)}")
    if not on_cuda(queries, bucket_data, bucket_ids, probes, exclude):
        return bucket_score_ref(queries, bucket_data, bucket_ids, probes,
                                k=k, exclude=exclude)
    call = V1Call(queries, bucket_data, bucket_ids, probes, k=k,
                  exclude=exclude)
    call.invert()
    for seg in call.segments:
        call.score(seg)
        call.merge(seg)
    count_launch(bucket_score)
    return call.result()


bucket_score.launches = 0


class V1Call:
    """One :func:`bucket_score` call on the card, phase by phase:
    ``invert()``, then for each ``seg`` of ``segments`` (``(t0, queries,
    s0, slots, e0)``: query groups in order and, within one, probe-slot
    segments in order; ``e0`` is the segment's first sorted entry)
    ``score(seg)`` then ``merge(seg)``; then ``result()``. The wrapper runs
    exactly that; the pieces are public so a timing tool can put events
    between them. Holds every tensor the launches read until it is
    dropped."""

    def __init__(self, queries, bucket_data, bucket_ids, probes, *, k: int,
                 exclude=None):
        self.dev = queries.device
        self.nq, self.d = queries.shape
        self.n_buckets, self.b, _ = bucket_data.shape
        self.p = probes.shape[1]
        self.k = k
        self.k_pad = min(pad_to(k, 8), self.b * self.p)
        if exclude is None:
            exclude = torch.full((self.nq,), -1, dtype=torch.int32,
                                 device=self.dev)
        self.q = queries.contiguous()
        self.data = bucket_data.contiguous()
        self.ids = bucket_ids.to(torch.int32).contiguous()
        self.probes = probes.to(torch.int32).contiguous()
        self.ex = exclude.to(torch.int32).contiguous()
        self.tiles, self.slots = plan_segments(self.nq, self.p, 1, self.b)
        self.segments, e0 = [], 0
        for t0 in range(0, self.nq, self.tiles):
            for s0 in range(0, self.p, self.slots):
                nt = min(self.tiles, self.nq - t0)
                ns = min(self.slots, self.p - s0)
                self.segments.append((t0, nt, s0, ns, e0))
                e0 += nt * ns
        f32 = dict(dtype=torch.float32, device=self.dev)
        per = self.tiles * self.slots
        self.scores = torch.empty(per * self.b, **f32)
        self.bmax = torch.empty(per * -(-self.b // _RB), **f32)
        self.out_s = torch.empty((self.nq, self.k_pad), **f32)
        self.out_i = torch.empty((self.nq, self.k_pad), dtype=torch.int32,
                                 device=self.dev)
        # the merge keeps a query's list and its snapshot in shared memory
        # (12 bytes an entry) when they fit, else in global memory
        self.snap = (None if 12 * self.k_pad <= SMEM_BYTES_PER_BLOCK else
                     torch.empty((self.nq, self.k_pad), dtype=torch.int32,
                                 device=self.dev))

    def invert(self):
        self.order, self.gsize = invert_probes(
            self.probes, self.n_buckets, tiles=self.tiles, slots=self.slots)

    def score(self, seg):
        t0, nt, s0, ns, e0 = seg
        status = launch_on(
            self.dev,
            cuda_function("bucket_score", "bucket_score_v1_score", 9, 9),
            self.q.data_ptr(), self.data.data_ptr(), self.ids.data_ptr(),
            self.probes.data_ptr(), self.ex.data_ptr(),
            self.order.data_ptr(), self.gsize.data_ptr(),
            self.scores.data_ptr(), self.bmax.data_ptr(),
            e0, nt * ns, self.p, t0, s0, ns, self.b, self.d,
            _DTYPE_CODES[self.data.dtype])
        check_status("bucket_score (scoring)", status)

    def merge(self, seg):
        t0, nt, s0, ns, _ = seg
        status = launch_on(
            self.dev,
            cuda_function("bucket_score", "bucket_score_v1_merge", 8, 8),
            self.scores.data_ptr(), self.bmax.data_ptr(), self.ids.data_ptr(),
            self.probes.data_ptr(), self.ex.data_ptr(),
            self.out_s.data_ptr(), self.out_i.data_ptr(),
            None if self.snap is None else self.snap.data_ptr(),
            t0, nt, self.p, s0, ns, self.b, self.k_pad, int(s0 == 0))
        check_status("bucket_score (merge)", status)

    def result(self):
        """``(scores (nq, k), ids (nq, k))`` from the output lists."""
        return self.out_s[:, :self.k], self.out_i[:, :self.k]


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
