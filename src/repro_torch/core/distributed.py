"""Doc-sharded substrate of the **sharded** search backend (port of
:mod:`repro.core.distributed`).

The reference runs these functions from one controller as ``shard_map``
bodies over a JAX mesh. The port's counterpart is one process driving a
list of devices: shard ``s`` lives on ``devices[s % len(devices)]``, the
per-shard work is a loop over the shards (each launch on the calling
thread's current stream of that shard's device), and the reference's
collectives become copies to one device: the ``all_gather`` of the
per-shard top-k lists is a stack on the output device, the ``pmax``
all-reduce of the rescore tail a MAX over the stacked score matrices.
Several shards may share one device; on one card each shard's scoring is
still the real kernel at the shard-local shape.

Layout, as the reference's:

* **docs** are row-sharded: every shard owns ``n_local = ceil(n / S)``
  contiguous rows (:func:`shard_rows`); the last shards pad with zero
  sentinel rows that no bucket references, so any corpus size shards.
* **leaders** are global: navigation runs once, and the probe lists (and
  the probe-dedup schedule) are the same on every shard.
* **buckets** are local: each shard packs its own slice of every cluster
  (:func:`build_local_buckets`), bucket-major in ``(S, T·K, B_l, D)``
  (:func:`pack_local_bucket_major`; fp32, bf16, or int8 with
  per-``(shard, bucket)`` scales), so a probe touches every shard's slice
  of the probed cluster and the shards' work is balanced.
* the top-k merge of the per-shard lists is the only cross-shard step
  (:func:`merge_topk`: a stable sort, so a tie goes to the lower shard,
  as ``lax.top_k`` over the gathered lists does).

On a CUDA tensor :func:`distributed_bucket_score` runs the
``bucket_score_tiled`` CUDA kernel on each shard and
:func:`distributed_brute_topk` the ``topk_score`` CUDA kernel; there is no
fallback to their plain versions. :func:`distributed_index_search` (the
gather oracle with the JL prefilter) and :func:`distributed_exact_rescore`
are plain PyTorch, as in the reference.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .engine import navigate, stable_topk

__all__ = [
    "local_topk",
    "merge_topk",
    "distributed_brute_topk",
    "distributed_index_search",
    "distributed_bucket_score",
    "distributed_exact_rescore",
    "build_local_buckets",
    "local_exclude",
    "make_projection",
    "pack_local_bucket_major",
    "shard_devices",
    "shard_docs",
    "shard_rows",
]


def shard_rows(n: int, n_shards: int) -> int:
    """Rows per shard for an ``n``-row corpus: ``ceil(n / n_shards)``.

    The padded total ``n_local · n_shards`` is what the shards hold; the
    pad rows are sentinels no bucket references, so they are never scored
    and never appear in ``n_scored``.
    """
    return -(-int(n) // int(n_shards))


def shard_devices(devices: Sequence, n_shards: int) -> list[torch.device]:
    """The device of each shard: shard ``s`` on ``devices[s % len]``."""
    devs = [torch.device(d) for d in devices]
    return [devs[s % len(devs)] for s in range(int(n_shards))]


def shard_docs(docs: torch.Tensor, n_shards: int,
               devices: Sequence | None = None) -> list[torch.Tensor]:
    """Row blocks of a ``(n, D)`` corpus, one ``(n_local, D)`` block per
    shard on its device (``devices`` defaults to the corpus's own).

    A block that lies wholly inside the corpus on the corpus's device is a
    view, not a copy; a block that reaches past row ``n`` is padded with
    zero sentinel rows (only the last shards: ids past the true corpus
    never enter any bucket).
    """
    n = int(docs.shape[0])
    n_local = shard_rows(n, n_shards)
    devs = shard_devices(devices or (docs.device,), n_shards)
    out = []
    for s, dev in enumerate(devs):
        lo, hi = min(s * n_local, n), min((s + 1) * n_local, n)
        block = docs[lo:hi]
        if hi - lo < n_local:
            block = F.pad(block, (0, 0, 0, n_local - (hi - lo)))
        out.append(block.to(dev))
    return out


def local_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of a local score set; ids carried along. (..., m) -> (..., k);
    ties to the lower position (``lax.top_k``'s rule)."""
    top_s, pos = stable_topk(scores, k)
    return top_s, torch.gather(ids, -1, pos)


def merge_topk(s_parts: torch.Tensor, i_parts: torch.Tensor, k: int):
    """Merge gathered per-shard top-k blocks ``(..., shards, k)`` ->
    (..., k); an equal score goes to the lower shard."""
    flat_s = s_parts.reshape(*s_parts.shape[:-2], -1)
    flat_i = i_parts.reshape(*i_parts.shape[:-2], -1)
    return local_topk(flat_s, flat_i, k)


def local_exclude(exclude: torch.Tensor, offset: int,
                  n_local: int) -> torch.Tensor:
    """Global -> local exclusion: only the shard that owns the excluded id
    masks it; every other shard gets the no-op ``-1``."""
    loc = exclude.to(torch.int32) - int(offset)
    return torch.where((loc >= 0) & (loc < n_local), loc,
                       -1).to(torch.int32)


def _gather(parts, dev):
    """Stack per-shard ``(nq, c)`` results on ``dev`` -> ``(nq, S, c)``."""
    return torch.stack([p.to(dev) for p in parts], dim=1)


def distributed_brute_topk(
    shards: Sequence[torch.Tensor],   # per-shard (n_local, D) blocks
    qw: torch.Tensor,                 # (nq, D) queries
    *,
    k: int,
    exclude: torch.Tensor | None = None,
    n_valid: int | None = None,
):
    """Exact doc-sharded top-k: each shard runs the ``topk_score`` kernel
    (its plain version on the CPU) over its block, the lists are gathered
    and merged. ``shards`` are :func:`shard_docs` blocks; ``n_valid`` is
    the true corpus length (default: every row), rows at or past it are
    dropped by each shard's ``mask``. Returns ``(scores (nq, k), ids (nq,
    k))`` on ``qw``'s device, ``-inf`` / ``-1`` past the eligible rows."""
    from ..kernels.topk_score import topk_score

    n_local = int(shards[0].shape[0])
    if n_valid is None:
        n_valid = n_local * len(shards)
    nq = qw.shape[0]
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=qw.device)
    s_parts, i_parts = [], []
    for s, block in enumerate(shards):
        dev = block.device
        offset = s * n_local
        mask = None
        if offset + n_local > n_valid:        # sentinel pad rows
            mask = torch.arange(n_local, device=dev) + offset < n_valid
        sc, ids = topk_score(qw.to(dev), block, k=k,
                             exclude=local_exclude(exclude.to(dev), offset,
                                                   n_local),
                             mask=mask)
        s_parts.append(sc)
        i_parts.append(torch.where(ids >= 0, ids + offset, -1))
    top_s, top_i = merge_topk(_gather(s_parts, qw.device),
                              _gather(i_parts, qw.device), k)
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1)


def make_projection(d: int, proj_dim: int,
                    generator: torch.Generator | None = None):
    """Random JL projection ``R (D, pd)`` for two-stage scoring, on the
    CPU (``generator`` defaults to seed 42). torch cannot replay
    ``jax.random.normal``, so a test that compares the two packages
    injects one projection into both."""
    if generator is None:
        generator = torch.Generator().manual_seed(42)
    return torch.randn((d, proj_dim), generator=generator) * proj_dim ** -0.5


def distributed_index_search(
    shards: Sequence[torch.Tensor],   # per-shard (n_local, D) blocks
    leaders: torch.Tensor,            # (T, K, D)
    buckets_local,                    # (S, T, K, B_l) LOCAL ids, sentinel n_l
    qw: torch.Tensor,                 # (nq, D) weighted queries
    *,
    probes_t: tuple[int, ...],
    k: int,
    exclude: torch.Tensor | None = None,
    docs_proj: Sequence[torch.Tensor] | None = None,  # per-shard (n_l, pd)
    qw_proj: torch.Tensor | None = None,              # (nq, pd)
    shortlist: int = 64,
    nav: torch.Tensor | None = None,                  # (nq, D)
):
    """Doc-sharded cluster-prune search by gathering candidate rows (the
    plain oracle for :func:`distributed_bucket_score`).

    ``buckets_local[s]`` packs shard ``s``'s members of every (clustering,
    cluster) pair with sentinel ``n_local`` (:func:`build_local_buckets`).
    Navigation runs once on the global leaders (``nav`` navigates in place
    of ``qw`` when given); each shard scores its candidates, drops
    duplicates across clusterings, keeps its top-k; the lists are merged.

    Two-stage scoring (beyond the paper): with ``docs_proj`` / ``qw_proj``
    (the corpus's shards and the queries under one JL projection,
    :func:`make_projection`), each shard first scores its candidates in the
    projected space and only its top ``shortlist`` are scored at full D.
    Returns ``(scores (nq, k), ids (nq, k))`` on ``qw``'s device.
    """
    nq = qw.shape[0]
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=qw.device)
    if nav is None:
        nav = qw
    bl = torch.as_tensor(np.asarray(buckets_local) if not isinstance(
        buckets_local, torch.Tensor) else buckets_local)
    n_shards, t_cl, k_clusters, b_l = (int(x) for x in bl.shape)
    n_local = int(shards[0].shape[0])
    flat = navigate(leaders, nav, probes_t)                # (nq, P)
    neg = float("-inf")
    s_parts, i_parts = [], []
    for s, docs_l in enumerate(shards):
        dev = docs_l.device
        offset = s * n_local
        bkt = bl[s].to(dev).reshape(t_cl * k_clusters, b_l)
        cand = bkt[flat.to(dev).long()].reshape(nq, -1)    # (nq, m) local
        valid = cand < n_local
        if docs_proj is not None:
            safe = torch.where(valid, cand, 0).long()
            s1 = torch.einsum("qmp,qp->qm", docs_proj[s][safe],
                              qw_proj.to(dev))
            s1 = torch.where(valid, s1, neg)
            _, keep = stable_topk(s1, min(shortlist, s1.shape[-1]))
            cand = torch.gather(cand, -1, keep)
            valid = torch.gather(valid, -1, keep)
        safe = torch.where(valid, cand, 0).long()
        sc = torch.einsum("qmd,qd->qm", docs_l[safe], qw.to(dev))
        gids = torch.where(valid, cand + offset, -1)
        sc = torch.where(valid, sc, neg)
        sc = torch.where(gids == exclude.to(dev)[:, None], neg, sc)
        # local dedup across overlapping clusterings
        c_s, order = torch.sort(cand, dim=-1, stable=True)
        s_s = torch.gather(sc, -1, order)
        g_s = torch.gather(gids, -1, order)
        dup = c_s == F.pad(c_s[:, :-1], (1, 0), value=-1)
        s_s = torch.where(dup, neg, s_s)
        top_s, top_i = local_topk(s_s, g_s, k)
        s_parts.append(top_s)
        i_parts.append(top_i)
    return merge_topk(_gather(s_parts, qw.device),
                      _gather(i_parts, qw.device), k)


def distributed_bucket_score(
    data,                    # (S, T·K, B_l, D) or per-shard (T·K, B_l, D)
    ids,                     # (S, T·K, B_l) LOCAL ids, -1 padding
    scales,                  # (S, T·K) fp32 int8 scales, or None
    qw: torch.Tensor,        # (nq, D) scoring queries
    schedule: torch.Tensor,  # (n_tiles, S_len) probe-dedup schedule
    member: torch.Tensor,    # (n_tiles, S_len, QT) membership
    *,
    k: int,
    n_local: int,
    exclude: torch.Tensor | None = None,
):
    """The fused path run shard-locally: each shard calls
    :func:`~repro_torch.kernels.bucket_score.ops.bucket_score_tiled` (the
    CUDA kernel on the card, its plain version on the CPU) over its slice
    ``data[s]`` of every scheduled bucket, with the shared schedule and
    membership and its local exclusion; local ids become global; the
    per-shard lists are gathered and merged.

    ``data``, ``ids`` and ``scales`` are indexed by shard: a stacked
    tensor (every shard on one device) or a sequence of per-shard tensors
    on their devices. A shard's candidates are exactly its slice of the
    global candidate set, so the merged top-k equals the single-device
    fused answer on an fp32 pack. Returns ``(scores (nq, k'), ids (nq,
    k'))`` on ``qw``'s device with ``k' = min(k, S · cols)``, ``cols`` the
    columns one shard's call returns (its ``k_pad`` clip).
    """
    from ..kernels.bucket_score import bucket_score_tiled
    from ..kernels.common import pad_to

    n_shards = len(data)
    nq = qw.shape[0]
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=qw.device)
    b_l = int(data[0].shape[1])
    cols = min(pad_to(k, 8), b_l * int(schedule.shape[1]), k)
    k_out = min(k, n_shards * cols)
    s_parts, i_parts = [], []
    for s in range(n_shards):
        dev = data[s].device
        offset = s * n_local
        sc, li = bucket_score_tiled(
            qw.to(dev), data[s], ids[s], schedule.to(dev), member.to(dev),
            k=k, exclude=local_exclude(exclude.to(dev), offset, n_local),
            scales=None if scales is None else scales[s])
        s_parts.append(sc)
        i_parts.append(torch.where(li >= 0, li + offset, -1))
    return merge_topk(_gather(s_parts, qw.device),
                      _gather(i_parts, qw.device), k_out)


def distributed_exact_rescore(
    shards: Sequence[torch.Tensor],   # per-shard (n_local, D) fp32 blocks
    qw: torch.Tensor,                 # (nq, D) queries
    ids: torch.Tensor,                # (nq, R) candidate ids, -1 fillers
    *,
    k: int,
    n_local: int,
):
    """Sharded exact-rescore tail: fp32 re-rank without gathering the
    corpus. Each shard scores only the candidates it owns (everything else
    is ``-inf``); every candidate is owned by exactly one shard, so the
    MAX over the stacked ``(S, nq, R)`` score matrices is the exact score
    (the reference's ``pmax``); a stable top-k makes the cut. Returns
    ``(scores (nq, k), ids (nq, k), n_rescored (nq,))``, the contract of
    :func:`repro_torch.core.engine._exact_rescore`."""
    neg = float("-inf")
    parts = []
    for s, docs_l in enumerate(shards):
        dev = docs_l.device
        ids_l = ids.to(dev)
        loc = ids_l - s * n_local
        owned = (ids_l >= 0) & (loc >= 0) & (loc < n_local)
        safe = torch.where(owned, loc, 0).long()
        sc = torch.einsum("qrd,qd->qr", docs_l[safe], qw.to(dev))
        parts.append(torch.where(owned, sc, neg).to(qw.device))
    s = torch.stack(parts).amax(dim=0)
    top_s, pos = stable_topk(s, k)
    top_i = torch.gather(ids, -1, pos)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return top_s, top_i, (ids >= 0).sum(dim=-1).to(torch.int32)


def build_local_buckets(assign_global, n, n_shards, k_clusters):
    """Host numpy: split global assignments into per-shard local bucket
    packs.

    ``assign_global`` is ``(T, n)`` (entries < 0 — removed or pad docs —
    are skipped); ``n`` must be divisible by ``n_shards`` (pad the
    assignment with ``-1`` columns first). Returns ``(S, T, K, B_l)``
    int32 ids, LOCAL row ids with sentinel ``n_local``; ``B_l`` is the
    largest local bucket over every shard, padded to 8.
    """
    from .index import pack_buckets

    assign_global = np.atleast_2d(np.asarray(assign_global))
    t_clusterings = assign_global.shape[0]
    if n % n_shards:
        raise ValueError(
            f"build_local_buckets needs n ({n}) divisible by n_shards "
            f"({n_shards}); pad the assignment with -1 columns first"
        )
    n_local = n // n_shards
    packs = [[None] * t_clusterings for _ in range(n_shards)]
    b_max = 8
    for s in range(n_shards):
        for t in range(t_clusterings):
            a = assign_global[t, s * n_local:(s + 1) * n_local]
            ids, _ = pack_buckets(a, k_clusters, n_local)
            packs[s][t] = ids
            b_max = max(b_max, ids.shape[1])
    out = np.full((n_shards, t_clusterings, k_clusters, b_max), n_local,
                  np.int32)
    for s in range(n_shards):
        for t in range(t_clusterings):
            p = packs[s][t]
            out[s, t, :, :p.shape[1]] = p
    return out


def pack_local_bucket_major(docs: torch.Tensor, assign, k_clusters: int,
                            n_shards: int, *, dtype=None):
    """Shard-local bucket-major pack: the fused layout, one slice per
    shard, on ``docs``'s device.

    - ``data (S, T·K, B_l, D)``: shard ``s``'s members of every bucket as
      contiguous blocks, in ``dtype`` (None / ``"float32"``,
      ``"bfloat16"``, or ``"int8"``, quantised per ``(shard, bucket)``:
      each shard's absmax over its own slice); a padded slot holds the
      shard's first row, as the reference's gather does;
    - ``ids (S, T·K, B_l)`` int32: LOCAL row ids, ``-1`` padding;
    - ``scales (S, T·K)`` fp32 for int8, else None;
    - ``n_local``: rows per shard (:func:`shard_rows`).

    ``B_l`` is the largest local bucket over every shard, padded to 8. The
    gather runs a chunk of buckets at a time
    (:func:`~repro_torch.kernels.bucket_score.ops.pack_bucket_major`), so a
    quantised pack never holds the whole fp32 pack on the card.
    """
    from ..kernels.bucket_score.ops import pack_bucket_major
    from .index import _TORCH_DTYPES, validate_pack_dtype

    name = validate_pack_dtype(dtype)
    assign = np.atleast_2d(np.asarray(assign))
    t_cl, n = assign.shape
    n_local = shard_rows(n, n_shards)
    n_pad = n_local * n_shards
    a_pad = np.pad(assign, ((0, 0), (0, n_pad - n)), constant_values=-1)
    bl = build_local_buckets(a_pad, n_pad, n_shards, k_clusters)
    b_l = bl.shape[-1]
    dev = docs.device
    bk = torch.as_tensor(bl.reshape(n_shards, t_cl * k_clusters, b_l),
                         device=dev)
    ids = torch.where(bk < n_local, bk, -1).to(torch.int32)
    offsets = torch.arange(n_shards, device=dev)[:, None, None] * n_local
    rows = torch.where(ids >= 0, ids, 0) + offsets        # global rows
    # a shard wholly past the corpus gathers its first (sentinel) row
    src = (docs if (n_shards - 1) * n_local < n
           else F.pad(docs, (0, 0, 0, n_pad - n)))
    data, _, scales = pack_bucket_major(
        src, rows, dtype=None if name is None else _TORCH_DTYPES[name])
    return data, ids, scales, n_local
