"""Plain PyTorch answers of a weighted similarity search, and the numbers
that hold the program's answers to them.

The §4 reduction: per-field unit queries ``q`` and weights ``w`` give the
plain cosine query ``Q'_w = [w_1 q_1, ..., w_s q_s] / |.|``
(:func:`weighted_query`). Pruned search navigates the leaders (the top
``p_t`` of each clustering ``t``), scores every member of the probed
buckets once (a row probed in two clusterings counts once), drops the
like-document and keeps the ``k`` best.

Navigation picks by fp32 (or bf16) sums that the program adds in another
order, so a leader within ``eps`` of the ``p_t``-th best may or may not be
probed: :func:`probe_sets` returns the leaders that any correct navigation
probes (``certain``) and those that one may (``possible``). The program's
answer then has to name only rows of possible buckets, with the score the
reference gives that row, and its ``j``-th score may not lie below the
``j``-th best of the certain buckets' rows (:func:`judge`).
"""

from __future__ import annotations

import torch

from .index_ref import exact_fp32

__all__ = ["split_probes", "weighted_query", "bf16_ulp", "probe_sets",
           "member_mask", "full_scores", "judge", "probe_work"]


def split_probes(probes: int, t: int) -> tuple[int, ...]:
    """A probe budget over ``t`` clusterings: ``probes // t`` each, the
    first ``probes % t`` one more."""
    base, rem = divmod(probes, t)
    return tuple(base + (1 if i < rem else 0) for i in range(t))


def weighted_query(q: torch.Tensor, w: torch.Tensor, dims) -> torch.Tensor:
    """``(nq, D)`` normalised weighted queries from ``q (nq, D)`` per-field
    unit queries and ``w (nq, s)`` weights."""
    reps = torch.as_tensor(dims, device=q.device)
    qw = q.float() * torch.repeat_interleave(w.float(), reps, dim=1)
    return qw / torch.linalg.vector_norm(qw, dim=1, keepdim=True).clamp(
        min=1e-12)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    a = x.abs().double().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def probe_sets(sims: torch.Tensor, probes_t, eps):
    """``sims (nq, T, K)`` leader similarities -> ``(certain, possible)``
    bool ``(nq, T, K)``: leaders above the ``(p_t + 1)``-th best by more
    than ``eps`` (certain), and leaders no more than ``eps`` below the
    ``p_t``-th best (possible). ``eps`` is a number or a tensor like
    ``sims``."""
    nq, t, k = sims.shape
    certain = torch.zeros_like(sims, dtype=torch.bool)
    possible = torch.zeros_like(sims, dtype=torch.bool)
    eps = torch.as_tensor(eps, dtype=sims.dtype, device=sims.device)
    eps = eps.expand_as(sims) if eps.dim() else eps.expand(sims.shape)
    for c, p in enumerate(probes_t):
        if p == 0:
            continue
        s = sims[:, c, :]
        v = torch.topk(s, min(p + 1, k), dim=1).values
        e = eps[:, c, :]
        possible[:, c, :] = s >= v[:, p - 1:p] - e
        if p < k:
            certain[:, c, :] = s > v[:, p:p + 1] + e
        else:
            certain[:, c, :] = True
    return certain, possible


def member_mask(probed: torch.Tensor, buckets: torch.Tensor,
                n: int) -> torch.Tensor:
    """``(nq, n)`` bool: the rows of the buckets ``buckets (T, K, B)``
    (sentinel ``n``) that ``probed (nq, T, K)`` names."""
    nq = probed.shape[0]
    q, t, c = torch.nonzero(probed, as_tuple=True)
    rows = buckets[t, c].long()                        # (m, B)
    out = torch.zeros((nq, n + 1), dtype=torch.bool, device=probed.device)
    out[q[:, None].expand_as(rows), rows] = True
    return out[:, :n]


def full_scores(qw: torch.Tensor, docs: torch.Tensor,
                block: int = 65536) -> torch.Tensor:
    """``(nq, n)`` fp32 scores of every row, ``docs`` read in row blocks
    and taken to fp32 (bf16 rows exactly)."""
    out = torch.empty((qw.shape[0], docs.shape[0]), device=qw.device)
    with exact_fp32():
        q = qw.float()
        for lo in range(0, docs.shape[0], block):
            out[:, lo:lo + block] = q @ docs[lo:lo + block].float().T
    return out


def judge(scores: torch.Tensor, port_s: torch.Tensor, port_i: torch.Tensor,
          certain: torch.Tensor, possible: torch.Tensor,
          exclude: torch.Tensor, *, ulps: bool = False) -> dict:
    """Hold the program's ``(nq, k)`` answers to the reference's.

    ``scores (nq, n)``: the reference's score of every row (already
    rounded as the program has to round them); ``certain`` / ``possible``
    ``(nq, n)``: the rows every correct navigation scores / any may score;
    ``exclude (nq,)``: the like-documents. Returns:

    * ``bad``: answers that name no row, a row outside the possible
      buckets, the like-document, or a row twice, and rows whose score is
      not finite;
    * ``score_err``: the widest gap between an answer's score and the
      reference's score of the row it names;
    * ``score_off``: the share of answers whose score is not the
      reference's;
    * ``rank_gap``: the widest gap by which the program's ``j``-th score
      lies below the ``j``-th best score of the certain rows.

    With ``ulps`` the two gaps are in units of the bf16 spacing at the
    reference's score, and ``far_scores`` / ``far_ranks`` count the answers
    and positions more than one spacing off: two correct fp32 sums of one
    score differ by far less than a spacing, so their bf16 roundings are
    equal or neighbours."""
    nq, n = scores.shape
    k = port_i.shape[1]
    ids = port_i.long().to(scores.device)
    s = port_s.float().to(scores.device)
    ex = exclude.long().to(scores.device)
    valid = (ids >= 0) & (ids < n)
    safe = torch.where(valid, ids, 0)
    ref_at = scores.gather(1, safe)
    ok = valid & possible.gather(1, safe) & (ids != ex[:, None]) \
        & torch.isfinite(s)
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        k, device=ids.device)), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad = int((~ok).sum()) + int(dup.sum())
    unit = bf16_ulp(ref_at) if ulps else torch.ones_like(ref_at)
    diff = ((s - ref_at).abs().double() / unit)[ok]
    score_err = float(diff.max()) if diff.numel() else 0.0
    score_off = float((diff > 0).double().mean()) if diff.numel() else 0.0
    masked = torch.where(certain, scores, float("-inf"))
    masked[torch.arange(nq, device=ex.device), ex.clamp(min=0)] = torch.where(
        ex >= 0, float("-inf"),
        masked[torch.arange(nq, device=ex.device), ex.clamp(min=0)])
    top = torch.topk(masked, k, dim=1).values
    fin = torch.isfinite(top)
    unit = bf16_ulp(top) if ulps else torch.ones_like(top)
    below = ((top - s).double() / unit)[fin]
    rank_gap = max(0.0, float(below.max())) if below.numel() else 0.0
    out = {"bad": bad, "score_err": score_err, "score_off": score_off,
           "rank_gap": rank_gap}
    if ulps:
        out["far_scores"] = int((diff > 1).sum())
        out["far_ranks"] = int((below > 1).sum())
    return out


def _distinct(x: torch.Tensor, n: int) -> torch.Tensor:
    """Per row of ``x``, the number of distinct values below ``n``."""
    srt = torch.sort(x, dim=1).values
    fresh = torch.ones_like(srt, dtype=torch.bool)
    fresh[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return (fresh & (srt < n)).sum()


def probe_work(qw: torch.Tensor, leaders: torch.Tensor, buckets: torch.Tensor,
               counts: torch.Tensor | None, probes_t, n: int, batch: int):
    """The work pruned search needs for whole batches of ``batch`` queries
    ``qw (nb * batch, D)``, navigating ``leaders (T, K, D)`` in their dtype
    (fp32 with TF32 off) to ``buckets (T, K, W)`` (sentinel ``n``). Returns
    device scalars summed over the batches: the live rows of the distinct
    buckets a batch probes (``counts (T, K)``, the pack rows a kernel over
    the bucket-major pack reads; None skips it), the distinct rows a batch
    probes, and the distinct (query, row) pairs."""
    t_cl, kc = leaders.shape[:2]
    with exact_fp32():
        sims = (qw.to(leaders.dtype) @ leaders.reshape(t_cl * kc, -1).T
                ).reshape(-1, t_cl, kc).float()
    probed = torch.cat([torch.topk(sims[:, t], p, dim=1).indices + t * kc
                        for t, p in enumerate(probes_t) if p], dim=1)
    nb = probed.shape[0] // batch
    pack_rows = None
    if counts is not None:
        pb = torch.sort(probed.reshape(nb, -1), dim=1).values
        fresh = torch.ones_like(pb, dtype=torch.bool)
        fresh[:, 1:] = pb[:, 1:] != pb[:, :-1]
        pack_rows = (counts.reshape(-1).long()[pb] * fresh).sum()
    cand = buckets.reshape(t_cl * kc, -1).long()[probed]
    cand = cand.reshape(probed.shape[0], -1)
    return (pack_rows, _distinct(cand.reshape(nb, -1), n),
            _distinct(cand, n))
