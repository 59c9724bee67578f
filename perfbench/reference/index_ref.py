"""Plain PyTorch checks of a cluster-pruned index against its inputs.

The index is the program's; these functions work out again, from the
corpus and the draws the benchmark handed to the program, what each stage
of the build had to produce, and measure how far the program's output
lies from it:

* FPF (furthest point first, Gonzalez): each round's centre has to be a
  sample row whose largest similarity to the centres before it is the
  least over the sample. The program's rounds add their fp32 sums in
  another order than a plain matmul does, so near-ties may pick another
  row: the check follows the program's own centres round by round and
  reads how far each chosen row lies above that round's least
  (:func:`fpf_round_gaps`). A wrong centre reads as far as the data's
  spacing; the first centre is the draw itself, compared exactly.
* Assignment: every row to its most similar leader (:func:`assign_gap`).
* Medoid adjustment: each cluster's leader is the member most similar to
  the cluster's normalised centroid, under the assignment to the FPF
  centres (:func:`medoid_gap`); rows whose two best centres lie within
  ``eps`` of each other may sit in either cluster, and the check takes
  the kinder of those memberships.
* Buckets, counts and the bucket-major pack are exact functions of the
  assignment and the corpus (:func:`bucket_mismatches`,
  :func:`pack_mismatches`).

All matmuls run in fp32 with TF32 off, in row blocks so that they fit
beside the program's state.
"""

from __future__ import annotations

import contextlib
import itertools

import torch

__all__ = ["exact_fp32", "fpf_round_gaps", "assign_top2", "assign_gap",
           "medoid_gap", "reference_buckets", "bucket_mismatches",
           "pack_mismatches"]

_BLOCK = 8192


@contextlib.contextmanager
def exact_fp32():
    """fp32 matmuls in full fp32 (TF32 off) for the block, whatever the
    process had set."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fpf_round_gaps(x: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """``x (m, D)`` the FPF sample, ``centres (K,)`` the program's centres
    as rows of it, in round order. Returns ``(K - 1,)``: for round ``i``,
    the chosen row's largest similarity to centres ``0 .. i-1`` minus the
    least such value over the sample (0 where the choice is the least)."""
    with exact_fp32():
        x = x.float()
        c = x[centres.long()]
        k = c.shape[0]
        least = torch.full((k,), float("inf"), device=x.device)
        for lo in range(0, x.shape[0], _BLOCK):
            s = x[lo:lo + _BLOCK] @ c.T
            least = torch.minimum(least, torch.cummax(s, dim=1).values
                                  .amin(dim=0))
        chosen = torch.empty((k,), device=x.device)
        rows = torch.arange(k, device=x.device)
        for lo in range(0, k, _BLOCK):
            g = c[lo:lo + _BLOCK] @ c.T
            g = g.masked_fill(rows[None, :] >= rows[lo:lo + _BLOCK, None],
                              float("-inf"))
            chosen[lo:lo + _BLOCK] = g.amax(dim=1)
        return chosen[1:] - least[:-1]


def assign_top2(x: torch.Tensor, reps: torch.Tensor):
    """Every row's best and second-best representative and the margin
    between their similarities: ``(best (n,), second (n,), margin (n,))``."""
    with exact_fp32():
        best, second, margin = [], [], []
        for lo in range(0, x.shape[0], _BLOCK):
            s = x[lo:lo + _BLOCK].float() @ reps.float().T
            v, i = torch.topk(s, min(2, s.shape[1]), dim=1)
            best.append(i[:, 0])
            second.append(i[:, -1])
            margin.append(v[:, 0] - v[:, -1] if v.shape[1] > 1
                          else torch.full_like(v[:, 0], float("inf")))
        return torch.cat(best), torch.cat(second), torch.cat(margin)


def assign_gap(x: torch.Tensor, reps: torch.Tensor,
               assign: torch.Tensor) -> float:
    """The widest gap by which a row's assigned representative lies below
    its most similar one (``assign`` outside ``[0, K)`` reads ``inf``)."""
    k = reps.shape[0]
    assign = assign.to(x.device).long()
    if bool(((assign < 0) | (assign >= k)).any()):
        return float("inf")
    worst = 0.0
    with exact_fp32():
        for lo in range(0, x.shape[0], _BLOCK):
            s = x[lo:lo + _BLOCK].float() @ reps.float().T
            got = s.gather(1, assign[lo:lo + _BLOCK, None])[:, 0]
            worst = max(worst, float((s.amax(dim=1) - got).max()))
    return worst


def _cluster_sums(x, assign, k):
    """``(k, D)`` fp32 sum of each cluster's rows, by a one-hot matmul in
    row blocks (no atomics, so the same on every run)."""
    sums = torch.zeros((k, x.shape[1]), device=x.device)
    for lo in range(0, x.shape[0], _BLOCK):
        a = assign[lo:lo + _BLOCK]
        onehot = torch.zeros((k, a.numel()), device=x.device)
        onehot[a, torch.arange(a.numel(), device=x.device)] = 1.0
        sums += onehot @ x[lo:lo + _BLOCK].float()
    return sums


def medoid_gap(x: torch.Tensor, reps0: torch.Tensor, leaders: torch.Tensor,
               *, eps: float, max_ambiguous: int = 4):
    """Hold the program's adjusted leaders to the medoid rule.

    ``reps0 (K, D)``: the FPF centres' rows; ``leaders (K, D)``: the
    program's leaders after the adjustment. Returns ``(gap, not_member)``:
    the widest gap over clusters between the best member's similarity to
    the cluster's normalised centroid and the leader's, and the number of
    leaders that are not a member row of their cluster (an empty cluster's
    leader is row ``n - 1``). Rows within ``eps`` of their two best
    centres may sit in either cluster: each cluster they touch takes the
    least gap over its memberships (up to ``max_ambiguous`` such rows a
    cluster, the closest ones)."""
    n, k = x.shape[0], reps0.shape[0]
    with exact_fp32():
        best, second, margin = assign_top2(x, reps0)
        counts = torch.bincount(best, minlength=k)
        sums = _cluster_sums(x, best, k)
        cent = sums / torch.linalg.vector_norm(
            sums, dim=1, keepdim=True).clamp(min=1e-12)
        score = torch.empty((n,), device=x.device)
        for lo in range(0, n, _BLOCK):
            score[lo:lo + _BLOCK] = (x[lo:lo + _BLOCK].float()
                                     * cent[best[lo:lo + _BLOCK]]).sum(1)
        top = torch.full((k,), float("-inf"), device=x.device)
        top = top.scatter_reduce(0, best, score, "amax")
        lead = (leaders.float() * cent).sum(1)
        gap = top - lead
        member = torch.zeros((k,), dtype=torch.bool, device=x.device)
        for lo in range(0, n, _BLOCK):
            b = best[lo:lo + _BLOCK]
            eq = (x[lo:lo + _BLOCK] == leaders[b]).all(1)
            member[b[eq]] = True
        amb = torch.nonzero(margin < eps).flatten()
        if amb.numel():
            s2 = second[amb]
            eq = (x[amb] == leaders[s2]).all(1)
            member[s2[eq]] = True
        empty = counts == 0
        last_row = (leaders == x[n - 1]).all(1)
        member = torch.where(empty, last_row, member)
        gap = torch.where(empty, torch.zeros_like(gap), gap)
        touched = {}
        for r, m in sorted(zip(amb.tolist(), margin[amb].tolist()),
                           key=lambda p: p[1]):
            for c in (int(best[r]), int(second[r])):
                lst = touched.setdefault(c, [])
                if len(lst) < max_ambiguous:
                    lst.append(r)
        for c, rows in touched.items():
            gap[c] = _least_variant_gap(x, best, c, rows, leaders[c])
        return float(gap.max()), int((~member).sum())


def _least_variant_gap(x, best, c, amb_rows, leader) -> float:
    """The least medoid gap of cluster ``c`` over every membership of its
    ambiguous rows (each in or out of ``c``)."""
    base = torch.nonzero(best == c).flatten()
    amb = torch.as_tensor(amb_rows, device=x.device)
    fixed = base[~torch.isin(base, amb)]
    out = float("inf")
    for keep in itertools.product((False, True), repeat=len(amb_rows)):
        rows = torch.cat([fixed, amb[torch.as_tensor(keep, device=x.device)]])
        if rows.numel() == 0:
            continue
        members = x[rows].float()
        s = members.sum(0)
        cent = s / torch.linalg.vector_norm(s).clamp(min=1e-12)
        out = min(out, float((members @ cent).max() - leader.float() @ cent))
    return out


def reference_buckets(assign: torch.Tensor, k: int, n: int, width: int):
    """``(k, width)`` member ids of each cluster in ascending row order,
    padded with ``n`` and cut at ``width``, and ``(k,)`` member counts
    (before the cut), from ``assign (n,)`` (entries < 0 skipped)."""
    assign = assign.long()
    rows = torch.nonzero(assign >= 0).flatten()
    a = assign[rows]
    counts = torch.bincount(a, minlength=k)
    order = torch.sort(a, stable=True).indices
    start = torch.zeros((k + 1,), dtype=torch.long, device=assign.device)
    start[1:] = torch.cumsum(counts, 0)
    sa = a[order]
    pos = torch.arange(sa.numel(), device=assign.device) - start[sa]
    ids = torch.full((k, width), n, dtype=torch.long, device=assign.device)
    keep = pos < width
    ids[sa[keep], pos[keep]] = rows[order][keep]
    return ids, counts


def bucket_mismatches(assign: torch.Tensor, buckets: torch.Tensor,
                      counts: torch.Tensor | None, n: int) -> int:
    """Entries of the program's ``buckets (K, B)`` (and ``counts (K,)``,
    when given) that differ from the ones its assignment defines."""
    k, width = buckets.shape
    ids, cnt = reference_buckets(assign.to(buckets.device), k, n, width)
    bad = int((ids != buckets.long()).sum())
    if counts is not None:
        bad += int((cnt != counts.long()).sum())
        if int(cnt.max()) > width:
            bad += int((cnt - width).clamp(min=0).sum())
    return bad


def pack_mismatches(x: torch.Tensor, data: torch.Tensor, ids: torch.Tensor,
                    buckets: torch.Tensor, n: int) -> int:
    """Rows of the bucket-major pack ``data (T*K, B, D)`` that are not the
    corpus row its bucket names (padding slots hold row 0), plus id entries
    ``ids (T*K, B)`` that are not the buckets' (padding ``-1``)."""
    flat = buckets.reshape(-1, buckets.shape[-1]).long()
    want_ids = torch.where(flat < n, flat, -1)
    bad = int((ids.long() != want_ids).sum())
    safe = torch.where(flat < n, flat, 0)
    for lo in range(0, flat.shape[0], 64):
        blk = data[lo:lo + 64]
        bad += int((blk != x[safe[lo:lo + 64]].to(blk.dtype)).any(-1).sum())
    return bad
