"""Output-quality metrics of the paper (§6) and brute-force ground truth
(port of :mod:`repro.core.metrics`).

* Competitive recall ``CR = |A ∩ GT|`` in ``[0, k]``.
* Normalized aggregate goodness ``NAG ∈ [0, 1]``: the returned set's
  aggregate distance, normalised between the true k-NN (1) and the k
  farthest points (0).

Ground truth streams over document chunks with a plain fp32 matmul and a
stable top-k merge (ties to the lower doc id, as ``lax.top_k`` over the
reference's ``[best, chunk]`` concatenation), so the ``(nq, n)`` score
matrix never materialises.
"""

from __future__ import annotations

import torch

__all__ = [
    "brute_force_topk",
    "brute_force_bottomk",
    "competitive_recall",
    "recall_fraction",
    "normalized_aggregate_goodness",
    "quality_report",
]


def _exhaustive_topk(docs, qw, exclude, mask, *, k, largest, chunk):
    n = docs.shape[0]
    nq = qw.shape[0]
    dev = docs.device
    sign = 1.0 if largest else -1.0
    best_s = torch.full((nq, k), float("-inf"), dtype=qw.dtype, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    neg = torch.tensor(float("-inf"), dtype=qw.dtype, device=dev)
    for start in range(0, n, chunk):
        block = docs[start:start + chunk]
        ids = torch.arange(start, start + block.shape[0], dtype=torch.int32,
                           device=dev)
        s = sign * (qw @ block.T)
        s = torch.where(mask[start:start + chunk][None, :], s, neg)
        s = torch.where(ids[None, :] == exclude[:, None], neg, s)
        cat_s = torch.cat([best_s, s], dim=-1)
        cat_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=-1)
        top_s, pos = torch.sort(cat_s, dim=-1, descending=True, stable=True)
        best_s = top_s[:, :k]
        best_i = torch.gather(cat_i, -1, pos[:, :k])
    return sign * best_s, best_i


def _prepare(docs, qw, exclude, mask):
    qw = torch.atleast_2d(torch.as_tensor(qw, device=docs.device))
    nq = qw.shape[0]
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=docs.device)
    exclude = torch.as_tensor(exclude, device=docs.device).to(torch.int32)
    if mask is None:
        mask = torch.ones((docs.shape[0],), dtype=torch.bool,
                          device=docs.device)
    mask = torch.as_tensor(mask, device=docs.device).to(torch.bool)
    return qw, exclude, mask


def brute_force_topk(docs, qw, k, *, exclude=None, mask=None,
                     chunk: int = 8192):
    """Exact k-NN ground truth ``GT(k, q, E)``: ``(sims (nq,k), ids (nq,k))``.
    ``mask`` (``(n,)`` bool) keeps False rows out of the answer."""
    qw, exclude, mask = _prepare(docs, qw, exclude, mask)
    return _exhaustive_topk(docs, qw, exclude, mask, k=k, largest=True,
                            chunk=chunk)


def brute_force_bottomk(docs, qw, k, *, exclude=None, mask=None,
                        chunk: int = 8192):
    """The farthest set ``FS(k, q, E)`` (the NAG normaliser)."""
    qw, exclude, mask = _prepare(docs, qw, exclude, mask)
    return _exhaustive_topk(docs, qw, exclude, mask, k=k, largest=False,
                            chunk=chunk)


def competitive_recall(ret_ids: torch.Tensor, gt_ids: torch.Tensor):
    """``CR = |A ∩ GT|`` per query; inputs ``(nq, k)``; invalid ids are -1."""
    hit = (ret_ids[..., :, None] == gt_ids[..., None, :]) & (
        ret_ids[..., :, None] >= 0
    )
    return hit.any(dim=-1).sum(dim=-1).to(torch.float32)


def recall_fraction(ret_ids: torch.Tensor, gt_ids: torch.Tensor):
    """``CR/k`` in ``[0, 1]`` per query."""
    return competitive_recall(ret_ids, gt_ids) / gt_ids.shape[-1]


def normalized_aggregate_goodness(ret_sims, gt_sims, far_sims):
    """NAG per query on distances ``mu = 1 - sim``:
    ``(W - sum_A mu) / (W - sum_GT mu)`` with ``W = sum_FS mu``; missing
    retrieved slots (sim -inf) score the farthest-set mean."""
    far_mu = 1.0 - far_sims
    w = far_mu.sum(dim=-1)
    fill = far_mu.mean(dim=-1, keepdim=True)
    ret_mu = torch.where(torch.isfinite(ret_sims), 1.0 - ret_sims, fill)
    gt_mu = 1.0 - gt_sims
    num = w - ret_mu.sum(dim=-1)
    den = w - gt_mu.sum(dim=-1)
    return torch.where(den > 1e-9, num / den, torch.ones_like(num))


def quality_report(ret_sims, ret_ids, gt_sims, gt_ids, far_sims):
    """Mean CR and mean NAG over a query set (the paper's Table-2 cells)."""
    cr = competitive_recall(ret_ids, gt_ids)
    nag = normalized_aggregate_goodness(ret_sims, gt_sims, far_sims)
    return {
        "mean_recall": float(cr.mean()),
        "mean_nag": float(nag.mean()),
    }
