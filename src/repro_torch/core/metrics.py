"""Output-quality metrics of the paper (§6) and brute-force ground truth
(port of :mod:`repro.core.metrics`).

* Competitive recall ``CR = |A ∩ GT|`` in ``[0, k]``.
* Normalized aggregate goodness ``NAG ∈ [0, 1]``: the returned set's
  aggregate distance, normalised between the true k-NN (1) and the k
  farthest points (0).

Ground truth is the ``topk_score`` kernel (CUDA on the card, its plain
streaming version on the CPU): exact fp32 scores, ties to the lower doc id
as ``lax.top_k`` over the reference's ``[best, chunk]`` concatenation, and
the ``(nq, n)`` score matrix never materialises. ``mask=`` and
``exclude=`` are applied inside it. The bottom-k negates the query:
``(-q)·d == -(q·d)`` exactly in fp32, so it is the reference's ``sign * s``.
"""

from __future__ import annotations

import torch

from ..kernels.topk_score import topk_score

__all__ = [
    "brute_force_topk",
    "brute_force_bottomk",
    "competitive_recall",
    "recall_fraction",
    "normalized_aggregate_goodness",
    "quality_report",
]


def _prepare(docs, qw, exclude, mask):
    qw = torch.atleast_2d(torch.as_tensor(qw, device=docs.device))
    if exclude is not None:
        exclude = torch.as_tensor(exclude, device=docs.device).to(torch.int32)
    if mask is not None:
        mask = torch.as_tensor(mask, device=docs.device).to(torch.bool)
    return qw, exclude, mask


def brute_force_topk(docs, qw, k, *, exclude=None, mask=None,
                     chunk: int = 8192):
    """Exact k-NN ground truth ``GT(k, q, E)``: ``(sims (nq,k), ids (nq,k))``.
    ``mask`` (``(n,)`` bool) keeps False rows out of the answer."""
    qw, exclude, mask = _prepare(docs, qw, exclude, mask)
    return topk_score(qw, docs, k=k, exclude=exclude, mask=mask, chunk=chunk)


def brute_force_bottomk(docs, qw, k, *, exclude=None, mask=None,
                        chunk: int = 8192):
    """The farthest set ``FS(k, q, E)`` (the NAG normaliser)."""
    qw, exclude, mask = _prepare(docs, qw, exclude, mask)
    s, i = topk_score(-qw, docs, k=k, exclude=exclude, mask=mask,
                      chunk=chunk)
    return -s, i


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
