"""Plain PyTorch MIND and the multi-interest retrieval it feeds.

MIND (Li et al., arXiv:1904.08030) as ``repro_torch.models.recsys``
describes it: a user's history of item ids (``-1`` pads) is gathered from
the item table, padding masked to zero, mapped by one shared bilinear
matrix (``u_hat = e @ S``), and routed to ``K`` interest capsules by
dynamic routing: each round takes a softmax of the routing logits over the
interests, drops the padded positions, sums the mapped behaviours by those
coefficients, squashes each sum (``|s|^2 / (1 + |s|^2) * s / |s|``) and,
but for the last round, adds to the logits the agreement of each capsule
with each behaviour. The logits start from a fixed draw shared by every
user (the program's own, handed in).

Retrieval under per-interest weights is the paper's §4 reduction: the
catalogue's rows are each item's unit vector tiled once per interest, so a
user's ``K`` unit interests weighted ``w`` score an item as the weighted
query ``[w_1 a_1, .., w_K a_K] / |.|`` against that row
(``search_ref.weighted_query``, ``search_ref.full_scores``), and a hit's
per-interest scores are the dot products of the query's and the row's
slices (:func:`field_scores`).

Everything runs in fp32 with TF32 off.
"""

from __future__ import annotations

import torch

from .index_ref import exact_fp32

__all__ = ["item_docs", "squash", "mind_forward", "field_scores",
           "recall_per_query"]


def item_docs(items: torch.Tensor, n_fields: int) -> torch.Tensor:
    """``(n, n_fields * E)``: each row of ``items (n, E)`` made unit and
    tiled ``n_fields`` times."""
    unit = items / torch.linalg.vector_norm(items, dim=-1, keepdim=True)
    return unit.repeat(1, n_fields)


def squash(s: torch.Tensor) -> torch.Tensor:
    """The capsule non-linearity over the last dim, with the program's
    1e-9 under the root (a zero sum stays zero)."""
    n2 = (s * s).sum(-1, keepdim=True)
    return s * (n2 / (1.0 + n2)) / torch.sqrt(n2 + 1e-9)


def mind_forward(item_emb: torch.Tensor, bilinear: torch.Tensor,
                 routing_logits: torch.Tensor, hist: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """``(B, K, E)`` interests of the histories ``hist (B, L)`` (``-1``
    pads) from the item table ``(n, E)``, the bilinear map ``(E, E)`` and
    the routing logits' first draw ``(1, K, L)``."""
    with exact_fp32():
        valid = hist >= 0
        e = item_emb.float()[torch.where(valid, hist, 0).long()]
        e = e * valid[..., None]
        u_hat = e @ bilinear.float()                              # (B, L, E)
        b, l = hist.shape
        logits = routing_logits.float().to(e.device).expand(
            b, -1, l).clone()                                     # (B, K, L)
        mask = valid[:, None, :].float()
        for it in range(iters):
            c = torch.softmax(logits, dim=1) * mask
            v = squash(torch.bmm(c, u_hat))                       # (B, K, E)
            if it < iters - 1:
                logits = logits + torch.bmm(v, u_hat.transpose(1, 2))
        return v


def field_scores(qw: torch.Tensor, docs: torch.Tensor, ids: torch.Tensor,
                 dims) -> torch.Tensor:
    """``(nq, k, s)``: the dot products of each query's field slices with
    those of the rows ``ids (nq, k)`` names (``-1`` reads 0)."""
    with exact_fp32():
        rows = docs[ids.clamp(min=0).long()].float()              # (nq, k, D)
        parts, lo = [], 0
        for d in dims:
            parts.append(torch.bmm(rows[..., lo:lo + d],
                                   qw[:, lo:lo + d, None].float())[..., 0])
            lo += d
        out = torch.stack(parts, dim=-1)
        return torch.where((ids >= 0)[..., None], out, 0.0)


def recall_per_query(ids: torch.Tensor, scores_all: torch.Tensor
                     ) -> torch.Tensor:
    """``(nq,)`` recall@k of each query: the share of its answers
    ``ids (nq, k)`` that are among its ``k`` best rows by the reference's
    scores ``scores_all (nq, n)``."""
    k = ids.shape[1]
    best = torch.topk(scores_all, k, dim=1).indices
    ids = ids.long().to(best.device)
    return (ids[:, :, None] == best[:, None, :]).any(-1).sum(1).double() / k
