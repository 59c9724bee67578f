"""Plain PyTorch versions of the bucket scoring kernels.

:func:`bucket_score_tiled_ref` has the signature of
:func:`repro_torch.kernels.bucket_score.ops.bucket_score_tiled` and the
function of the TPU kernel ``bucket_score_tiled_kernel``
(``src/repro/kernels/bucket_score/kernel.py:100``): a sequential merge over
the schedule, slot by slot, with the kernel's masks (membership, id -1,
``exclude``, ids already in the running top-k) and its precision (bf16 /
int8 packs see the bf16-rounded query; int8 scores are multiplied by the
bucket's scale after the fp32 dot). The running top-k keeps
``lax.top_k``'s tie rule — accumulator first, then lower position — by a
stable descending sort; ``torch.topk`` promises no order among ties.

:func:`bucket_score_ref` is the v1 kernel's (``bucket_score_kernel``,
kernel.py:65): per query, the probes in order, the same masks, and a bf16
or int8 pack widened against the fp32 query (no query rounding, and no
scale for int8: the v1 kernel has no scales operand, so its int8 scores
are ``q · float(int8 row)``, as the reference's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import pad_to

__all__ = ["bucket_score_ref", "bucket_score_tiled_ref", "merge_topk_ref"]


def merge_topk_ref(acc_s, acc_i, cand_s, cand_i, k_pad: int):
    """Merge candidates into a running top-k: ``lax.top_k`` over
    ``[acc, candidates]`` — descending, ties to the lower position."""
    cat_s = torch.cat([acc_s, cand_s], dim=-1)
    cat_i = torch.cat([acc_i, cand_i], dim=-1)
    top_s, pos = torch.sort(cat_s, dim=-1, descending=True, stable=True)
    pos = pos[..., :k_pad]
    return top_s[..., :k_pad], torch.gather(cat_i, -1, pos)


def bucket_score_tiled_ref(
    queries: torch.Tensor,        # (nq, D) fp32
    bucket_data: torch.Tensor,    # (K, B, D) fp32 / bf16 / int8
    bucket_ids: torch.Tensor,     # (K, B) int32, -1 padding
    schedule: torch.Tensor,       # (n_tiles, S) int32
    member: torch.Tensor,         # (n_tiles, S, QT) int32
    *,
    k: int,
    exclude: torch.Tensor | None = None,
    scales: torch.Tensor | None = None,
):
    """Returns ``(scores (nq, k), ids (nq, k))`` (``k_pad`` columns when the
    schedule cannot surface ``k`` candidates, as the reference)."""
    nq, d = queries.shape
    b = bucket_data.shape[1]
    n_tiles, s_len = schedule.shape
    qt = member.shape[-1]
    dev = queries.device
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    pad = n_tiles * qt - nq
    q = F.pad(queries, (0, 0, 0, pad)).reshape(n_tiles, qt, d)
    ex = F.pad(exclude.to(torch.int32), (0, pad), value=-1).reshape(n_tiles, qt)
    k_pad = min(pad_to(k, 8), b * s_len)
    quantised = bucket_data.dtype == torch.int8
    if bucket_data.dtype != torch.float32:
        q = q.to(torch.bfloat16).float()
    acc_s = torch.full((n_tiles, qt, k_pad), float("-inf"), device=dev)
    acc_i = torch.full((n_tiles, qt, k_pad), -1, dtype=torch.int32, device=dev)
    live = (member != 0).any(dim=-1).any(dim=0).tolist()   # (S,) any tile
    neg = torch.tensor(float("-inf"), device=dev)
    for s in range(s_len):
        if not live[s]:
            continue   # padding in every tile: all -inf, the merge is a no-op
        blk = schedule[:, s].long()
        x = bucket_data[blk].float()                          # (n_tiles, B, D)
        sc = torch.bmm(q, x.transpose(1, 2))                  # (n_tiles, QT, B)
        if quantised:
            sc = sc * scales[blk].float()[:, None, None]
        ids = bucket_ids[blk].to(torch.int32)[:, None, :]    # (n_tiles, 1, B)
        sc = torch.where(member[:, s, :, None] != 0, sc, neg)
        sc = torch.where(ids >= 0, sc, neg)
        sc = torch.where(ids == ex[..., None], neg, sc)
        dup = (ids[..., None] == acc_i[:, :, None, :]).any(dim=-1)
        sc = torch.where(dup, neg, sc)
        acc_s, acc_i = merge_topk_ref(
            acc_s, acc_i, sc, ids.expand(-1, qt, -1), k_pad
        )
    return (
        acc_s.reshape(-1, k_pad)[:nq, :k],
        acc_i.reshape(-1, k_pad)[:nq, :k],
    )


def bucket_score_ref(
    queries: torch.Tensor,        # (nq, D) fp32
    bucket_data: torch.Tensor,    # (K, B, D) fp32 / bf16 / int8
    bucket_ids: torch.Tensor,     # (K, B) int32, -1 padding
    probes: torch.Tensor,         # (nq, P) int32
    *,
    k: int,
    exclude: torch.Tensor | None = None,
):
    """Returns ``(scores (nq, k), ids (nq, k))`` (``k_pad = min(pad8(k),
    B·P)`` columns when that is fewer, as the reference)."""
    nq, _ = queries.shape
    b = bucket_data.shape[1]
    p = probes.shape[1]
    dev = queries.device
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    ex = exclude.to(torch.int32)[:, None]
    k_pad = min(pad_to(k, 8), b * p)
    acc_s = torch.full((nq, k_pad), float("-inf"), device=dev)
    acc_i = torch.full((nq, k_pad), -1, dtype=torch.int32, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    for j in range(p):
        blk = probes[:, j].long()
        x = bucket_data[blk].float()                          # (nq, B, D)
        sc = torch.einsum("qbd,qd->qb", x, queries)
        ids = bucket_ids[blk].to(torch.int32)                 # (nq, B)
        sc = torch.where(ids >= 0, sc, neg)
        sc = torch.where(ids == ex, neg, sc)
        dup = (ids[..., None] == acc_i[:, None, :]).any(dim=-1)
        sc = torch.where(dup, neg, sc)
        acc_s, acc_i = merge_topk_ref(acc_s, acc_i, sc, ids, k_pad)
    return acc_s[:, :k], acc_i[:, :k]
