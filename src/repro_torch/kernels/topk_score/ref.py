"""Plain PyTorch version of the brute-force score + top-k kernel.

The function of the TPU kernel ``topk_score_kernel``
(``src/repro/kernels/topk_score/kernel.py:26``) and of the reference's
ground truth (``src/repro/core/metrics.py::_exhaustive_topk``): documents
stream in chunks of ``chunk`` rows, each chunk's fp32 scores are masked
(``mask[doc]`` False, ``doc == exclude[q]``) and merged into the running
top-k with a stable descending sort over ``[best, chunk]`` — ties to the
accumulator, then to the lower id, as ``lax.top_k`` — so the ``(nq, n)``
score matrix never materialises. Slots past the eligible documents hold
``-inf`` with id ``-1``. bf16 inputs are scored in fp32 (exact products,
fp32 sums: ``preferred_element_type=float32``); ``round_bf16`` rounds each
score to bf16 before the masks and the merge, as the reference's sharded
brute force (``src/repro/core/distributed.py:115``).
"""

from __future__ import annotations

import torch

__all__ = ["topk_score_ref"]


def topk_score_ref(
    queries: torch.Tensor,               # (nq, D) fp32 or bf16
    docs: torch.Tensor,                  # (n, D) the same dtype
    *,
    k: int,
    exclude: torch.Tensor | None = None,  # (nq,) doc id or -1
    mask: torch.Tensor | None = None,     # (n,) bool, False = ineligible
    chunk: int = 8192,
    round_bf16: bool = False,
):
    """``(scores (nq, k) f32, ids (nq, k) i32)``, best first."""
    n = docs.shape[0]
    nq = queries.shape[0]
    dev = docs.device
    if exclude is None:
        exclude = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    best_s = torch.full((nq, k), float("-inf"), dtype=torch.float32,
                        device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    neg = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for start in range(0, n, chunk):
        block = docs[start:start + chunk]
        ids = torch.arange(start, start + block.shape[0], dtype=torch.int32,
                           device=dev)
        s = queries.float() @ block.float().T
        if round_bf16:
            s = s.to(torch.bfloat16).to(torch.float32)
        if mask is not None:
            s = torch.where(mask[start:start + chunk][None, :], s, neg)
        s = torch.where(ids[None, :] == exclude[:, None], neg, s)
        cat_s = torch.cat([best_s, s], dim=-1)
        cat_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=-1)
        top_s, pos = torch.sort(cat_s, dim=-1, descending=True, stable=True)
        best_s = top_s[:, :k]
        best_i = torch.gather(cat_i, -1, pos[:, :k])
    return best_s, best_i
