"""The recsys serve and retrieval steps (the bodies of the reference's
``recsys_serve_cell`` and ``recsys_retrieval_cell``,
``src/repro/configs/common.py:540-647``), as plain functions on tensors.

The ``Cell`` machinery around them (meshes, shardings, input stand-ins)
comes with the dry-run slice.
"""

from __future__ import annotations

import torch

from ..core.engine import stable_topk
from ..models import recsys as rs

__all__ = ["recsys_serve_step", "recsys_retrieval_step"]


def recsys_serve_step(model, batch) -> torch.Tensor:
    """One serving forward -> ``(B,)`` scores, under inference mode.

    DLRM reads ``dense`` and ``sparse`` (``(B, F)``, or ``(B, F, M)``
    multi-hot through ``embed_bag``), AutoInt ``sparse``, BST ``hist`` and
    ``target``; MIND scores the target item by its best-matching interest,
    ``max_k <interest_k, target>``."""
    with torch.inference_mode():
        if isinstance(model, rs.DLRM):
            return model(batch["dense"], batch["sparse"])
        if isinstance(model, rs.AutoInt):
            return model(batch["sparse"])
        if isinstance(model, rs.BST):
            return model(batch["hist"], batch["target"])
        if isinstance(model, rs.MIND):
            ints = model(batch["hist"])                       # (B, K, E)
            tgt = model.p["item_emb"][batch["target"].long()]  # (B, E)
            return torch.einsum("bke,be->bk", ints, tgt).amax(dim=-1)
    raise TypeError(f"not a recsys model: {type(model).__name__}")


def recsys_retrieval_step(model, query, cands, *, weights=None, k=100):
    """Score query contexts against every candidate -> top-k ``(values,
    indices)``, ties to the lower index (``lax.top_k``'s rule).

    For MIND ``query`` is a history ``(B, L)``: its interests are scored
    against ``cands (n, E)`` under per-request interest ``weights (B, K)``
    (the paper's dynamic aggregation; None: max over interests). For the
    other archs ``query`` is a user vector ``(B, E)``."""
    with torch.inference_mode():
        if isinstance(model, rs.MIND):
            scores = rs.retrieval_scores(model(query), cands, weights=weights)
        else:
            scores = rs.retrieval_scores(query, cands)
        return stable_topk(scores, k)
