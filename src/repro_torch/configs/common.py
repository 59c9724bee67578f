"""The recsys train, serve and retrieval steps (the bodies of the
reference's ``recsys_train_cell``, ``recsys_serve_cell`` and
``recsys_retrieval_cell``, ``src/repro/configs/common.py:504-647``), as
plain functions on tensors, and the model-flop count of a step.

The ``Cell`` machinery around them (meshes, shardings, input stand-ins)
comes with the dry-run slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.engine import stable_topk
from ..models import recsys as rs
from ..optim import accumulate_gradients

__all__ = ["recsys_train_step", "recsys_loss_and_grads",
           "recsys_model_flops", "recsys_serve_step",
           "recsys_retrieval_step"]

_LOSSES = {rs.DLRM: rs.dlrm_loss, rs.AutoInt: rs.autoint_loss,
           rs.BST: rs.bst_loss, rs.MIND: rs.mind_loss}


def recsys_loss_and_grads(model, batch):
    """``jax.value_and_grad(loss)(params, batch, cfg)`` on the port: the
    model's loss (picked by its type, as the reference's ``_recsys_fns``)
    and its gradient for every parameter, by name (dense, fp32).

    Runs under grad mode; inputs made under inference mode are cloned
    first (such tensors cannot enter autograd)."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("a training step cannot run under "
                           "torch.inference_mode()")
    loss_fn = _LOSSES.get(type(model))
    if loss_fn is None:
        raise TypeError(f"not a recsys model: {type(model).__name__}")
    batch = {k: v.clone() if v.is_inference() else v
             for k, v in batch.items()}
    with torch.enable_grad():
        loss, grads, _ = accumulate_gradients(
            lambda p, b: (loss_fn(model, b), None), dict(model.p), batch, 1)
    return loss, grads


def recsys_train_step(model, opt, opt_state, batch):
    """One training step, the body of ``recsys_train_cell``'s ``step``
    without its sharding constraint -> ``(loss, opt_state)``: the loss and
    gradients, then ``opt.update`` of the model's parameters in place
    (``opt_state = opt.init(dict(model.p))``, ``opt = adamw(1e-3)`` in the
    reference's cells)."""
    loss, grads = recsys_loss_and_grads(model, batch)
    _, opt_state = opt.update(grads, opt_state, dict(model.p))
    return loss, opt_state


def recsys_model_flops(cfg, batch: int, *, train: bool = True) -> float:
    """Matmul flops of a step at ``batch`` (the reference's
    ``_recsys_model_flops``): per sample 2 x (non-table parameters) plus
    the interaction term, forward; x3 for a training step."""
    dense_params = sum(
        int(np.prod(shape)) for n, shape in rs.param_specs(cfg).items()
        if not n.startswith("table_") and n not in ("item_emb", "pos_emb"))
    inter = 0.0
    if isinstance(cfg, rs.DLRMConfig):
        f = cfg.n_sparse + 1
        inter = f * f * cfg.embed_dim
    elif isinstance(cfg, rs.AutoIntConfig):
        inter = cfg.n_attn_layers * 2 * cfg.n_fields ** 2 * cfg.d_attn
    elif isinstance(cfg, rs.BSTConfig):
        inter = cfg.n_blocks * 2 * cfg.full_seq ** 2 * cfg.embed_dim
    elif isinstance(cfg, rs.MINDConfig):
        inter = (cfg.capsule_iters * 2 * cfg.n_interests * cfg.hist_len
                 * cfg.embed_dim)
    fwd = (2.0 * dense_params + 2.0 * inter) * batch
    return 3.0 * fwd if train else fwd


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
