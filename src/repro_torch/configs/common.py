"""Cell builders: (architecture x input shape) -> a sharded step (port of
:mod:`repro.configs.common`), and the recsys steps as plain functions.

A **Cell** is one dry-run unit: it builds the step function, the input
stand-ins and the in/out partition specs for a mesh.
``launch/dryrun.py`` runs every cell once on DTensors over fake tensors;
tests call ``Cell.build`` on an ``AbstractMesh``. ``build(mesh)`` returns
``(fn, args, in_specs, out_specs)``: ``args`` are trees (dicts by the
port's flat parameter names, optimizer-state ``NamedTuple``s, tensors) of
``meta`` tensors with the reference's global shapes and dtypes, the specs
the same trees of :class:`~repro_torch.runtime.sharding.P`. The step
computes the reference's cell on the arguments as given: plain tensors,
or DTensors placed by the specs.

Builders per family:
  lm_train_cell / lm_prefill_cell / lm_decode_cell
  gnn_full_cell / gnn_minibatch_cell / gnn_molecule_cell
  recsys_train_cell / recsys_serve_cell / recsys_retrieval_cell

Where the port differs: the optimizer's ``step`` is a host ``int`` (no
argument leaf; its spec stays ``P()``); an LM cell carries
``at_depth(n)``, the same cell cut to ``n`` identical blocks, which the
dry-run uses in place of the reference's scan (it counts a block's
collectives once per block, as the reference's HLO parse multiplies a
loop body by its trip count); microbatches split each rank's own rows
(the reference's reshape of the global batch keeps the batch sharding in
XLA's hands; a DTensor reshape of a sharded dim would gather it).

The recsys train, serve and retrieval steps on plain modules
(``recsys_train_step`` etc., the bodies of the reference's
``recsys_*_cell``s, ``src/repro/configs/common.py:504-647``) stay the
entry points of the recsys examples and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..core.engine import stable_topk
from ..models import gnn as gnn_mod
from ..models import recsys as rs
from ..models import transformer as tf
from ..models.embedding import EmbedTablesConfig
from ..optim import accumulate_gradients, adafactor, adamw
from ..optim.adafactor import AdafactorState, FactoredSlot, FullSlot
from ..optim.adamw import AdamWState
from ..optim.sgd import SGDState
from ..runtime.sharding import (P, data_axes, lm_decode_shardings,
                                lm_param_rules, lm_param_rules_zero3,
                                lm_use_rules, lm_use_rules_zero3, spec_for)

__all__ = ["Cell", "opt_state_shardings", "lm_analytic_cost",
           "lm_train_cell", "lm_prefill_cell", "lm_decode_cell",
           "gnn_full_cell", "gnn_minibatch_cell", "gnn_molecule_cell",
           "recsys_train_cell", "recsys_serve_cell", "recsys_retrieval_cell",
           "meta", "tree_leaves", "tree_map", "recsys_train_step",
           "recsys_loss_and_grads", "recsys_model_flops",
           "recsys_serve_step", "recsys_retrieval_step"]

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


# ------------------------------------------------------------------ trees
def meta(shape, dtype) -> torch.Tensor:
    """An input stand-in: shape and dtype, no storage (the reference's
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def _children(node):
    """``(key, child)`` pairs of a tree node, or None for a leaf. A
    :class:`P` is a leaf; so are tensors, ints and None."""
    if isinstance(node, P) or not isinstance(node, (dict, tuple, list)):
        return None
    if isinstance(node, dict):
        return list(node.items())
    if hasattr(node, "_fields"):                   # a NamedTuple
        return list(zip(node._fields, node))
    return list(enumerate(node))


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, depth first; path parts joined by
    ``/`` (a parameter's own name keeps its dots)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(tree_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    rest_kids = [dict(_children(r)) if isinstance(r, dict) or hasattr(
        r, "_fields") else dict(enumerate(r)) for r in rest]
    vals = [tree_map(fn, v, *(r[k] for r in rest_kids)) for k, v in kids]
    if isinstance(tree, dict):
        return dict(zip((k for k, _ in kids), vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


# ------------------------------------------------------------------- cells
@dataclasses.dataclass
class Cell:
    """One (arch x shape) dry-run unit."""

    arch: str
    shape: str
    kind: str                        # train|prefill|decode|serve|retrieval|build
    build: Callable[[Any], tuple]    # mesh -> (fn, args, in_specs, out_specs)
    note: str = ""
    model_flops: float = 0.0         # 6·N·D-style useful flops
    analytic: Callable[[Any], dict] | None = None
    # ^ per-chip {flops, bytes} in closed form (the LM cells: the reference's
    #   scan hides its loop from XLA's cost analysis; the port keeps the
    #   same numbers)
    at_depth: Callable[..., "Cell"] | None = None
    # ^ (n_blocks[, n_micro]) -> the same cell at that depth (and that many
    #   microbatches of the same size)
    blocks: int = 0                  # identical blocks the step loops over
    micro: int = 1                   # microbatches the step loops over
    collective_caveat: str = ""
    # ^ why the dry-run's collective term is not the reference's (empty:
    #   it is comparable)

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


def _mesh_size(mesh) -> int:
    from ..runtime.sharding import mesh_axes

    return int(np.prod(list(mesh_axes(mesh).values())))


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


# ------------------------------------------------------- optimizer state
def opt_state_shardings(state, param_pspecs):
    """Spec tree for an optimizer state, derived from the parameters'
    specs (by name)."""
    if isinstance(state, AdamWState):
        return AdamWState(step=P(), mu=dict(param_pspecs),
                          nu=dict(param_pspecs))
    if isinstance(state, SGDState):
        return SGDState(momentum=dict(param_pspecs))
    if isinstance(state, AdafactorState):
        def slot_spec(slot, pspec):
            if isinstance(slot, FactoredSlot):
                parts = list(pspec) + [None] * (
                    len(slot.vr.shape) + 1 - len(pspec))
                return FactoredSlot(vr=P(*parts[:-1]),
                                    vc=P(*(parts[:-2] + parts[-1:])))
            return FullSlot(v=pspec)

        return AdafactorState(step=P(), slots={
            n: slot_spec(s, param_pspecs[n]) for n, s in state.slots.items()})
    raise TypeError(f"unknown optimizer state {type(state).__name__}")


def _requires_grad(params: dict) -> dict:
    """Leaves of the step's own autograd graph (the caller's tensors stay
    untouched; the optimizer's in-place update reaches their storage)."""
    return {n: p.detach().requires_grad_(True) for n, p in params.items()}


def _grads(loss, params: dict) -> dict:
    """``d loss / d params`` by name; a parameter the loss does not reach
    gets zeros (``jax.grad``'s answer); a DTensor gradient is put back in
    its parameter's placement (the reference pins gradients to the
    storage layout)."""
    names = list(params)
    out = {}
    for n, g in zip(names, torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True)):
        p = params[n]
        if g is None:
            g = torch.zeros_like(p)
        elif _is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out[n] = g
    return out


def _apply(opt, params, opt_state, loss_of_params, n_micro: int = 1):
    """``value_and_grad`` then ``opt.update``: the reference's step body.
    ``loss_of_params(params, i)`` is microbatch ``i``'s loss; with
    ``n_micro > 1`` the fp32 gradients and loss are the mean over the
    microbatches, one backward each (the reference's accumulation scan)."""
    if n_micro <= 1:
        loss = loss_of_params(params, 0)
        grads = _grads(loss, params)
    else:
        loss, grads = 0.0, None
        for i in range(n_micro):
            li = loss_of_params(params, i)
            gi = _grads(li, params)
            if grads is None:
                grads = {n: torch.zeros_like(g, dtype=torch.float32)
                         for n, g in gi.items()}
            for n, g in gi.items():
                grads[n].add_(g.to(torch.float32) / n_micro)
            loss = loss + li.detach().to(torch.float32) / n_micro
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, loss.detach()


# ---------------------------------------------------------------- LM cells
def lm_analytic_cost(cfg, *, global_batch, seq_len, kind, n_micro=1):
    """Closed-form per-chip FLOPs/HBM-bytes for the LM cells (the
    reference's model, the same numbers).

    FLOPs (matmul accounting; the blockwise attention scans ALL kv blocks
    incl. fully masked ones, so no causal /2):
      train = 8·N·T + 4·attn ; prefill = 2·N·T + attn ; decode = 2·N·B + attn,
      attn / layer = 4·B·S·S_kv·H·dh.
    Bytes (first-order HBM traffic):
      train:   3 reads of the gathered weights + fp32 grad rw + optimizer
               state rw + 2x activation-carry traffic + logits;
      prefill: 1 weight read (TP share) + activations + cache write + logits;
      decode:  TP weight share + full cache read + logits.
    """
    def build(mesh):
        from ..runtime.sharding import axis_size

        n_dev = _mesh_size(mesh)
        model_sz = axis_size(mesh, "model")
        L, D, Hq, dh, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.d_head, cfg.vocab)
        kv = cfg.n_kv_heads
        N = tf.active_params(cfg)
        P_total = tf.count_params(cfg)
        T = global_batch * seq_len if kind != "decode" else global_batch
        attn = 4.0 * T * seq_len * Hq * dh * L
        if kind == "train":
            flops = 8.0 * N * T + 4.0 * attn
        else:
            flops = 2.0 * N * T + attn
        flops_chip = flops / n_dev

        pb = 2.0 * P_total                       # param bytes (bf16)
        t_loc = T / n_dev
        act = 2.0 * (2.0 * L * t_loc * D)        # carry write+read, bf16
        logits = 3.0 * t_loc * (V / model_sz) * 4.0
        cache = 2.0 * L * t_loc * kv * dh * 2.0  # k+v bf16
        if kind == "train":
            grads_opt = (P_total / n_dev) * (4 * 2 + 8 * 2)
            bytes_chip = 3.0 * pb + grads_opt + 2.0 * act + logits
        elif kind == "prefill":
            bytes_chip = pb / model_sz + act + cache + logits
        else:
            cache_read = (2.0 * L * global_batch * cfg.max_seq_len * kv * dh
                          * 2.0) / n_dev
            bytes_chip = pb / model_sz + cache_read + logits
        return {"flops": flops_chip, "bytes": bytes_chip}

    return build


def _make_optimizer(cfg):
    big = tf.count_params(cfg) > 3e10
    return adafactor(1e-2) if big else adamw(3e-4)


def _lm_params(cfg) -> dict:
    return {n: meta(s, cfg.dtype) for n, s in tf.param_specs(cfg).items()}


def _micro(x, n_micro: int, i: int):
    """Microbatch ``i`` of ``n_micro``: the reference's reshape of the
    leading axis; a DTensor splits each rank's own rows (see the module
    docstring)."""
    if n_micro <= 1:
        return x
    if _is_dtensor(x):
        from torch.distributed.tensor import DTensor

        loc = x.to_local()
        part = loc.reshape(n_micro, -1, *loc.shape[1:])[i]
        return DTensor.from_local(part, x.device_mesh, x.placements,
                                  run_check=False)
    return x.reshape(n_micro, -1, *x.shape[1:])[i]


def _at_depth(cfg, n_blocks: int):
    return dataclasses.replace(cfg, n_layers=n_blocks * tf._n_sub(cfg))


def lm_train_cell(arch, cfg, *, global_batch, seq_len, n_micro=1,
                  strategy="tp"):
    """strategy: "tp" (Megatron TP over model + FSDP over data), "zero3"
    (full-shard storage, per-layer weight gather, batch over every axis)
    or "hybrid" (ZeRO storage, TP use, sequence-parallel residual)."""

    def build(mesh):
        opt = _make_optimizer(cfg)
        p_args = _lm_params(cfg)
        o_args = opt.init(p_args)
        da = data_axes(mesh)
        batch_axes = da + ("model",) if strategy == "zero3" else da
        micro = 1 if strategy in ("zero3", "hybrid") else n_micro
        if strategy == "zero3":
            use_specs = lm_use_rules_zero3(cfg, mesh)
            p_shard = lm_param_rules_zero3(cfg, mesh)
        elif strategy == "hybrid":
            use_specs = dict(lm_use_rules(cfg, mesh))
            use_specs["residual"] = spec_for(
                mesh, (global_batch, seq_len, cfg.d_model),
                (da, "model", None))
            p_shard = lm_param_rules_zero3(cfg, mesh)
        else:
            use_specs = lm_use_rules(cfg, mesh)
            p_shard = lm_param_rules(cfg, mesh)

        def step(params, opt_state, tokens, labels):
            def loss_of(p, i):
                loss, _ = tf.loss_fn(p, _micro(tokens, micro, i),
                                     _micro(labels, micro, i), cfg, use_specs)
                return loss

            return _apply(opt, _requires_grad(params), opt_state, loss_of,
                          micro)

        o_shard = opt_state_shardings(o_args, p_shard)
        tok_spec = spec_for(mesh, (global_batch, seq_len), (batch_axes, None))
        args = (p_args, o_args,
                meta((global_batch, seq_len), torch.int32),
                meta((global_batch, seq_len), torch.int32))
        return (step, args, (p_shard, o_shard, tok_spec, tok_spec),
                (p_shard, o_shard, P()))

    return Cell(arch=arch, shape=f"train_{seq_len//1024}k", kind="train",
                build=build,
                model_flops=6.0 * tf.active_params(cfg) * global_batch * seq_len,
                analytic=lm_analytic_cost(cfg, global_batch=global_batch,
                                          seq_len=seq_len, kind="train",
                                          n_micro=n_micro),
                at_depth=lambda n, m=n_micro: lm_train_cell(
                    arch, _at_depth(cfg, n),
                    global_batch=global_batch // n_micro * m,
                    seq_len=seq_len, n_micro=m, strategy=strategy),
                blocks=tf._n_blocks(cfg),
                micro=1 if strategy in ("zero3", "hybrid") else n_micro,
                collective_caveat=_LM_COLLECTIVES)


def lm_prefill_cell(arch, cfg, *, global_batch, seq_len):
    cfg = dataclasses.replace(cfg, max_seq_len=seq_len)

    def build(mesh):
        da = data_axes(mesh)
        use_specs = lm_use_rules(cfg, mesh)
        p_shard = lm_param_rules(cfg, mesh)
        _, cache_shard, _ = lm_decode_shardings(cfg, mesh, batch=global_batch)
        use_specs["cache"] = cache_shard["k"]

        def step(params, tokens):
            return tf.prefill(params, tokens, cfg, use_specs)

        tok_spec = spec_for(mesh, (global_batch, seq_len), (da, None))
        logits_spec = spec_for(mesh, (global_batch, cfg.vocab),
                               (da, "model"))
        args = (_lm_params(cfg), meta((global_batch, seq_len), torch.int32))
        return step, args, (p_shard, tok_spec), (logits_spec, cache_shard)

    return Cell(arch=arch, shape=f"prefill_{seq_len//1024}k", kind="prefill",
                build=build,
                model_flops=2.0 * tf.active_params(cfg) * global_batch * seq_len,
                analytic=lm_analytic_cost(cfg, global_batch=global_batch,
                                          seq_len=seq_len, kind="prefill"),
                at_depth=lambda n, m=1: lm_prefill_cell(
                    arch, _at_depth(cfg, n), global_batch=global_batch,
                    seq_len=seq_len),
                blocks=tf._n_blocks(cfg),
                collective_caveat=_LM_COLLECTIVES)


def lm_decode_cell(arch, cfg, *, global_batch, seq_len, shape_name):
    cfg = dataclasses.replace(cfg, max_seq_len=seq_len)

    def build(mesh):
        def step(params, cache, token):
            return tf.decode_step(params, cache, token, cfg)

        p_shard, cache_shard, tok_shard = lm_decode_shardings(
            cfg, mesh, batch=global_batch)
        b_axes = tok_shard[0] if len(tok_shard) else None
        logits_spec = spec_for(mesh, (global_batch, cfg.vocab),
                               (b_axes, "model"))
        shape = (cfg.n_layers, global_batch, cfg.max_seq_len, cfg.n_kv_heads,
                 cfg.d_head)
        cache = {"k": meta(shape, cfg.dtype), "v": meta(shape, cfg.dtype),
                 "length": meta((), torch.int32)}
        args = (_lm_params(cfg), cache, meta((global_batch,), torch.int32))
        return (step, args, (p_shard, cache_shard, tok_shard),
                (logits_spec, cache_shard))

    return Cell(arch=arch, shape=shape_name, kind="decode", build=build,
                note="one new token against a filled KV cache",
                model_flops=2.0 * tf.active_params(cfg) * global_batch,
                analytic=lm_analytic_cost(cfg, global_batch=global_batch,
                                          seq_len=seq_len, kind="decode"),
                at_depth=lambda n, m=1: lm_decode_cell(
                    arch, _at_depth(cfg, n), global_batch=global_batch,
                    seq_len=seq_len, shape_name=shape_name),
                blocks=tf._n_blocks(cfg),
                collective_caveat=_LM_COLLECTIVES)


# DTensor places each op of an LM step by a local rule, leaving activations
# (the logits too) as partial sums over the data and model axes that it
# then reduces, where the reference's XLA partitions the whole step; the
# port's attention does keep heads, batch rows and a decode's cache
# positions local.
_LM_COLLECTIVES = ("DTensor's op-by-op placement, not XLA's whole-step "
                   "partitioning: activation partial sums and their "
                   "reduce-scatters the reference does not run")


# --------------------------------------------------------------- GNN cells
def _gcn_flops(cfg, n_nodes, n_edges, *, train=True):
    """2*(E*(d_in+d_h) + N*(d_in*d_h + d_h*C)) forward; x3 for training."""
    d_in, d_h, c = cfg.d_in, cfg.d_hidden, cfg.n_classes
    fwd = 2.0 * (n_edges * (d_in + d_h) + n_nodes * (d_in * d_h + d_h * c))
    return 3.0 * fwd if train else fwd


def _gnn_state(cfg, mesh):
    opt = adamw(1e-2)
    p_args = {n: meta(s, cfg.dtype)
              for n, s in gnn_mod.gcn_param_specs(cfg).items()}
    o_args = opt.init(p_args)
    p_shard = {n: P() for n in p_args}            # tiny params: replicate
    return opt, p_args, o_args, p_shard, opt_state_shardings(o_args, p_shard)


def gnn_full_cell(arch, cfg, *, n_nodes, n_edges, shape_name):
    def build(mesh):
        all_axes = data_axes(mesh) + ("model",)
        opt, p_args, o_args, p_shard, o_shard = _gnn_state(cfg, mesh)

        def step(params, opt_state, feats, edges, labels, mask):
            return _apply(opt, _requires_grad(params), opt_state,
                          lambda p, _: gnn_mod.gcn_loss(p, feats, edges,
                                                        labels, mask, cfg))

        feat_spec = spec_for(mesh, (n_nodes, cfg.d_in), (all_axes, None))
        edge_spec = spec_for(mesh, (2, n_edges), (None, all_axes))
        lab_spec = spec_for(mesh, (n_nodes,), (all_axes,))
        args = (p_args, o_args, meta((n_nodes, cfg.d_in), torch.float32),
                meta((2, n_edges), torch.int32), meta((n_nodes,), torch.int32),
                meta((n_nodes,), torch.float32))
        return (step, args,
                (p_shard, o_shard, feat_spec, edge_spec, lab_spec, lab_spec),
                (p_shard, o_shard, P()))

    return Cell(arch=arch, shape=shape_name, kind="train", build=build,
                model_flops=_gcn_flops(cfg, n_nodes, n_edges))


def gnn_minibatch_cell(arch, cfg, *, batch_nodes, fanouts, shape_name):
    n_seeds = batch_nodes
    edge_counts = []
    frontier = n_seeds
    for f in fanouts:
        edge_counts.append(frontier * f)
        frontier = frontier * f
    n_sub = n_seeds + sum(edge_counts)          # upper bound on unique nodes

    def build(mesh):
        all_axes = data_axes(mesh) + ("model",)
        opt, p_args, o_args, p_shard, o_shard = _gnn_state(cfg, mesh)

        def step(params, opt_state, feats, e_outer, e_inner, labels):
            return _apply(opt, _requires_grad(params), opt_state,
                          lambda p, _: gnn_mod.sampled_loss(
                              p, feats, [e_outer, e_inner], labels, n_seeds,
                              cfg))

        args = (p_args, o_args, meta((n_sub, cfg.d_in), torch.float32),
                meta((2, edge_counts[-1]), torch.int32),
                meta((2, edge_counts[0]), torch.int32),
                meta((n_seeds,), torch.int32))
        in_shard = (
            p_shard, o_shard,
            spec_for(mesh, (n_sub, cfg.d_in), (all_axes, None)),
            spec_for(mesh, (2, edge_counts[-1]), (None, all_axes)),
            spec_for(mesh, (2, edge_counts[0]), (None, all_axes)),
            spec_for(mesh, (n_seeds,), (all_axes,)),
        )
        return step, args, in_shard, (p_shard, o_shard, P())

    return Cell(arch=arch, shape=shape_name, kind="train", build=build,
                note="sampled subgraph train step (sampler host-side)",
                model_flops=_gcn_flops(cfg, n_sub, sum(edge_counts)))


def gnn_molecule_cell(arch, cfg, *, batch, nodes_per_graph, edges_per_graph,
                      shape_name):
    n = batch * nodes_per_graph
    e = batch * edges_per_graph * 2

    def build(mesh):
        all_axes = data_axes(mesh) + ("model",)
        opt, p_args, o_args, p_shard, o_shard = _gnn_state(cfg, mesh)

        def step(params, opt_state, feats, edges, graph_ids, labels):
            return _apply(opt, _requires_grad(params), opt_state,
                          lambda p, _: gnn_mod.graph_readout_loss(
                              p, feats, edges, graph_ids, labels, batch, cfg))

        args = (p_args, o_args, meta((n, cfg.d_in), torch.float32),
                meta((2, e), torch.int32), meta((n,), torch.int32),
                meta((batch,), torch.int32))
        in_shard = (
            p_shard, o_shard,
            spec_for(mesh, (n, cfg.d_in), (all_axes, None)),
            spec_for(mesh, (2, e), (None, all_axes)),
            spec_for(mesh, (n,), (all_axes,)),
            spec_for(mesh, (batch,), (all_axes,)),
        )
        return step, args, in_shard, (p_shard, o_shard, P())

    return Cell(arch=arch, shape=shape_name, kind="train", build=build,
                model_flops=_gcn_flops(cfg, n, e))


# ------------------------------------------------------------ recsys cells
def _recsys_batch_specs(model_cfg, batch) -> dict:
    i32, f32 = torch.int32, torch.float32
    if isinstance(model_cfg, rs.DLRMConfig):
        return {"dense": meta((batch, model_cfg.n_dense), f32),
                "sparse": meta((batch, model_cfg.n_sparse), i32),
                "label": meta((batch,), f32)}
    if isinstance(model_cfg, rs.AutoIntConfig):
        return {"sparse": meta((batch, model_cfg.n_fields), i32),
                "label": meta((batch,), f32)}
    if isinstance(model_cfg, rs.BSTConfig):
        return {"hist": meta((batch, model_cfg.seq_len), i32),
                "target": meta((batch,), i32), "label": meta((batch,), f32)}
    if isinstance(model_cfg, rs.MINDConfig):
        return {"hist": meta((batch, model_cfg.hist_len), i32),
                "target": meta((batch,), i32), "label": meta((batch,), f32)}
    raise TypeError(type(model_cfg))


def _recsys_params(model_cfg) -> dict:
    return {n: meta(s, model_cfg.dtype)
            for n, s in rs.param_specs(model_cfg).items()}


def _recsys_param_shardings(model_cfg, p_args, mesh) -> dict:
    """Big embedding tables row-sharded (``row_shard_threshold`` rows and
    up), everything else replicated."""
    shard_axes = ("model",) + data_axes(mesh)   # biggest tables: all axes
    big = EmbedTablesConfig.row_shard_threshold
    out = {}
    for name, t in p_args.items():
        if (name.startswith("table_") or name == "item_emb") \
                and t.shape[0] >= big:
            out[name] = spec_for(mesh, t.shape, (shard_axes, None))
        else:
            out[name] = P()
    return out


def _batch_shard(mesh, b_args) -> dict:
    da = data_axes(mesh)
    return {k: spec_for(mesh, t.shape, (da,) + (None,) * (t.dim() - 1))
            for k, t in b_args.items()}


def recsys_train_cell(arch, model_cfg, *, batch, shape_name):
    loss_fn = _LOSSES[rs._MODELS[type(model_cfg)]]

    def build(mesh):
        opt = adamw(1e-3)
        p_args = _recsys_params(model_cfg)
        o_args = opt.init(p_args)
        p_shard = _recsys_param_shardings(model_cfg, p_args, mesh)

        def step(params, opt_state, batch_in):
            return _apply(opt, _requires_grad(params), opt_state,
                          lambda p, _: loss_fn(rs.with_params(model_cfg, p),
                                               batch_in))

        o_shard = opt_state_shardings(o_args, p_shard)
        b_args = _recsys_batch_specs(model_cfg, batch)
        args = (p_args, o_args, b_args)
        return (step, args, (p_shard, o_shard, _batch_shard(mesh, b_args)),
                (p_shard, o_shard, P()))

    return Cell(arch=arch, shape=shape_name, kind="train", build=build,
                model_flops=recsys_model_flops(model_cfg, batch))


def recsys_serve_cell(arch, model_cfg, *, batch, shape_name):
    def build(mesh):
        p_args = _recsys_params(model_cfg)

        def step(params, batch_in):
            model = rs.with_params(model_cfg, params)
            if isinstance(model, rs.DLRM):
                return model(batch_in["dense"], batch_in["sparse"])
            if isinstance(model, rs.AutoInt):
                return model(batch_in["sparse"])
            if isinstance(model, rs.BST):
                return model(batch_in["hist"], batch_in["target"])
            ints = model(batch_in["hist"])
            tgt = params["item_emb"][batch_in["target"].long()]
            return torch.einsum("bke,be->bk", ints, tgt).amax(dim=-1)

        p_shard = _recsys_param_shardings(model_cfg, p_args, mesh)
        b_args = _recsys_batch_specs(model_cfg, batch)
        b_args.pop("label")
        out_spec = spec_for(mesh, (batch,), (data_axes(mesh),))
        return (step, (p_args, b_args), (p_shard, _batch_shard(mesh, b_args)),
                out_spec)

    return Cell(arch=arch, shape=shape_name, kind="serve", build=build,
                model_flops=recsys_model_flops(model_cfg, batch, train=False))


def _retrieval_dim(model_cfg) -> int:
    if isinstance(model_cfg, rs.AutoIntConfig):
        return model_cfg.d_attn
    return model_cfg.embed_dim


def recsys_retrieval_cell(arch, model_cfg, *, n_candidates, shape_name,
                          k=100):
    """Score ONE query context against n_candidates items, return top-k
    (ties to the lower index). For MIND this is the paper's dynamic vector
    score aggregation: per-request interest weights aggregate its interest
    similarities."""
    e_dim = _retrieval_dim(model_cfg)

    def build(mesh):
        all_axes = data_axes(mesh) + ("model",)
        p_args = _recsys_params(model_cfg)
        p_shard = _recsys_param_shardings(model_cfg, p_args, mesh)
        cand_spec = spec_for(mesh, (n_candidates, e_dim), (all_axes, None))
        cands = meta((n_candidates, e_dim), torch.float32)
        if isinstance(model_cfg, rs.MINDConfig):
            def step(params, hist, weights, cands):
                ints = rs.with_params(model_cfg, params)(hist)
                return stable_topk(rs.retrieval_scores(ints, cands,
                                                       weights=weights), k)

            args = (p_args, meta((1, model_cfg.hist_len), torch.int32),
                    meta((1, model_cfg.n_interests), torch.float32), cands)
            in_shard = (p_shard, P(None, None), P(None, None), cand_spec)
        else:
            def step(params, user_vec, cands):
                return stable_topk(rs.retrieval_scores(user_vec, cands), k)

            args = (p_args, meta((1, e_dim), torch.float32), cands)
            in_shard = (p_shard, P(None, None), cand_spec)
        return step, args, in_shard, (P(None, None), P(None, None))

    flops_dim = e_dim * (model_cfg.n_interests
                         if isinstance(model_cfg, rs.MINDConfig) else 1)
    return Cell(arch=arch, shape=shape_name, kind="retrieval", build=build,
                note="batched-dot candidate scoring; index-served in examples/",
                model_flops=2.0 * n_candidates * flops_dim)
