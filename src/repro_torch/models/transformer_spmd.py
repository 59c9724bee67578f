"""The LM cells' steps as rank-local programs on DTensor arguments:
the schedules the reference's compiled steps show (their optimized HLO on
the production meshes), run on each rank's local shards with functional
collectives (:mod:`repro_torch.runtime.spmd`).

The arguments are placed by the storage rules
(:func:`repro_torch.runtime.sharding.lm_param_rules`): every weight's
``d_model`` (or, for ``wo`` / ``w2``, its output) dim over the data axes
(FSDP), heads / FFN width / vocab over ``model``; ``embed`` is ``d_model``
over ``model``; the KV heads stay whole where ``model`` does not divide
them. Every FSDP gather and every activation collective runs in fp32, as
the reference's (it converts before it gathers). Per block (``n`` =
``model``'s size; ``b`` the rank's rows):

**train** (:func:`train_loss`): the residual stream is ``(b, S, D / n)``,
``d_model`` over ``model``; the norms' sums of squares are all-reduced
over ``model``. Forward: the block's weights all-gathered over the data
axes; the normed input all-gathered over ``model`` twice (once for ``q``,
once for ``k`` / ``v``); attention on the rank's heads; the ``wo`` product
all-reduced over ``model`` and cut to the rank's ``D / n``; the FFN input
all-gathered once; the ``w2`` product all-reduced. The block is recomputed
in the backward up to its FFN activation (the reference's remat: the FSDP
and input gathers and the ``wo`` all-reduce again, no ``w2`` product).
Backward: two all-gathers of the output gradient for each of ``w2`` and
``wo``; for the FFN one all-gather of its input and one all-reduce of the
input's gradient per weight (``w1``, ``w3``); for ``q`` / ``k`` / ``v``
one of each; the weight gradients reduce-scattered over the data axes.
That is 13 all-gathers and 6 all-reduces of a ``(b, S, D)`` fp32 tensor a
block and microbatch with SwiGLU (12 and 5 with ReLU²), the reference's
counts. The reference splits the microbatches so that each rank runs all
of them, on ``B / n_data`` rows each (its HLO gathers ``s32[4, 16, 4096]``
tokens over 4 ranks): each microbatch step here runs on the rank's own
``B / n_data`` rows, the same shapes and the same mean loss.

**prefill** (:func:`prefill`): the residual is ``(b, S / n, D)``, the
sequence over ``model`` (one all-to-all after the embedding). Attention:
the normed input all-gathered over ``model`` for ``q`` (the rank's
heads), ``k`` / ``v`` from the rank's own positions (its cache block)
all-gathered over ``model``; the ``wo`` product all-reduced over ``model``
and cut to the rank's positions. The FFN on the rank's positions with its
weights all-gathered whole (over the data axes and ``model``): no
activation collective.

**decode** (:func:`decode_step`), rows over the data axes: the residual
is ``(b, 1, D / n)``; the normed input all-gathered over ``model``;
``wq``, ``w1``, ``w3`` all-gathered over the data axes; ``wk`` / ``wv``
too, or, where the data axes are as large as ``model``, their
``d_model`` rows moved from the data axes onto ``model`` by one exchange
each and the products all-reduced over ``model``; ``q``'s heads
all-gathered over ``model``, the cache's positions (over ``model``)
scored locally and the softmax's max, sum and output all-reduced over
``model``; the ``wo`` and ``w2`` products on their stored shards after an
all-gather of their inputs over the data axes, all-reduced over
``model`` and brought back to the residual's layout by an all-to-all over
the data axes. **long context** (one row, the cache over every axis): no
weight moves; every product runs on the stored shards and all-reduces
its partial sums over the dims it contracted (data axes or ``model``),
the attention over every axis.

Query heads that ``model`` does not divide (llama4's 40 on 16) run whole
on every rank of it: in training the ``wo`` product is cut to the rank's
``D / n`` and its input's gradient all-reduced over ``model``; in prefill
the ``wo`` product needs no all-reduce.

**MoE** (qwen2-moe in every sublayer, llama4 in every second; ``T`` the
microbatch's tokens, ``T_l`` the rank's, ``k`` the top-k). The routing is
the plain ``moe_ffn``'s over the ``T`` tokens as the reference's compile
sees them: the stable expert sort and the running positions over all of
them, the capacity from ``T`` (:func:`_route`). Every routed slot moves in
fp32 at full width. *train* (:func:`_moe_train`): the reference's
microbatch ``i`` is the rows of ``n_data / n_micro`` data ranks, and each
rank runs ``B / n_data`` of its rows (``n_micro`` replicas of each row,
the tokens all-gathered over the data axes, :func:`_micro_rows`). The
normed input is all-gathered over ``model``; the router's logits over the
data axes; the aux loss's mean probabilities are one small all-reduce
over them. With one data axis (the single pod) the microbatch's ``(T * k,
D)`` slot rows are all-gathered over it, each rank a piece of its own;
with several (two pods) the rank's own slot rows are all-gathered over
the replicas and the ``(E / n, C, D)`` buffer of the rank's experts
all-reduced over the microbatch's ranks. The expert inputs' products run
on the stored shards, their partial sums all-reduced over the data axes,
where the capacity exceeds ``d_model`` (qwen2-moe), else with the
weights all-gathered (llama4); ``w2`` all-gathered. The rank's slots'
outputs and the shared experts' partial sum go through one all-reduce
over ``model``, cut to the rank's ``D / n``. The whole sublayer is
recomputed in the backward. *prefill* (:func:`_moe_prefill`): the
logits all-gathered over ``model`` and the data axes; the slot rows of
the rank's rows from its positions' shares all-reduced over ``model``
(one data axis) or every token all-gathered over every rank (two pods);
the buffer of the rank's experts from its rows' slots all-reduced over
the data axes; the weights all-gathered over them; the slots' outputs
and the shared experts' partial sum all-reduced over ``model``. A dense
sublayer of an MoE config's prefill runs its FFN tensor-parallel
(:func:`_ffn_prefill_tp`), as the reference's compile does there. These
are the choices of the reference's optimized HLO on each mesh
(``scripts/dryrun_parity.py``).

The last position's logits come from the unembedding all-gathered over
the data axes (the reference's one ``f32[D, V / n]`` gather), except in
long context, where the ``(1, V / n)`` partial logits are all-reduced.
The reference's all-gathers of ``k`` / ``v`` gradients over 8 ranks and
the all-reduces inside its attention loop over pairs of ranks (a few
per cent of its bytes) are not run.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..runtime import spmd
from . import transformer as T

__all__ = ["train_loss", "prefill", "decode_step"]


# ------------------------------------------------------------------- mesh
class _Mesh:
    """The mesh's ``model`` dim and data dims, and this rank's place."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = list(mesh.mesh_dim_names)
        self.m = names.index("model")
        self.data = [i for i in range(mesh.ndim) if i != self.m]
        self.n = mesh.size(self.m)
        self.n_data = int(torch.Size([mesh.size(d) for d in self.data])
                          .numel())
        self.coord = mesh.get_coordinate()[self.m]

    def own(self, x, dim: int, dims=None):
        """The rank's block of ``x`` along ``dim`` over mesh ``dims``
        (default ``model``)."""
        dims = [self.m] if dims is None else dims
        k = int(torch.Size([self.mesh.size(d) for d in dims]).numel())
        size = x.shape[dim] // k
        return x.narrow(dim, spmd.block_of(self.mesh, dims) * size, size)


def _local(p, train: bool, same_over_model: bool = False):
    """A DTensor parameter's local shard; under training, its gradient is
    partial over every mesh dim that does not shard it (each rank adds
    its own rows' and heads' share), except over ``model`` where every
    rank computes the same from it (``same_over_model``)."""
    if not train:
        return p.to_local()
    from torch.distributed.tensor import Partial, Replicate

    return p.to_local(grad_placements=[
        q if not isinstance(q, Replicate)
        or (same_over_model and i == _Mesh(p.device_mesh).m) else Partial()
        for i, q in enumerate(p.placements)])


def _gathered_dims(p, mm: _Mesh, drop_stack: bool) -> tuple:
    """``(tensor dim, data mesh dims)`` of ``p``'s FSDP shards."""
    from torch.distributed.tensor import Shard

    out = {}
    for i, q in enumerate(p.placements):
        if type(q) is Shard and i != mm.m:
            out.setdefault(q.dim - (1 if drop_stack else 0), []).append(i)
    return tuple((d, tuple(v)) for d, v in out.items())


# -------------------------------------------------------- autograd pieces
class _Fsdp(torch.autograd.Function):
    """A weight's shard all-gathered over the data axes in fp32; backward:
    its gradient reduce-scattered back."""

    @staticmethod
    def forward(ctx, w_l, mesh, gather):
        ctx.mesh, ctx.gather, ctx.dtype = mesh, gather, w_l.dtype
        w = w_l.float()
        for d, dims in gather:
            w = spmd.all_gather(w, mesh, dims, d)
        return w

    @staticmethod
    def backward(ctx, g):
        for d, dims in reversed(ctx.gather):
            g = spmd.reduce_scatter(g, ctx.mesh, dims, d)
        return g.to(ctx.dtype), None, None


class _Sum(torch.autograd.Function):
    """An all-reduce over mesh ``dims``. Backward: an all-reduce where each
    rank uses the sum for its own part (a norm of its ``D / n``), the
    gradient as it is where every rank computes the same from it
    (``same``)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, same=False):
        ctx.args = (mesh, dims, same)
        return spmd.all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, same = ctx.args
        if not same:
            g = spmd.all_reduce(g, mesh, dims)
        return g, None, None, None


class _Gather(torch.autograd.Function):
    """An all-gather over mesh ``dims`` along ``dim``; backward: the
    gradient reduce-scattered (each block's gradient summed over the ranks
    that used it)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, dim):
        ctx.args = (mesh, dims, dim)
        return spmd.all_gather(x, mesh, dims, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, dim = ctx.args
        return spmd.reduce_scatter(g, mesh, dims, dim), None, None, None


class _ModelIn(torch.autograd.Function):
    """``x (..., D / n)`` all-gathered over ``model`` (fp32); backward: the
    gradient all-reduced over ``model`` and cut to the rank's ``D / n``."""

    @staticmethod
    def forward(ctx, x, mm):
        ctx.mm, ctx.dtype = mm, x.dtype
        return spmd.all_gather(x.float(), mm.mesh, [mm.m], x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        mm = ctx.mm
        g = spmd.all_reduce(g, mm.mesh, [mm.m])
        return mm.own(g, g.dim() - 1).to(ctx.dtype), None


class _ModelOut(torch.autograd.Function):
    """Partial sums over ``model`` all-reduced and cut to the rank's
    ``D / n`` (last dim); backward: the gradient all-gathered over
    ``model``."""

    @staticmethod
    def forward(ctx, y, mm):
        ctx.mm = mm
        y = spmd.all_reduce(y, mm.mesh, [mm.m])
        return mm.own(y, y.dim() - 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        mm = ctx.mm
        return spmd.all_gather(g, mm.mesh, [mm.m], g.dim() - 1), None


class _GradScale(torch.autograd.Function):
    """The identity; backward: the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Col(torch.autograd.Function):
    """``x (..., D / n) -> [x_full @ w for w in ws]``: the input
    all-gathered over ``model`` once per group of weights (fp32). Backward:
    the input all-gathered again and its gradient all-reduced over
    ``model`` and cut to the rank's ``D / n``: once for all the weights,
    or once per weight (``split``), as the reference's HLO does."""

    @staticmethod
    def forward(ctx, x_l, mm, groups, split, same, *ws):
        ctx.mm, ctx.split, ctx.dtype = mm, split, x_l.dtype
        ctx.same = same
        ctx.save_for_backward(x_l, *ws)
        outs = [None] * len(ws)
        for group in groups:
            xf = spmd.all_gather(x_l.float(), mm.mesh, [mm.m], x_l.dim() - 1)
            for j in group:
                outs[j] = xf @ ws[j]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        x_l, *ws = ctx.saved_tensors
        mm = ctx.mm
        last = x_l.dim() - 1

        def gather():
            xf = spmd.all_gather(x_l.float(), mm.mesh, [mm.m], last)
            return xf.reshape(-1, xf.shape[-1])

        def reduce(dx):              # every rank's heads' share, unless
            if not ctx.same:         # every rank computed the same outputs
                dx = spmd.all_reduce(dx, mm.mesh, [mm.m])
            return mm.own(dx, last)

        d_ws, dx, part = [], 0, 0
        xf = None if ctx.split else gather()
        for w, g in zip(ws, gs):
            if g is None:
                g = torch.zeros(*x_l.shape[:-1], w.shape[1], device=w.device)
            g2 = g.reshape(-1, g.shape[-1])
            d_ws.append((gather() if ctx.split else xf).T @ g2)
            gx = g @ w.T
            if ctx.split:
                dx = dx + reduce(gx)
            else:
                part = part + gx
        if not ctx.split:
            dx = reduce(part)
        return (dx.to(ctx.dtype), None, None, None, None, *d_ws)


def _col(x_l, mm, groups, split, *ws, same=False):
    """:class:`_Col`; ``same``: every rank computes the same outputs (a
    weight ``model`` does not split), so the input's gradient is not
    summed over ``model``."""
    return _Col.apply(x_l, mm, groups, split, same, *ws)


class _Row(torch.autograd.Function):
    """``a (..., K) @ w (K, D)``, all-reduced over ``model`` and cut to the
    rank's ``D / n``. Backward: the output gradient all-gathered over
    ``model`` twice (for ``a`` and for ``w``), as the reference's HLO
    does."""

    @staticmethod
    def forward(ctx, a, w, mm):
        ctx.mm = mm
        ctx.save_for_backward(a, w)
        y = spmd.all_reduce(a.float() @ w, mm.mesh, [mm.m])
        return mm.own(y, y.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        mm = ctx.mm
        last = g.dim() - 1
        da = spmd.all_gather(g, mm.mesh, [mm.m], last) @ w.T
        g2 = spmd.all_gather(g, mm.mesh, [mm.m], last)
        dw = a.float().reshape(-1, a.shape[-1]).T @ g2.reshape(-1, g2.shape[-1])
        return da.to(a.dtype), dw, None


class _RowSame(torch.autograd.Function):
    """``a (..., K) @ w (K, D)`` computed whole on every rank of ``model``
    (a ``w`` it does not split) and cut to the rank's ``D / n``. Backward:
    ``a``'s gradient from the rank's ``D / n`` all-reduced over ``model``,
    ``w``'s in the rank's columns only."""

    @staticmethod
    def forward(ctx, a, w, mm):
        ctx.mm = mm
        ctx.save_for_backward(a, w)
        return mm.own(a.float() @ w, a.dim() - 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        mm = ctx.mm
        w_own = mm.own(w, 1)
        da = spmd.all_reduce(g @ w_own.T, mm.mesh, [mm.m])
        dw = torch.zeros_like(w)
        mm.own(dw, 1).copy_(a.float().reshape(-1, a.shape[-1]).T
                            @ g.reshape(-1, g.shape[-1]))
        return da.to(a.dtype), dw, None


# --------------------------------------------------------------- helpers
def _flat(w, n_in: int):
    """``w`` as a matrix: its first ``n_in`` dims against the rest."""
    k = 1
    for s in w.shape[:n_in]:
        k *= s
    return w.reshape(k, -1)


def _norm_sharded(x, scale_l, mm, eps=1e-6):
    """:func:`~repro_torch.models.transformer.rmsnorm` of ``x`` whose last
    dim is the rank's ``D / n`` (the sum of squares all-reduced)."""
    d = x.shape[-1] * mm.n
    ss = _Sum.apply(torch.sum(torch.square(x.float()), -1, keepdim=True),
                    mm.mesh, [mm.m])
    return (x * torch.rsqrt(ss / d + eps).to(x.dtype)) * scale_l


def _own_kv(k, v, hq_l: int, cfg, mm):
    """The KV heads this rank's ``hq_l`` query heads read: the local ones
    when ``model`` splits the KV heads, all of them when the rank has
    every query head, else the block of whole KV heads its query heads map
    to (GQA's ``h // G``)."""
    if k.shape[2] * mm.n == cfg.n_kv_heads or hq_l == cfg.n_heads:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = mm.coord * hq_l
    lo, hi = h0 // g, (h0 + hq_l - 1) // g + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _attend(q, k, v, cfg):
    return T.blockwise_attention(q, k, v, q_chunk=cfg.attn_q_chunk,
                                 kv_chunk=cfg.attn_kv_chunk)


def _up(cfg, pre: str = "mlp.") -> list[str]:
    """An FFN's input weights: ``w1`` (and ``w3`` for SwiGLU)."""
    return [pre + "w1"] + ([pre + "w3"] if cfg.mlp_type == "swiglu" else [])


def _act(cfg, hs):
    """The FFN's activation of its input products ``hs`` (fp32)."""
    if cfg.mlp_type == "swiglu":
        return F.silu(hs[0]) * hs[1]
    return torch.square(F.relu(hs[0]))


def _block_weights(p, i, names, mm, train, same=()):
    """Block ``i`` of the stacked leaves ``names`` of ``p``, all-gathered
    over the data axes (fp32); under training the leaves in ``same`` are
    used alike by every rank of ``model``."""
    return {name: _Fsdp.apply(_local(p[name], train, name in same)[i],
                              mm.mesh, _gathered_dims(p[name], mm, True))
            for name in names}


# ----------------------------------------------------------------- train
def train_loss(params: dict, tokens, labels, cfg, micro: int = 0,
               n_micro: int = 1) -> torch.Tensor:
    """Mean next-token cross-entropy (plus the MoE aux loss) of the rank's
    rows (DTensor params, tokens and labels placed by the train cell's
    specs) -> the replicated loss (a plain scalar); differentiable in
    ``params``. With MoE and ``n_micro`` > 1 it is microbatch ``micro``'s
    loss: the reference's microbatch of ``B / n_micro`` rows, each rank on
    ``B / n_data`` of them (module docstring)."""
    mm = _Mesh(tokens.device_mesh)
    tok, lab = tokens.to_local(), labels.to_local()
    if cfg.moe is not None and n_micro > 1:
        tok, lab = (_micro_rows(t, mm, micro, n_micro) for t in (tok, lab))
    b, seq = tok.shape
    x = F.embedding(tok.long(), _local(params["embed"], True)).to(cfg.dtype)
    positions = torch.arange(seq, device=x.device).expand(b, seq)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(T._n_blocks(cfg)):
        for j in range(T._n_sub(cfg)):
            s = f"layers.sub{j}."
            if T._sub_uses_moe(cfg, j):
                def layer(x, i=i, s=s):
                    x = _attn_train(params, s, i, x, cfg, mm, positions)
                    return _moe_train(params, s, i, x, cfg, mm, n_micro)

                x, a = _remat(layer, x, cfg)
                aux = aux + a
                continue

            def part_a(x, i=i, s=s):
                x = _attn_train(params, s, i, x, cfg, mm, positions)
                w = _block_weights(params, i, [s + n for n in _up(cfg)], mm,
                                   True)
                h2 = _norm_sharded(x, mm.own(_local(params[s + "ln2"],
                                                    True)[i], 0), mm)
                hs = _col(h2, mm, (tuple(range(len(w))),), True, *w.values())
                return x, _act(cfg, hs).to(cfg.dtype)

            x, a = _remat(part_a, x, cfg)
            w2 = _block_weights(params, i, [s + "mlp.w2"], mm,
                                True)[s + "mlp.w2"]
            x = x + _Row.apply(a, w2, mm).to(cfg.dtype)
    x = _norm_sharded(x, mm.own(_local(params["ln_f"], True), 0), mm)
    unembed = params["unembed"]
    split = _vocab_split(unembed, mm)
    u = _Fsdp.apply(_local(unembed, True, same_over_model=not split),
                    mm.mesh, _gathered_dims(unembed, mm, False))
    (logits,) = _col(x, mm, ((0,),), False, u,
                     same=not split)                         # (b, S, V / n)
    return _vocab_nll(logits, lab, mm, split) + aux


def _remat(fn, x, cfg):
    """``fn(x)``, recomputed in the backward (``remat``) while autograd
    records."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _micro_rows(t, mm, micro: int, n_micro: int):
    """The rank's rows of microbatch ``micro``: the reference's microbatch
    ``i`` is the rows of data ranks ``[i * m, (i + 1) * m)`` (``m = n_data
    / n_micro``, flattened data index); the rank at data index ``f`` runs
    those of rank ``i * m + f % m`` (``n_micro`` replicas of each row, the
    reference's layout: it gathers the tokens over the replicas)."""
    every = spmd.all_gather(t, mm.mesh, mm.data, 0)
    m = mm.n_data // n_micro
    src = micro * m + spmd.block_of(mm.mesh, mm.data) % m
    return every[src * t.shape[0]:(src + 1) * t.shape[0]]


def _split(p, mm) -> bool:
    """Whether ``model`` splits the DTensor ``p``."""
    return p.placements[mm.m].is_shard()


def _attn_train(params, s, i, x, cfg, mm, positions):
    """The attention half of training sublayer ``s`` of block ``i`` -> the
    residual after it. Query heads ``model`` does not split run whole on
    every rank of it (:class:`_RowSame` for ``wo``)."""
    b, seq = x.shape[:2]
    split = _split(params[s + "wq"], mm)
    qkv = [s + n for n in ("wq", "wk", "wv")]
    w = _block_weights(params, i, qkv + [s + "wo"], mm, True,
                       same=() if split else qkv)
    h = _norm_sharded(x, mm.own(_local(params[s + "ln1"], True)[i], 0), mm)
    wq, wk, wv = (w[n] for n in qkv)
    q, k, v = _col(h, mm, ((0,), (1, 2)), False,
                   _flat(wq, 1), _flat(wk, 1), _flat(wv, 1), same=not split)
    q = q.reshape(b, seq, *wq.shape[1:]).to(cfg.dtype)
    k = k.reshape(b, seq, *wk.shape[1:]).to(cfg.dtype)
    v = v.reshape(b, seq, *wv.shape[1:]).to(cfg.dtype)
    if cfg.qk_norm:
        q = T._qk_norm(q, _local(params[s + "q_norm"], True, not split)[i])
        k = T._qk_norm(k, _local(params[s + "k_norm"], True, not split)[i])
    q = T.rope(q, positions, cfg.rope_theta)
    k = T.rope(k, positions, cfg.rope_theta)
    k, v = _own_kv(k, v, q.shape[2], cfg, mm)
    att = _attend(q, k, v, cfg).reshape(b, seq, -1)
    row = _Row if split else _RowSame
    return x + row.apply(att, _flat(w[s + "wo"], 2), mm).to(cfg.dtype)


def _moe_train(params, s, i, x, cfg, mm, n_micro: int):
    """The MoE half of training sublayer ``s`` of block ``i`` -> ``(the
    residual after it, the aux loss)``; the module docstring gives its
    collectives."""
    mcfg, dtype = cfg.moe, cfg.dtype
    k, e = mcfg.top_k, mcfg.n_experts
    b, seq, _ = x.shape
    t_l = b * seq
    h = _norm_sharded(x, mm.own(_local(params[s + "ln2"], True)[i], 0), mm)
    hf = _ModelIn.apply(h, mm).reshape(t_l, -1)              # (T_l, D) f32
    d = hf.shape[1]
    router = _Fsdp.apply(_local(params[s + "moe.router"], True)[i],
                         mm.mesh, _gathered_dims(params[s + "moe.router"],
                                                 mm, True))
    logits = T.matmul32(hf, router)                          # (T_l, E)
    n_min = mm.n_data // n_micro                # ranks of one microbatch
    maj, mn = divmod(spmd.block_of(mm.mesh, mm.data), n_min)
    every = _Gather.apply(logits, mm.mesh, mm.data, 0)
    t_mb = n_min * t_l
    expert, gate, pos, keep, cap = _route(every[maj * t_mb:(maj + 1) * t_mb],
                                          cfg)
    # the Switch aux loss over the microbatch's tokens
    # the gates' gradient is each rank's share of a sum over model (its
    # experts' slots); every rank of model computes the same aux loss, so
    # its gradient counts 1 / n on each
    probs = torch.softmax(_GradScale.apply(logits, 1.0 / mm.n), -1)
    p_mean = _Sum.apply(probs.sum(0), mm.mesh, mm.data, True) / (
        t_l * mm.n_data)
    f = torch.mean(F.one_hot(expert[:, 0], e).to(torch.float32), dim=0)
    aux = mcfg.aux_coef * e * torch.sum(f * p_mean)
    slot_e = expert.reshape(-1)
    e_l, e0, split = _expert_block(params[s + "moe.w1"], mm)
    mine = keep & (slot_e >= e0) & (slot_e < e0 + e_l)
    xs = hf[torch.arange(t_l * k, device=hf.device) // k]    # own slots
    piece = xs.reshape(n_micro, -1, d)[maj]
    own = slice(mn * t_l * k, (mn + 1) * t_l * k)
    if len(mm.data) == 1:
        # the microbatch's slot rows, each rank a piece: (T * k, D)
        slots = _Gather.apply(piece, mm.mesh, mm.data, 0).reshape(
            n_micro, n_min, -1, d).transpose(0, 1).reshape(-1, d)
        buf = _scatter(slots, slot_e, pos, mine, e0, e_l, cap, dtype)
    else:
        view, majd, mind = spmd.split_minor(mm.mesh, mm.data, n_min)
        rows = _Gather.apply(piece, view, majd, 0)           # (T_l * k, D)
        buf = _Sum.apply(_scatter(rows, slot_e[own], pos[own], mine[own],
                                  e0, e_l, cap, torch.float32), view, mind
                         ).to(dtype)
    a = _act(cfg, [_expert_in(buf, params[s + n], i, mm)
                   for n in _up(cfg, "moe.")])
    w2 = _Fsdp.apply(_local(params[s + "moe.w2"], True)[i], mm.mesh,
                     _gathered_dims(params[s + "moe.w2"], mm, True))
    out = T.matmul32(a.to(dtype), w2).to(dtype)
    y = _combine(out, slot_e[own], pos[own], mine[own],
                 gate.reshape(-1)[own], e0, cap, split, mm)
    parts = [y] + _shared(params, s, i, hf, cfg, mm, True)
    ys = _ModelOut.apply(torch.cat([p.float() for p in parts]), mm)
    return x + _sum_slots(ys, t_l, k, dtype).reshape(b, seq, -1), aux


def _shared(params, s, i, hf, cfg, mm, train: bool) -> list:
    """``[the shared experts' output on hf's rows]`` as the rank's share of
    a sum over ``model`` (its columns of their width, the weights
    all-gathered over the data axes), or ``[]`` without shared
    experts."""
    names = [s + "moe.shared." + n for n in ("w1", "w3", "w2")
             if s + "moe.shared." + n in params]
    if not names:
        return []
    *up, w2 = _block_weights(params, i, names, mm, train).values()
    a = _act(cfg, [T.matmul32(hf, u) for u in up]).to(cfg.dtype)
    return [_model_share(T.matmul32(a, w2).to(cfg.dtype),
                         _split(params[names[0]], mm), mm)]


def _sum_slots(ys, t_l: int, k: int, dtype):
    """``(T_l * k [+ T_l], D')`` summed slot rows (and the shared experts'
    rows) -> ``(T_l, D')``: each token's ``k`` slots, plus its shared
    output."""
    out = ys[:t_l * k].reshape(t_l, k, -1).sum(dim=1).to(dtype)
    if ys.shape[0] > t_l * k:
        out = out + ys[t_l * k:].to(dtype)
    return out


def _expert_in(buf, w, i, mm):
    """``buf (e_l, C, D) @ w`` for an expert input weight ``w`` (``d_model``
    over the data axes) in fp32, as the reference's compile chooses: where
    the capacity exceeds ``d_model``, on the stored shard (the buffer's
    block of ``d_model``) with the partial sums all-reduced over the data
    axes; else with ``w`` all-gathered over them."""
    dims = _gathered_dims(w, mm, True)
    if buf.shape[1] <= buf.shape[2] or len(dims) != 1:
        return T.matmul32(buf, _Fsdp.apply(_local(w, True)[i], mm.mesh, dims))
    ddims = list(dims[0][1])
    nb = int(torch.Size([mm.mesh.size(q) for q in ddims]).numel())
    d_l = buf.shape[2] // nb
    blk = buf.narrow(2, spmd.block_of(mm.mesh, ddims) * d_l, d_l)
    return _Sum.apply(T.matmul32(blk, _local(w, True)[i]), mm.mesh, ddims)


def _expert_block(w1, mm) -> tuple:
    """``(experts on the rank, its first expert, whether model splits
    them)`` of a stacked ``moe.w1``."""
    split = _split(w1, mm)
    e_l = w1.to_local().shape[1]
    return e_l, (mm.coord * e_l if split else 0), split


def _scatter(rows, slot_e, pos, mine, e0, e_l, cap, dtype):
    """The ``(e_l, C, D)`` buffer of the rank's experts from slot ``rows``
    (``mine``: kept slots of those experts; the others add zeros at the
    last slot, the plain ``moe_ffn``'s rule)."""
    buf = torch.zeros((e_l, cap, rows.shape[1]), dtype=dtype,
                      device=rows.device)
    return buf.index_put(
        (torch.where(mine, slot_e - e0, e_l - 1),
         torch.where(mine, pos, cap - 1)),
        torch.where(mine[:, None], rows.to(dtype), 0), accumulate=True)


def _combine(out, slot_e, pos, mine, gate, e0, cap, split, mm):
    """Each slot's output from the rank's experts, times its gate (zero for
    the other experts' and dropped slots): ``(slots, D)``, the rank's
    partial sum over ``model``."""
    y = out[torch.where(mine, slot_e - e0, 0),
            torch.clamp(pos, max=cap - 1)] * (gate[:, None] * mine[:, None])
    return _model_share(y, split, mm)


def _model_share(y, split: bool, mm):
    """``y`` as the rank's share of a sum over ``model``: as it is where
    ``model`` split the work, else rank 0's alone (every rank computed
    all of it)."""
    return y if split else y * float(mm.coord == 0)


def _vocab_split(unembed, mm) -> bool:
    """Whether ``model`` splits the vocab (it does not divide it in every
    config)."""
    return unembed.placements[mm.m].is_shard()


def _vocab_nll(logits, labels, mm, split: bool):
    """Mean cross-entropy over the valid labels of every rank; with the
    vocab over ``model`` (``split``) the max, the sum of exponentials and
    the label's logit are all-reduced over it; the token sums over the
    data axes."""
    v_l = logits.shape[-1]
    valid = labels >= 0
    if split:
        mx = spmd.all_reduce(logits.detach().amax(-1, keepdim=True),
                             mm.mesh, [mm.m], "max")
        lse = mx + torch.log(_Sum.apply(torch.exp(logits - mx).sum(
            -1, keepdim=True), mm.mesh, [mm.m], True))
        lo = mm.coord * v_l
    else:
        lse = torch.logsumexp(logits, -1, keepdim=True)
        lo = 0
    mine = valid & (labels >= lo) & (labels < lo + v_l)
    idx = torch.where(mine, labels - lo, 0).long()
    pick = torch.where(mine[..., None],
                       torch.gather(logits, -1, idx[..., None]), 0.0)
    if split:
        pick = _Sum.apply(pick, mm.mesh, [mm.m], True)
    nll = (lse - pick)[..., 0]
    tot = torch.stack([torch.sum(nll * valid), valid.sum().float()])
    tot = _Sum.apply(tot, mm.mesh, mm.data, True)
    return tot[0] / torch.clamp(tot[1], min=1)


# --------------------------------------------------------------- prefill
def prefill(params: dict, tokens, cfg, cache_spec):
    """The prompt's last-position logits ``(B, V)`` (fp32, rows over the
    data axes, vocab over ``model``) and a cache filled to ``S`` (placed by
    ``cache_spec``), from DTensor ``params`` and ``tokens``."""
    from torch.distributed.tensor import Shard

    from ..runtime.sharding import to_placements

    mm = _Mesh(tokens.device_mesh)
    tok = tokens.to_local()
    b, seq = tok.shape
    x = F.embedding(tok.long(), params["embed"].to_local()).to(cfg.dtype)
    x = spmd.all_to_all(x, mm.mesh, [mm.m], 1, 2)          # (b, S / n, D)
    pos_all = torch.arange(seq, device=x.device).expand(b, seq)
    pos_own = mm.own(pos_all, 1)
    ks, vs = [], []
    for i in range(T._n_blocks(cfg)):
        for j in range(T._n_sub(cfg)):
            s = f"layers.sub{j}."
            x, k, v = _attn_prefill(params, s, i, x, cfg, mm, pos_all,
                                    pos_own)
            ks.append(k)
            vs.append(v)
            if T._sub_uses_moe(cfg, j):
                x = _moe_prefill(params, s, i, x, cfg, mm)
            elif cfg.moe is not None:
                x = _ffn_prefill_tp(params, s, i, x, cfg, mm)
            else:
                ffn = {n.split(".")[1]: _whole(params[s + n], i, mm)
                       for n in _up(cfg) + ["mlp.w2"]}
                h2 = T.rmsnorm(x, params[s + "ln2"].to_local()[i])
                x = x + T.dense_ffn(h2, ffn, cfg)
    # the last position, from the rank holding the last block of positions
    last = x[:, -1:].float() * float(mm.coord == mm.n - 1)
    last = spmd.all_reduce(last, mm.mesh, [mm.m]).to(cfg.dtype)
    hl = T.rmsnorm(last, params["ln_f"].to_local())
    u = params["unembed"]
    u_l = _Fsdp.apply(u.to_local(), mm.mesh, _gathered_dims(u, mm, False))
    logits = T._mm32(hl.float(), u_l)[:, 0]                  # (b, V / n)
    rows = b * mm.n_data
    shape = (cfg.n_layers, rows, seq, cfg.n_kv_heads, cfg.d_head)
    cache_pl = to_placements(mm.mesh, cache_spec)
    logit_pl = [Shard(0) for _ in range(mm.mesh.ndim)]
    logit_pl[mm.m] = (Shard(1) if _vocab_split(u, mm)
                      else u.placements[mm.m])
    return (spmd.from_local(logits, mm.mesh, logit_pl, (rows, cfg.vocab)),
            {"k": spmd.from_local(torch.stack(ks), mm.mesh, cache_pl, shape),
             "v": spmd.from_local(torch.stack(vs), mm.mesh, cache_pl, shape),
             "length": torch.full((), seq, dtype=torch.int32,
                                  device=x.device)})


def _attn_prefill(params, s, i, x, cfg, mm, pos_all, pos_own):
    """The attention half of prefill sublayer ``s`` of block ``i`` ->
    ``(the residual, k, v of the rank's positions)``."""
    w = _block_weights(params, i, [s + "wq", s + "wo"], mm, False)
    # every KV head of the rank's positions (its cache block)
    w.update({s + n: _whole(params[s + n], i, mm) for n in ("wk", "wv")})
    h = T.rmsnorm(x, params[s + "ln1"].to_local()[i])
    hf = spmd.all_gather(h.float(), mm.mesh, [mm.m], 1)      # (b, S, D)
    q = T._mm32(hf, w[s + "wq"]).to(cfg.dtype)
    k = T._mm32(h, w[s + "wk"]).to(cfg.dtype)               # own positions
    v = T._mm32(h, w[s + "wv"]).to(cfg.dtype)
    if cfg.qk_norm:
        q = T._qk_norm(q, params[s + "q_norm"].to_local()[i])
        k = T._qk_norm(k, params[s + "k_norm"].to_local()[i])
    q = T.rope(q, pos_all, cfg.rope_theta)
    k = T.rope(k, pos_own, cfg.rope_theta)
    kf = spmd.all_gather(k.float(), mm.mesh, [mm.m], 1).to(cfg.dtype)
    vf = spmd.all_gather(v.float(), mm.mesh, [mm.m], 1).to(cfg.dtype)
    kf, vf = _own_kv(kf, vf, q.shape[2], cfg, mm)
    att = _attend(q, kf, vf, cfg)
    y = T._mm32(att, w[s + "wo"], 2)
    if _split(params[s + "wo"], mm):                        # the rank's heads
        y = spmd.all_reduce(y, mm.mesh, [mm.m])
    return x + mm.own(y, 1).to(cfg.dtype), k, v


def _ffn_prefill_tp(params, s, i, x, cfg, mm):
    """A dense FFN of an MoE config's prefill, as the reference's compile
    runs it there: the normed input all-gathered over ``model``, the
    weights over the data axes only (the FFN width stays over ``model``),
    the ``w2`` product all-reduced over ``model`` and cut to the rank's
    positions."""
    h = T.rmsnorm(x, params[s + "ln2"].to_local()[i])
    hf = spmd.all_gather(h.float(), mm.mesh, [mm.m], 1)      # (b, S, D)
    w = _block_weights(params, i, [s + n for n in _up(cfg) + ["mlp.w2"]],
                       mm, False)
    *up, w2 = w.values()
    a = _act(cfg, [T._mm32(hf, u) for u in up]).to(cfg.dtype)
    y = T._mm32(a, w2)
    if _split(params[s + "mlp.w2"], mm):
        y = spmd.all_reduce(y, mm.mesh, [mm.m])
    return x + mm.own(y, 1).to(cfg.dtype)


def _moe_prefill(params, s, i, x, cfg, mm):
    """The MoE half of prefill sublayer ``s`` of block ``i`` on the rank's
    positions ``x (b, S / n, D)``; the module docstring gives its
    collectives."""
    mcfg, dtype = cfg.moe, cfg.dtype
    k = mcfg.top_k
    b, s_l, d = x.shape
    t_l = b * s_l * mm.n
    h = T.rmsnorm(x, params[s + "ln2"].to_local()[i]).float()
    router = _Fsdp.apply(params[s + "moe.router"].to_local()[i], mm.mesh,
                         _gathered_dims(params[s + "moe.router"], mm, True))
    logits = T.matmul32(h.reshape(-1, d), router).reshape(b, s_l, -1)
    slot_tok = torch.arange(t_l * k, device=x.device) // k
    f_me = spmd.block_of(mm.mesh, mm.data)
    if len(mm.data) == 1:
        # the rows' slot rows, each rank its positions' share
        part = h.new_zeros((b, mm.n, s_l, d))
        part[:, mm.coord] = h
        rows = spmd.all_reduce(part.reshape(t_l, d)[slot_tok], mm.mesh,
                               [mm.m])                       # (T_l * k, D)
        hf = spmd.all_gather(h, mm.mesh, [mm.m], 1).reshape(t_l, d)
        every = spmd.all_gather(
            spmd.all_gather(logits, mm.mesh, [mm.m], 1).reshape(t_l, -1),
            mm.mesh, mm.data, 0)                             # (T, E)
    else:
        # every token over every rank: (ranks, b, S / n, .) in mesh order
        def tokens(t):
            t = spmd.all_gather(t[None], mm.mesh, mm.data + [mm.m], 0)
            t = t.reshape(mm.n_data, mm.n, b, s_l, -1).transpose(1, 2)
            return t.reshape(mm.n_data * t_l, -1)

        hf = tokens(h)[f_me * t_l:(f_me + 1) * t_l]
        rows = hf[slot_tok]
        every = tokens(logits)
    expert, gate, pos, keep, cap = _route(every, cfg)
    own = slice(f_me * t_l * k, (f_me + 1) * t_l * k)
    slot_e = expert.reshape(-1)[own]
    pos, gate = pos[own], gate.reshape(-1)[own]
    e_l, e0, split = _expert_block(params[s + "moe.w1"], mm)
    mine = keep[own] & (slot_e >= e0) & (slot_e < e0 + e_l)
    buf = spmd.all_reduce(_scatter(rows, slot_e, pos, mine, e0, e_l, cap,
                                   torch.float32), mm.mesh, mm.data)
    w = {n: _Fsdp.apply(params[s + n].to_local()[i], mm.mesh,
                        _gathered_dims(params[s + n], mm, True))
         for n in _up(cfg, "moe.") + ["moe.w2"]}
    a = _act(cfg, [T.matmul32(buf.to(dtype), w[n])
                   for n in _up(cfg, "moe.")])
    out = T.matmul32(a.to(dtype), w["moe.w2"]).to(dtype)
    parts = ([_combine(out, slot_e, pos, mine, gate, e0, cap, split, mm)]
             + _shared(params, s, i, hf, cfg, mm, False))
    ys = spmd.all_reduce(torch.cat([p.float() for p in parts]), mm.mesh,
                         [mm.m])
    y = _sum_slots(ys, t_l, k, dtype)
    return x + y.reshape(b, mm.n, s_l, d)[:, mm.coord]


def _whole(p, i, mm):
    """Block ``i`` of a stacked weight all-gathered whole in fp32: over
    the data axes, then over ``model``."""
    from torch.distributed.tensor import Shard

    gather = _gathered_dims(p, mm, True)
    q = p.placements[mm.m]
    if type(q) is Shard:
        gather = gather + ((q.dim - 1, (mm.m,)),)
    return _Fsdp.apply(p.to_local()[i], mm.mesh, gather)


# ---------------------------------------------------------------- decode
def decode_step(params: dict, cache: dict, token, cfg):
    """One decode step on DTensors placed by the decode cell's specs ->
    ``(logits (B, V) fp32, cache)``; the cache's ``k`` / ``v`` are written
    in place at the clamped slot, ``length`` grows by one. Dense and MoE
    (:func:`_moe_rows`, :func:`_moe_long`)."""
    mm = _Mesh(cache["k"].device_mesh)
    rows = not all(p.is_replicate() for p in token.placements)
    tok = token.to_local()
    emb = F.embedding(tok.long(), params["embed"].to_local())
    if rows:                                  # (b, 1, D / n), D over model
        x = emb.to(cfg.dtype)[:, None]
    else:                                     # (1, 1, D / n_data)
        x = mm.own(spmd.all_gather(emb.float(), mm.mesh, [mm.m], 1), 1,
                   mm.data).to(cfg.dtype)[:, None]
    length = cache["length"]
    length = length.to_local() if spmd.is_dtensor(length) else length
    ck_all, cv_all = cache["k"].to_local(), cache["v"].to_local()
    seq_dims = [mm.m] if rows else list(range(mm.mesh.ndim))
    n_sub = T._n_sub(cfg)
    for i in range(T._n_blocks(cfg)):
        for j in range(n_sub):
            sub = _Sub(params, f"layers.sub{j}.", i, mm)
            layer = i * n_sub + j
            x = (_attn_rows if rows else _attn_long)(
                sub, x, ck_all[layer], cv_all[layer], length, cfg, mm,
                seq_dims)
            if T._sub_uses_moe(cfg, j):
                x = (_moe_rows if rows else _moe_long)(sub, x, cfg, mm)
            else:
                x = (_ffn_rows if rows else _ffn_long)(sub, x, "mlp.", cfg,
                                                       mm)
    u = params["unembed"]
    if rows:
        h = _norm_sharded(x, mm.own(params["ln_f"].to_local(), 0), mm)
        hf = spmd.all_gather(h.float(), mm.mesh, [mm.m], 2)
        u_l = _Fsdp.apply(u.to_local(), mm.mesh, _gathered_dims(u, mm, False))
        logits = T._mm32(hf, u_l)[:, 0]                      # (b, V / n)
    else:
        h = _norm_data(x, params["ln_f"].to_local(), mm)
        logits = _data_product(h, u.to_local(), mm)[:, 0]
    length.add_(1)
    return _logits(logits, token, u, cfg, mm), cache


class _Sub:
    """Block ``i`` of one sublayer's parameters (local shards), with their
    placements' split over ``model``."""

    def __init__(self, params, prefix, i, mm):
        self.params, self.prefix, self.i, self.mm = params, prefix, i, mm

    def p(self, name):
        return self.params[self.prefix + name]

    def local(self, name):
        return self.p(name).to_local()[self.i]

    def split(self, name) -> bool:
        """Whether ``model`` splits ``name`` (its heads, FFN width or
        experts)."""
        return self.p(name).placements[self.mm.m].is_shard()

    def fsdp(self, name):
        """The block's shard all-gathered over the data axes (fp32)."""
        return _Fsdp.apply(self.local(name), self.mm.mesh,
                           _gathered_dims(self.p(name), self.mm, True))

    def has(self, name) -> bool:
        return self.prefix + name in self.params


def _exchangeable(sub, name, mm) -> bool:
    """A weight whose ``d_model`` rows (over the data axis) move onto
    ``model`` by one exchange: unsplit by ``model``, the data axis as
    large as ``model`` (the single pod)."""
    return (len(mm.data) == 1 and mm.n_data == mm.n
            and not sub.split(name))


def _in_proj(sub, name, h, hf, mm):
    """``h @ w`` for a weight whose ``d_model`` rows are over the data
    axes: rows exchanged onto ``model`` and the product all-reduced over
    it, or the weight all-gathered over the data axes (fp32) and, where
    ``model`` splits it, the product's heads or columns all-gathered over
    ``model``."""
    if _exchangeable(sub, name, mm):
        rows = _exchange(sub.local(name).float(), mm)
        return spmd.all_reduce(T._mm32(h.float(), rows), mm.mesh, [mm.m])
    out = T._mm32(hf, sub.fsdp(name))
    if sub.split(name):
        out = spmd.all_gather(out, mm.mesh, [mm.m], 2)
    return out


def _attn_rows(sub, x, ck, cv, length, cfg, mm, seq_dims):
    """Attention of one decode sublayer, rows over the data axes: the
    rank's rows, every head, the cache's positions over ``model``."""
    b = x.shape[0]
    pos = length.reshape(1, 1).expand(b, 1)
    h = _norm_sharded(x, mm.own(sub.local("ln1"), 0), mm)
    hf = spmd.all_gather(h.float(), mm.mesh, [mm.m], 2)      # (b, 1, D)
    q, k, v = (_in_proj(sub, n, h, hf, mm).to(cfg.dtype)
               for n in ("wq", "wk", "wv"))
    att = _attend_new(sub, q, k, v, ck, cv, pos, length, cfg, mm, seq_dims)
    if sub.split("wo"):
        att = mm.own(att, 2)
    return x + _stored_product(att, sub.local("wo"), 2, mm,
                               sub.split("wo")).to(cfg.dtype)


def _attend_new(sub, q, k, v, ck, cv, pos, length, cfg, mm, seq_dims):
    """qk-norm, rope, the cache write and the attention over the rank's
    cache positions (every head)."""
    if cfg.qk_norm:
        q = T._qk_norm(q, sub.local("q_norm"))
        k = T._qk_norm(k, sub.local("k_norm"))
    q = T.rope(q, pos, cfg.rope_theta)
    k = T.rope(k, pos, cfg.rope_theta)
    off = _slot_write(ck, cv, k, v, length, cfg, mm, seq_dims)
    return _attend_cache(q, ck, cv, length, off, mm, seq_dims)


def _ffn_rows(sub, x, pre, cfg, mm):
    """A dense FFN (``pre`` ``mlp.`` or ``moe.shared.``), rows over the
    data axes: ``w1`` / ``w3`` all-gathered over the data axes, ``w2`` on
    its stored shard (:func:`_stored_product`)."""
    h = _norm_sharded(x, mm.own(sub.local("ln2"), 0), mm)
    return x + _dense_rows(sub, h, pre, cfg, mm)


def _dense_rows(sub, h, pre, cfg, mm):
    hf = spmd.all_gather(h.float(), mm.mesh, [mm.m], 2)
    a = _act(cfg, [T._mm32(hf, sub.fsdp(n)) for n in _up(cfg, pre)]
             ).to(cfg.dtype)
    return _stored_product(a, sub.local(pre + "w2"), 1, mm,
                           sub.split(pre + "w2")).to(cfg.dtype)


def _slot_write(ck, cv, k, v, length, cfg, mm, seq_dims) -> int:
    """Write the new ``k`` / ``v`` (``(b, 1, ...)``) at ``min(length,
    S - 1)`` on the rank whose cache block holds that position (the others
    write their own values back) -> the block's first position."""
    s_l = ck.shape[1]
    off = spmd.block_of(mm.mesh, seq_dims) * s_l
    at = torch.clamp(length, max=cfg.max_seq_len - 1).reshape(1).long() - off
    mine = (at >= 0) & (at < s_l)
    idx = torch.clamp(at, 0, s_l - 1)
    ck.index_copy_(1, idx, torch.where(mine, k, ck.index_select(1, idx)))
    cv.index_copy_(1, idx, torch.where(mine, v, cv.index_select(1, idx)))
    return off


def _attend_cache(q, ck, cv, length, off, mm, seq_dims):
    """One token's attention over the rank's cache positions, the max, the
    sum and the weighted values all-reduced over ``seq_dims``."""
    b, s_l, hk, dh = ck.shape
    hq = q.shape[2]
    g = hq // hk
    qr = q.reshape(b * hk, g, dh) * T._scalar(dh ** -0.5, q)
    sc = T.matmul32(qr, ck.permute(0, 2, 3, 1).reshape(b * hk, dh, s_l))
    pos = torch.arange(s_l, device=q.device) + off
    sc = torch.where(pos < length + 1, sc, float("-inf"))
    m = spmd.all_reduce(sc.amax(-1, keepdim=True), mm.mesh, seq_dims, "max")
    p = torch.exp(sc - m)
    den = spmd.all_reduce(p.sum(-1, keepdim=True), mm.mesh, seq_dims)
    out = T.matmul32((p / den).to(cv.dtype),
                     cv.permute(0, 2, 1, 3).reshape(b * hk, s_l, dh))
    out = spmd.all_reduce(out, mm.mesh, seq_dims)
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _exchange(w_l, mm):
    """``w``'s ``d_model`` rows held over the data axis, moved so that the
    rank holds the block of its ``model`` coordinate: rank ``(d, m)``
    sends its block ``d`` to rank ``(m, d)``, which needs it (one exchange
    of the shard)."""
    n = mm.n
    dest = [m * n + d for d in range(n) for m in range(n)]
    return spmd.permute(w_l, mm.mesh, mm.data + [mm.m], dest)


def _stored_product(a, w_l, n_in: int, mm, split: bool):
    """``a (b, 1, K..) @ w`` on ``w``'s stored shard ``(K.., D / n_data)``:
    ``a`` all-gathered over the data axes (every row), the product
    all-reduced over ``model`` where it contracted the rank's share of
    ``K`` (``split``), and the rows' ``D`` brought back to ``(b, 1, D /
    n)`` by an all-to-all over the data axes."""
    af = spmd.all_gather(a.float(), mm.mesh, mm.data, 0)   # (B, 1, K..)
    y = T._mm32(af, w_l.float(), n_in)                       # (B, 1, D / nd)
    if split:
        y = spmd.all_reduce(y, mm.mesh, [mm.m])
    return _rows_to_residual(y, mm)


def _rows_to_residual(y, mm):
    """``(B, 1, D / n_data)`` (every row, the rank's data block of ``D``)
    -> ``(b, 1, D / n)`` (its rows, its model block): one all-to-all over
    the data axes."""
    y = spmd.all_to_all(y, mm.mesh, mm.data, 0, 2)           # (b, 1, D)
    return mm.own(y, 2)


def _logits(logits, token, unembed, cfg, mm):
    """The ``(B, V)`` logits: rows as the tokens, the vocab over ``model``
    where the unembedding splits it."""
    from torch.distributed.tensor import Shard

    pl = list(token.placements)
    pl[mm.m] = Shard(1) if _vocab_split(unembed, mm) else pl[mm.m]
    return spmd.from_local(logits, mm.mesh, pl, (token.shape[0], cfg.vocab))


# ---------------------------------------------------------- long context
def _norm_data(x, scale, mm, eps=1e-6):
    """RMS norm of ``(1, 1, D / n_data)`` rows (``D`` over the data axes):
    the sum of squares all-reduced over them."""
    d = x.shape[-1] * mm.n_data
    ss = spmd.all_reduce(torch.sum(torch.square(x.float()), -1, keepdim=True),
                         mm.mesh, mm.data)
    return (x * torch.rsqrt(ss / d + eps).to(x.dtype)) * mm.own(
        scale, 0, mm.data)


def _data_product(h, w_l, mm):
    """``h (.., D / n_data) @ w_l (D / n_data, ..)``: the rank's share of
    ``d_model`` contracted, the partial sums all-reduced over the data
    axes."""
    return spmd.all_reduce(T._mm32(h.float(), w_l.float()), mm.mesh, mm.data)


def _attn_long(sub, x, ck, cv, length, cfg, mm, seq_dims):
    """Attention of one sublayer for one row, the cache over every axis:
    the projections on the stored shards (partial sums over the data
    axes), the heads ``model`` splits all-gathered over it."""
    pos = length.reshape(1, 1).expand(1, 1)
    h = _norm_data(x, sub.local("ln1"), mm)
    qkv = []
    for n in ("wq", "wk", "wv"):
        out = _data_product(h, sub.local(n), mm)
        if sub.split(n):                          # every head
            out = spmd.all_gather(out, mm.mesh, [mm.m], 2)
        qkv.append(out.to(cfg.dtype))
    att = _attend_new(sub, *qkv, ck, cv, pos, length, cfg, mm, seq_dims)
    y = T._mm32((mm.own(att, 2) if sub.split("wo") else att).float(),
                sub.local("wo").float(), 2)
    if sub.split("wo"):
        y = spmd.all_reduce(y, mm.mesh, [mm.m])
    return x + y.to(cfg.dtype)


def _ffn_long(sub, x, pre, cfg, mm):
    h = _norm_data(x, sub.local("ln2"), mm)
    return x + _dense_long(sub, h, pre, cfg, mm)


def _dense_long(sub, h, pre, cfg, mm):
    a = _act(cfg, [_data_product(h, sub.local(n), mm)
                   for n in _up(cfg, pre)]).to(cfg.dtype)
    y = T._mm32(a.float(), sub.local(pre + "w2").float())
    if sub.split(pre + "w2"):
        y = spmd.all_reduce(y, mm.mesh, [mm.m])
    return y.to(cfg.dtype)


# ------------------------------------------------------------ MoE decode
def _route(logits, cfg):
    """Top-k experts and renormalised gates of every token (the plain
    ``moe_ffn``'s rule) and the capacity slots: ``(expert (T, k), gate
    (T, k), position in the expert (T * k,), kept (T * k,), capacity)``."""
    mcfg = cfg.moe
    t, k, e = logits.shape[0], mcfg.top_k, mcfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    gate, expert = T.stable_topk(probs, k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    cap = T.moe_capacity(t, mcfg)
    slot_e = expert.reshape(-1)
    order = torch.argsort(slot_e, stable=True)
    se_sorted = slot_e[order]
    counts = torch.zeros(e, dtype=torch.long, device=logits.device
                         ).scatter_add_(0, slot_e, torch.ones_like(slot_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=logits.device) - starts[se_sorted]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return expert, gate, pos, pos < cap, cap


def _experts(xs, expert, gate, pos, keep, cap, sub, cfg, mm, dtype):
    """The routed experts on the rank's own (``model``) experts: slots of
    tokens ``xs (T, D / n_data)`` (the rank's data block of ``d_model``)
    placed in an ``(E / n, C, D / n_data)`` buffer, the expert products on
    the stored shards (the hidden all-reduced over the data axes), each
    slot's output read back and all-reduced over ``model`` -> ``(T,
    D / n_data)``."""
    t, k = expert.shape
    e_l = sub.local("moe.w1").shape[0]
    e0 = mm.coord * e_l if sub.split("moe.w1") else 0
    slot_e = expert.reshape(-1)
    mine = keep & (slot_e >= e0) & (slot_e < e0 + e_l)
    tok = torch.arange(t * k, device=xs.device) // k
    buf = _scatter(xs[tok], slot_e, pos, mine, e0, e_l, cap, dtype)
    a = _act(cfg, [spmd.all_reduce(T.matmul32(buf, sub.local(n)), mm.mesh,
                                   mm.data) for n in _up(cfg, "moe.")])
    out = T.matmul32(a.to(dtype), sub.local("moe.w2")).to(dtype)
    y = _combine(out, slot_e, pos, mine, gate.reshape(-1), e0, cap, True, mm)
    if sub.split("moe.w1"):
        y = spmd.all_reduce(y.float(), mm.mesh, [mm.m])
    return y.reshape(t, k, -1).sum(dim=1).to(dtype)


def _router(sub, h, hf, mm):
    """The router's logits of the rank's tokens (its ``d_model`` rows over
    the data axes, like ``wk``)."""
    if _exchangeable(sub, "moe.router", mm):
        rows = _exchange(sub.local("moe.router").float(), mm)
        return spmd.all_reduce(T._mm32(h.float(), rows), mm.mesh, [mm.m])
    return T._mm32(hf, sub.fsdp("moe.router"))


def _moe_rows(sub, x, cfg, mm):
    """An MoE sublayer, rows over the data axes: every token's routing
    (the rank's logits all-gathered over the data axes), the routed
    experts on the rank's experts (:func:`_experts`, tokens' ``d_model``
    over the data axes) and the shared experts as a dense FFN."""
    h = _norm_sharded(x, mm.own(sub.local("ln2"), 0), mm)
    hf = spmd.all_gather(h.float(), mm.mesh, [mm.m], 2)     # (b, 1, D)
    logits = _router(sub, h, hf, mm)[:, 0]                   # (b, E)
    logits = spmd.all_gather(logits, mm.mesh, mm.data, 0)    # (T, E)
    # every token's data block of d_model: (T, D / n_data)
    xs = spmd.all_to_all(hf[:, 0], mm.mesh, mm.data, 1, 0)
    y = _experts(xs, *_route(logits, cfg), sub, cfg, mm, cfg.dtype)
    y = _rows_to_residual(y[:, None], mm)
    if sub.has("moe.shared.w1"):
        y = y + _dense_rows(sub, h, "moe.shared.", cfg, mm)
    return x + y.to(cfg.dtype)


def _moe_long(sub, x, cfg, mm):
    """An MoE sublayer for one row (``d_model`` over the data axes): the
    router and the experts on the stored shards."""
    h = _norm_data(x, sub.local("ln2"), mm)
    logits = _data_product(h, sub.local("moe.router"), mm)[:, 0]
    y = _experts(h[:, 0], *_route(logits, cfg), sub, cfg, mm, cfg.dtype)
    y = y[:, None]
    if sub.has("moe.shared.w1"):
        y = y + _dense_long(sub, h, "moe.shared.", cfg, mm)
    return x + y.to(cfg.dtype)
