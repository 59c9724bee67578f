"""The four recsys architectures on PyTorch: DLRM, BST, AutoInt, MIND (port
of :mod:`repro.models.recsys`).

Each architecture is one ``nn.Module`` whose parameters sit in a
``ParameterDict`` under the reference's names and shapes (``bot_w0``,
``table_3``, ``blk0_wq``, ...), so :func:`from_reference_params` carries
the reference's ``*_init`` dict across as it is and both packages compute
the same function. Forwards and losses; their gradients come from
autograd (``repro_torch.configs.common.recsys_train_step``).

* **DLRM** [arXiv:1906.00091]: bottom MLP on the dense features, one
  embedding per sparse field (a gather one-hot; the CUDA ``embed_bag``
  kernel multi-hot), dot interaction over the strictly lower triangle, top
  MLP -> logit.
* **BST** [arXiv:1905.06874]: item + position embeddings, transformer
  blocks over [history, target] (scale-only layer norm with the population
  variance and eps 1e-6, as the reference), flatten -> MLP.
* **AutoInt** [arXiv:1810.11921]: field embeddings, stacked multi-head
  self-attention interacting layers with residuals, flatten -> logit.
* **MIND** [arXiv:1904.08030]: behaviour-to-interest capsule routing; at
  serving the interests are the sources of evidence of the paper's dynamic
  weighted aggregation (:func:`retrieval_scores`).

The reference draws MIND's routing logits inside the forward from
``jax.random.PRNGKey(17)`` at the batch's history length; a torch generator
cannot replay that draw, so :class:`MIND` holds them as a buffer for
``cfg.hist_len`` (drawn from a ``torch.Generator`` seeded 17, or the
reference's draw passed to :func:`from_reference_params`) and a batch of
another length raises.

Every matrix product accumulates in fp32 and casts back to the input's
dtype, as the reference's ``preferred_element_type=jnp.float32``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.common import resolve_device
from ..runtime.trace import span
from .embedding import (EmbedTablesConfig, embed_bag, gather_rows, init_tables,
                        lookup, table_specs)

__all__ = [
    "DLRMConfig", "BSTConfig", "AutoIntConfig", "MINDConfig",
    "DLRM", "BST", "AutoInt", "MIND",
    "param_specs", "from_reference_params", "with_params",
    "dlrm_loss", "bst_loss", "autoint_loss", "mind_loss",
    "retrieval_scores", "bce_with_logits", "LEAKY_SLOPE",
]

# jax.nn.leaky_relu's default slope (BST's feed-forward), stated rather than
# left to torch's default.
LEAKY_SLOPE = 0.01


def bce_with_logits(logits, labels):
    logits = logits.float()
    return torch.mean(
        F.relu(logits) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def _mm32(x, w):
    """``x @ w`` accumulated in fp32, cast back to ``x``'s dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _mlp_specs(dims, prefix):
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}_w{i}"] = (a, b)
        out[f"{prefix}_b{i}"] = (b,)
    return out


# ----------------------------------------------------------------- configs
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    vocab_sizes: tuple[int, ...] = ()
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (13, 512, 256, 128)
    top_mlp_hidden: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def tables(self) -> EmbedTablesConfig:
        return EmbedTablesConfig(self.vocab_sizes, self.embed_dim)

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_mlp(self) -> tuple[int, ...]:
        return (self.n_interact + self.embed_dim,) + self.top_mlp_hidden


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 4_000_000
    embed_dim: int = 32
    seq_len: int = 20            # history length; sequence is hist + target
    n_blocks: int = 1
    n_heads: int = 8
    mlp: tuple[int, ...] = (1024, 512, 256)
    dtype = torch.float32

    @property
    def full_seq(self) -> int:
        return self.seq_len + 1


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    vocab_sizes: tuple[int, ...] = (100_000,) * 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    dtype = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def tables(self) -> EmbedTablesConfig:
        return EmbedTablesConfig(self.vocab_sizes, self.embed_dim)


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0           # label-aware attention sharpness
    dtype = torch.float32


def param_specs(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter name -> shape, the reference's ``*_param_specs``."""
    if isinstance(cfg, DLRMConfig):
        specs = {n: s.shape for n, s in table_specs(cfg.tables).items()}
        return specs | _mlp_specs(cfg.bot_mlp, "bot") | _mlp_specs(
            cfg.top_mlp, "top")
    if isinstance(cfg, BSTConfig):
        e = cfg.embed_dim
        specs = {"item_emb": (cfg.n_items, e), "pos_emb": (cfg.full_seq, e)}
        for b in range(cfg.n_blocks):
            specs |= {
                f"blk{b}_wq": (e, e), f"blk{b}_wk": (e, e),
                f"blk{b}_wv": (e, e), f"blk{b}_wo": (e, e),
                f"blk{b}_ln1": (e,), f"blk{b}_ln2": (e,),
                f"blk{b}_ff_w0": (e, 4 * e), f"blk{b}_ff_b0": (4 * e,),
                f"blk{b}_ff_w1": (4 * e, e), f"blk{b}_ff_b1": (e,),
            }
        return specs | _mlp_specs((cfg.full_seq * e,) + cfg.mlp + (1,),
                                  "head")
    if isinstance(cfg, AutoIntConfig):
        specs = {n: s.shape for n, s in table_specs(cfg.tables).items()}
        d_in = cfg.embed_dim
        for l in range(cfg.n_attn_layers):
            specs |= {f"attn{l}_{w}": (d_in, cfg.d_attn)
                      for w in ("wq", "wk", "wv", "wres")}
            d_in = cfg.d_attn
        return specs | {"out_w": (cfg.n_fields * cfg.d_attn, 1),
                        "out_b": (1,)}
    if isinstance(cfg, MINDConfig):
        e = cfg.embed_dim
        return {"item_emb": (cfg.n_items, e), "bilinear": (e, e)}
    raise TypeError(f"not a recsys config: {type(cfg).__name__}")


class _Recsys(nn.Module):
    """Parameters under the reference's names, on ``device`` (the card
    unless the caller asks for the CPU), initialised by the reference's
    rules from ``generator`` (default: seed 0 on the device): biases zero,
    weights ``N(0, 1/fan_in)``, embedding tables ``N(0, 1/E)``."""

    def __init__(self, cfg, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        specs = param_specs(cfg)
        tables = {}
        if hasattr(cfg, "tables"):
            tables = init_tables(cfg.tables, generator, device=dev)
        self.p = nn.ParameterDict({
            name: nn.Parameter(tables[name] if name in tables
                               else self._init(name, shape, generator, dev))
            for name, shape in sorted(specs.items())
        })

    def _init(self, name, shape, generator, dev):
        if "_b" in name or name.endswith("bias"):
            return torch.zeros(shape, dtype=self.cfg.dtype, device=dev)
        fan_in = shape[0] if len(shape) >= 2 else 1
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * (1.0 / max(fan_in, 1)) ** 0.5).to(dev, self.cfg.dtype)

    @property
    def device(self) -> torch.device:
        return next(iter(self.p.values())).device

    def _mlp(self, x, n, prefix, final_act=False):
        for i in range(n):
            x = _mm32(x, self.p[f"{prefix}_w{i}"]) + self.p[f"{prefix}_b{i}"]
            if i < n - 1 or final_act:
                x = F.relu(x)
        return x


class DLRM(_Recsys):
    """``forward(dense (B, n_dense), sparse (B, F) or (B, F, M)) -> (B,)``
    logits. ``(B, F)`` and ``(B, F, 1)`` gather one row per field; only
    ``(B, F, M > 1)`` goes through ``embed_bag`` (sum), one launch per
    field."""

    def forward(self, dense, sparse):
        cfg = self.cfg
        x = self._mlp(dense.to(cfg.dtype), len(cfg.bot_mlp) - 1, "bot",
                      final_act=True)                            # (B, E)
        if sparse.dim() == 3 and sparse.shape[-1] > 1:
            emb = torch.stack([
                embed_bag(self.p[f"table_{i}"], sparse[:, i], combiner="sum")
                for i in range(cfg.n_sparse)
            ], dim=1)
        else:
            ids = sparse[..., 0] if sparse.dim() == 3 else sparse
            emb = lookup(self.p, ids)                             # (B, F, E)
        feats = torch.cat([x[:, None, :], emb], dim=1)            # (B, F+1, E)
        f32 = feats.float()
        z = torch.bmm(f32, f32.transpose(1, 2))                   # (B, F+1, F+1)
        f = feats.shape[1]
        # np.tril_indices(f, k=-1): the strictly lower triangle, row-major
        iu, ju = torch.tril_indices(f, f, offset=-1, device=z.device)
        inter = z[:, iu, ju].to(cfg.dtype)                        # (B, F(F-1)/2)
        top_in = torch.cat([inter, x], dim=-1)
        return self._mlp(top_in, len(cfg.top_mlp) - 1, "top")[:, 0]


def _layernorm(x, scale):
    """Scale-only layer norm: population variance, eps 1e-6 (the
    reference's ``jnp.var``; not ``nn.LayerNorm``, which has a bias and
    eps 1e-5)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _mha(x, wq, wk, wv, wo, n_heads):
    b, s, e = x.shape
    dh = e // n_heads
    q = (x @ wq).reshape(b, s, n_heads, dh)
    k = (x @ wk).reshape(b, s, n_heads, dh)
    v = (x @ wv).reshape(b, s, n_heads, dh)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
    pr = torch.softmax(sc, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, s, e)
    return o @ wo


class BST(_Recsys):
    """``forward(hist (B, L) item ids with -1 padding, target (B,)) ->
    (B,)`` logits."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__(cfg, generator=generator, device=device)
        with torch.no_grad():
            for b in range(cfg.n_blocks):
                self.p[f"blk{b}_ln1"].fill_(1.0)
                self.p[f"blk{b}_ln2"].fill_(1.0)

    def forward(self, hist, target):
        cfg, p = self.cfg, self.p
        seq = torch.cat([hist, target[:, None]], dim=1)           # (B, L+1)
        valid = seq >= 0
        emb = gather_rows(p["item_emb"], torch.where(valid, seq, 0))
        emb = torch.where(valid[..., None], emb, 0).to(cfg.dtype)
        x = emb + p["pos_emb"][None]
        for bk in range(cfg.n_blocks):
            h = _mha(_layernorm(x, p[f"blk{bk}_ln1"]), p[f"blk{bk}_wq"],
                     p[f"blk{bk}_wk"], p[f"blk{bk}_wv"], p[f"blk{bk}_wo"],
                     cfg.n_heads)
            x = x + h
            h = _layernorm(x, p[f"blk{bk}_ln2"])
            h = F.leaky_relu(h @ p[f"blk{bk}_ff_w0"] + p[f"blk{bk}_ff_b0"],
                             negative_slope=LEAKY_SLOPE)
            x = x + (h @ p[f"blk{bk}_ff_w1"] + p[f"blk{bk}_ff_b1"])
        flat = x.reshape(x.shape[0], -1)
        return self._mlp(flat, len(cfg.mlp) + 1, "head")[:, 0]


class AutoInt(_Recsys):
    """``forward(sparse (B, F) field ids) -> (B,)`` logits."""

    def forward(self, sparse):
        cfg, p = self.cfg, self.p
        x = lookup(p, sparse).to(cfg.dtype)                       # (B, F, E)
        h = cfg.n_heads
        dh = cfg.d_attn // h
        for l in range(cfg.n_attn_layers):
            q = (x @ p[f"attn{l}_wq"]).reshape(*x.shape[:2], h, dh)
            k = (x @ p[f"attn{l}_wk"]).reshape(*x.shape[:2], h, dh)
            v = (x @ p[f"attn{l}_wv"]).reshape(*x.shape[:2], h, dh)
            sc = torch.einsum("bfhd,bghd->bhfg", q.float(),
                              k.float()) * dh ** -0.5
            pr = torch.softmax(sc, dim=-1).to(x.dtype)
            o = torch.einsum("bhfg,bghd->bfhd", pr, v)
            o = o.reshape(*x.shape[:2], cfg.d_attn)
            x = F.relu(o + x @ p[f"attn{l}_wres"])
        flat = x.reshape(x.shape[0], -1)
        return (flat @ p["out_w"] + p["out_b"])[:, 0]


def _squash(s):
    n2 = torch.sum(torch.square(s), -1, keepdim=True)
    return (n2 / (1.0 + n2)) * s * torch.rsqrt(n2 + 1e-9)


class MIND(_Recsys):
    """``forward(hist (B, L) with -1 padding) -> interests (B, K, E)``:
    dynamic-routing behaviour-to-interest capsules. The routing logits are
    a fixed random init (per the paper) updated by agreement for
    ``capsule_iters`` rounds; only the bilinear map is learned."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__(cfg, generator=generator, device=device)
        logits = torch.randn((1, cfg.n_interests, cfg.hist_len),
                             generator=torch.Generator().manual_seed(17))
        self.register_buffer("routing_logits", logits.to(self.device))

    def _init(self, name, shape, generator, dev):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * self.cfg.embed_dim ** -0.5).to(dev, self.cfg.dtype)

    def set_routing_logits(self, logits) -> None:
        """Replace the routing logits (e.g. with the reference's draw at
        ``cfg.hist_len``): shape ``(K, hist_len)`` or ``(1, K, hist_len)``."""
        want = tuple(self.routing_logits.shape)
        t = torch.tensor(np.asarray(logits), dtype=torch.float32)
        t = t.reshape((1,) + tuple(t.shape)) if t.dim() == 2 else t
        if tuple(t.shape) != want:
            raise ValueError(f"routing logits must be {want} (1, K, "
                             f"hist_len), got {tuple(t.shape)}")
        self.routing_logits = t.to(self.device)

    def forward(self, hist):
        with span("model.mind"):
            return self._forward(hist)

    def _forward(self, hist):
        cfg, p = self.cfg, self.p
        b, l = hist.shape
        if l != self.routing_logits.shape[-1]:
            raise ValueError(
                f"MIND holds routing logits for history length "
                f"{self.routing_logits.shape[-1]}, the batch has {l}: the "
                f"reference draws them at the batch's length, which a torch "
                f"generator cannot replay; pass that draw through "
                f"from_reference_params(routing_logits=) with a config of "
                f"hist_len={l}")
        valid = hist >= 0
        emb = gather_rows(p["item_emb"], torch.where(valid, hist, 0))
        emb = torch.where(valid[..., None], emb, 0).to(cfg.dtype)
        u_hat = emb @ p["bilinear"]                               # (B, L, E)
        logits = _over_rows(hist, self.routing_logits, (b, cfg.n_interests, l))
        u_stop = u_hat.detach()
        mask = valid[:, None, :].to(torch.float32)
        for it in range(cfg.capsule_iters):
            c = torch.softmax(logits, dim=1)                      # over interests
            c = c * mask                                          # drop padding
            u = u_hat if it == cfg.capsule_iters - 1 else u_stop
            s = torch.einsum("bkl,ble->bke", c.to(u.dtype).float(), u.float())
            v = _squash(s)                                        # (B, K, E)
            if it < cfg.capsule_iters - 1:
                logits = logits + torch.einsum(
                    "bke,ble->bkl", v.to(u_stop.dtype).float(),
                    u_stop.float())
        return v.to(cfg.dtype)


def _over_rows(x, t, shape):
    """``t`` broadcast to ``shape`` over the batch rows of ``x``: where
    ``x`` is a DTensor whose rows only are sharded, a DTensor over each
    rank's own rows, so the per-row work runs on those rows only."""
    if type(x).__name__ != "DTensor" or any(
            p.dim != 0 for p in x.placements if p.is_shard()):
        return t.expand(shape)
    from ..runtime import spmd

    local = t.expand(x.to_local().shape[0], *shape[1:])
    return spmd.from_local(local, x.device_mesh, x.placements, shape)


_MODELS = {DLRMConfig: DLRM, BSTConfig: BST, AutoIntConfig: AutoInt,
           MINDConfig: MIND}


def with_params(cfg, params: Mapping[str, torch.Tensor]) -> _Recsys:
    """The model of ``cfg`` around the given tensors (by the reference's
    names), drawing nothing: the dry-run's cells hold their parameters as
    DTensors on fake storage. MIND's routing logits are the port's draw
    (seed 17), on the CPU."""
    cls = _MODELS[type(cfg)]
    model = cls.__new__(cls)
    nn.Module.__init__(model)
    model.cfg = cfg
    if set(params) != set(param_specs(cfg)):
        raise KeyError(f"parameters do not match {cfg.name}")
    model.p = dict(sorted(params.items()))    # the caller's tensors as they are
    if cls is MIND:
        model.register_buffer("routing_logits", torch.randn(
            (1, cfg.n_interests, cfg.hist_len),
            generator=torch.Generator().manual_seed(17)))
    return model


def from_reference_params(cfg, params: Mapping[str, np.ndarray], *,
                          routing_logits=None, device=None) -> _Recsys:
    """The port's module holding the reference's ``*_init`` parameters
    (numpy arrays by the reference's names), so both packages compute the
    same function. ``routing_logits`` (MIND only) is the reference's draw
    ``jax.random.normal(PRNGKey(17), (1, K, hist_len))``."""
    model = _MODELS[type(cfg)](cfg, device=device)
    have, got = set(model.p.keys()), set(params)
    if have != got:
        raise KeyError(f"parameters do not match {cfg.name}: missing "
                       f"{sorted(have - got)}, unexpected {sorted(got - have)}")
    with torch.no_grad():
        for name, value in params.items():
            t = torch.tensor(np.asarray(value))
            if tuple(t.shape) != tuple(model.p[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(model.p[name].shape)}")
            model.p[name].copy_(t)
    if routing_logits is not None:
        if not isinstance(model, MIND):
            raise ValueError("routing_logits= is for MIND only")
        model.set_routing_logits(routing_logits)
    return model


def dlrm_loss(model: DLRM, batch):
    return bce_with_logits(model(batch["dense"], batch["sparse"]),
                           batch["label"])


def bst_loss(model: BST, batch):
    return bce_with_logits(model(batch["hist"], batch["target"]),
                           batch["label"])


def autoint_loss(model: AutoInt, batch):
    return bce_with_logits(model(batch["sparse"]), batch["label"])


def mind_loss(model: MIND, batch):
    """Label-aware attention training: attend interests by the target
    item."""
    cfg = model.cfg
    interests = model(batch["hist"])                              # (B, K, E)
    tgt = gather_rows(model.p["item_emb"], batch["target"])       # (B, E)
    att = torch.einsum("bke,be->bk", interests.float(), tgt.float())
    w = torch.softmax(cfg.pow_p * att, dim=-1)
    user = torch.einsum("bk,bke->be", w.to(cfg.dtype), interests)
    logit = torch.sum(user * tgt, dim=-1)
    return bce_with_logits(logit, batch["label"])


def retrieval_scores(user_vecs, item_table, *, weights=None):
    """Score user vector(s) against every candidate item (retrieval_cand).

    ``user_vecs`` (B, E) or (B, K, E) multi-interest; ``weights`` (B, K)
    optional dynamic interest weights (the paper's aggregation, reduced per
    §4). Returns (B, n_items) fp32 scores; without weights a multi-interest
    user takes the max over its interests (MIND's serving default)."""
    items = item_table.float()
    if user_vecs.dim() == 2:
        return user_vecs.float() @ items.T
    s = torch.einsum("bke,ne->bkn", user_vecs.float(), items)
    if weights is None:
        return s.amax(dim=1)
    return torch.einsum("bk,bkn->bn", weights.to(s.dtype), s)
