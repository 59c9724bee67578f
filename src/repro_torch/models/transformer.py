"""Decoder-only LM family on PyTorch: dense + MoE, GQA, RoPE, qk-norm,
SwiGLU / ReLU² (port of :mod:`repro.models.transformer`).

One config covers the five LM architectures (llama4-maverick, qwen2-moe,
mistral-large-123b, minitron-8b, qwen3-8b). :class:`Transformer` holds the
parameters under the reference's tree paths joined by dots (``embed``,
``layers.sub0.wq``, ``layers.sub0.moe.shared.w1``, ``ln_f``, ``unembed``);
every layer parameter keeps the reference's stacked ``(n_blocks, ...)``
leading dim, so one name is one reference leaf and
:func:`from_reference_params` carries the reference's tree across as it
is. The functions take the module (or a flat name -> tensor mapping, or
for the layer functions the reference's nested dict) plus tensors, and
compute the reference's function:

* the reference's ``lax.scan`` over stacked blocks is a Python loop over
  the blocks; ``remat`` is ``torch.utils.checkpoint`` per block, and only
  while autograd records;
* blockwise (flash-style) attention in plain PyTorch, scanning every kv
  block, fully masked ones included, as the reference does;
* MoE by sort-based capacity dispatch into an ``(E, C, D)`` buffer, a
  dense expert product, gather and combine; ties in the router's top-k go
  to the lower expert (``lax.top_k``'s rule) and the slot sort is stable;
* every product accumulates in fp32 and returns fp32
  (:func:`matmul32`, the reference's ``preferred_element_type``); the
  storage dtype decides where results are cast back, as in the reference.

``use_specs`` (optional on :func:`forward`, :func:`loss_fn` and
:func:`prefill`, as in the reference) maps ``layers.sub<i>.<leaf>`` and
``unembed`` to their USE partition specs
(:func:`repro_torch.runtime.sharding.lm_use_rules`), plus optionally
``residual`` (the residual stream's spec after each block) and ``cache``
(prefill's KV cache spec). With DTensor parameters each block's weights
are redistributed to their use placements right before the block runs:
the ZeRO-3 per-layer gather (autograd reduce-scatters the gradients
back); attention then runs on DTensors op by op. On plain tensors it
changes nothing. (The dry-run's LM cells run the rank-local programs of
:mod:`repro_torch.models.transformer_spmd` instead.)

The decode path updates the cache's tensors in place (a functional update
would copy the whole cache every step). At a full cache the reference's
``dynamic_update_slice`` clamps its start, so the new token overwrites the
last slot and ``length`` reads ``max_seq_len + 1``; the port keeps that.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..core.engine import stable_topk
from ..kernels.common import resolve_device

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "Transformer",
    "init_params",
    "from_reference_params",
    "param_specs",
    "forward",
    "loss_fn",
    "init_cache",
    "prefill",
    "decode_step",
    "blockwise_attention",
    "decode_attention",
    "moe_ffn",
    "dense_ffn",
    "rmsnorm",
    "rope",
    "matmul32",
    "count_params",
    "active_params",
]


# --------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8               # routed experts (padded to mesh multiple)
    top_k: int = 1
    d_expert: int = 1408             # per-expert FFN width
    n_shared: int = 0                # shared-expert multiplier (0 = none)
    moe_every: int = 1               # MoE layer every N layers (1 = all)
    capacity_factor: float = 1.25
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 64
    d_ff: int = 512
    vocab: int = 1024
    qk_norm: bool = False
    mlp_type: str = "swiglu"         # swiglu | relu2
    moe: MoEConfig | None = None
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.float32   # param/activation storage dtype
    remat: bool = True
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    max_seq_len: int = 4096

    @property
    def n_q_per_kv(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        return self.n_heads // self.n_kv_heads


# ------------------------------------------------------------------ products
def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) accumulated in fp32, returned in
    fp32: the reference's ``einsum(..., preferred_element_type=f32)``.

    On the card (and on the dry-run's fake tensors, which trace the card's
    program) a bf16 product calls cuBLAS with fp32 accumulation and an
    fp32 output (``out_dtype``), no copy of either operand. That overload
    has no derivative and no CPU kernel, so on the CPU, and on the card
    while autograd records, both operands are upcast to fp32 first: the
    products of bf16 values are exact in fp32, so this is the same
    function, and its backward casts the gradients back to the storage
    dtype, as the reference's transpose does."""
    op = torch.mm if a.dim() == 2 else torch.bmm
    if a.dtype == b.dtype == torch.float32:
        return op(a, b)
    if ((a.is_cuda or _fake(a)) and a.dtype == b.dtype and not (
            torch.is_grad_enabled() and (a.requires_grad or b.requires_grad))):
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


def _fake(x) -> bool:
    """A fake tensor (the dry-run's local shards): it runs no kernel, so it
    takes the card's overload."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


def _mm32(x, w, n_contract: int = 1):
    """Contract the last ``n_contract`` dims of ``x`` with the first of
    ``w`` in fp32: ``(..., *K) x (*K, *N) -> (..., *N)``."""
    k = int(np.prod(w.shape[:n_contract]))
    out = matmul32(x.reshape(-1, k), w.reshape(k, -1))
    return out.reshape(*x.shape[:x.dim() - n_contract], *w.shape[n_contract:])


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar in ``like``'s dtype, as JAX rounds a weakly typed
    scalar to the array's dtype before the product."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------- layers
def rmsnorm(x, scale, eps=1e-6):
    """Variance in fp32; ``rsqrt`` cast to ``x.dtype`` before the product
    with ``x``, then ``scale`` (the reference's order, which decides the
    bf16 rounding)."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x, positions, theta):
    """Rotary embedding, half-split. x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)         # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _qk_norm(x, scale):
    """Per-head RMS norm of q/k (Qwen3). x: (..., H, dh), scale: (dh,)."""
    return rmsnorm(x, scale, 1e-6)


def blockwise_attention(q, k, v, *, q_chunk, kv_chunk, causal=True):
    """Flash-style attention, O(S·chunk) memory. q (B,S,Hq,dh), kv (B,T,Hk,dh).

    Outer loop over q blocks, inner loop over every kv block with running
    (max, denom, acc) in fp32. GQA folds the q heads as (Hk, G): q head
    ``h`` reads kv head ``h // G``. ``q`` is scaled in its own dtype; S and
    T are zero-padded to chunk multiples (padded kv columns sit beyond
    every causal cone, padded q rows are sliced off).
    """
    b, s, hq, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = _scalar(dh ** -0.5, q)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    s_orig = s
    s_pad = (-s) % q_chunk
    t_pad = (-t) % kv_chunk
    if s_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad))
        s += s_pad
    if t_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad))
        t += t_pad
    nq, nk = s // q_chunk, t // kv_chunk

    qh = q.reshape(b, s, hk, g, dh).permute(0, 2, 3, 1, 4)   # (B,Hk,G,S,dh)
    kh = k.permute(0, 2, 1, 3).reshape(b * hk, t, dh)
    vh = v.permute(0, 2, 1, 3).reshape(b * hk, t, dh)
    rows = (b * hk, g * q_chunk)
    outs = []
    for qi in range(nq):
        qb = (qh[:, :, :, qi * q_chunk:(qi + 1) * q_chunk] * scale).reshape(
            b * hk, g * q_chunk, dh)
        # a row of a block is (g, position in the block): its q position
        q_pos = (qi * q_chunk + torch.arange(q_chunk, device=q.device)).repeat(g)
        m = torch.full(rows, float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros(rows, dtype=torch.float32, device=q.device)
        acc = torch.zeros((*rows, dh), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            kb = kh[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = vh[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            sblk = matmul32(qb, kb.transpose(1, 2))           # (B·Hk, G·Qc, Tc)
            if causal:
                k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
                sblk = torch.where(q_pos[:, None] >= k_pos[None, :], sblk,
                                   float("-inf"))
            m_new = torch.maximum(m, sblk.amax(dim=-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sblk - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         float("-inf")))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + matmul32(p.to(v.dtype), vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).reshape(b, hk, g, q_chunk, dh))
    out = torch.cat(outs, dim=3).reshape(b, hq, s, dh).transpose(1, 2)
    return out[:, :s_orig]


def decode_attention(q, ck, cv, length):
    """One-token attention over the whole KV cache, masked to ``pos <
    length``. q: (B, 1, Hq, dh); ck/cv: (B, S, Hk, dh); length: () int."""
    b, s, hk, dh = ck.shape
    hq = q.shape[2]
    g = hq // hk
    qr = q.reshape(b * hk, g, dh) * _scalar(dh ** -0.5, q)
    scores = matmul32(qr, ck.permute(0, 2, 3, 1).reshape(b * hk, dh, s))
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos < length, scores, float("-inf"))  # (B·Hk, G, S)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = matmul32((p / l).to(cv.dtype),
                   cv.permute(0, 2, 1, 3).reshape(b * hk, s, dh))
    return out.reshape(b, 1, hq, dh).to(q.dtype)


# ------------------------------------------------------------------------ MoE
def moe_capacity(t: int, mcfg: MoEConfig) -> int:
    """Slots per expert for ``t`` tokens: ``ceil(t·k·cf / E)`` rounded up
    to a multiple of 8, at least 8."""
    cap = int(np.ceil(t * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts))
    return max(8, -(-cap // 8) * 8)


def moe_ffn(x2d, p, cfg: TransformerConfig, mcfg: MoEConfig):
    """Sort-based capacity-dispatch MoE. x2d: (T, D) -> (T, D), aux loss ().

    1. router top-k (ties to the lower expert), softmax gates renormalised;
    2. flatten the (T·k) slots, sort them by expert (stable), position in
       the expert by running offset, drop beyond capacity;
    3. scatter-add into (E, C, D) (dropped slots add zeros at (E-1, C-1)),
       the dense expert products, gather and combine (dropped slots get
       weight 0), plus the shared experts.
    """
    t, d = x2d.shape
    e, k = mcfg.n_experts, mcfg.top_k
    cap = moe_capacity(t, mcfg)
    dev = x2d.device

    logits = _mm32(x2d, p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, expert = stable_topk(probs, k)                      # (T, k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * sum_e f_e * P_e, f from the first choice only
    f = torch.mean(F.one_hot(expert[:, 0], e).to(torch.float32), dim=0)
    aux = mcfg.aux_coef * e * torch.sum(f * torch.mean(probs, dim=0))

    # --- dispatch bookkeeping (ints only; no gradient path)
    slot_e = expert.reshape(-1)                               # (T*k,)
    order = torch.argsort(slot_e, stable=True)
    se_sorted = slot_e[order]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, slot_e, torch.ones_like(slot_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=dev) - starts[se_sorted]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap                                          # capacity drop

    tok = torch.arange(t * k, device=dev) // k
    buf = torch.zeros((e, cap, d), dtype=x2d.dtype, device=dev).index_put(
        (torch.where(keep, slot_e, e - 1), torch.where(keep, pos, cap - 1)),
        torch.where(keep[:, None], x2d[tok], 0), accumulate=True)

    # --- expert FFN (dense over (E, C))
    h1 = matmul32(buf, p["w1"])
    if cfg.mlp_type == "swiglu":
        h = F.silu(h1) * matmul32(buf, p["w3"])
    else:
        h = torch.square(F.relu(h1))
    out_buf = matmul32(h.to(x2d.dtype), p["w2"]).to(x2d.dtype)

    # --- combine (clamp dropped slots; their weight is zeroed by `keep`)
    y_slots = out_buf[slot_e, torch.clamp(pos, max=cap - 1)] * (
        gate.reshape(-1, 1) * keep[:, None])
    y = y_slots.reshape(t, k, d).sum(dim=1).to(x2d.dtype)
    if mcfg.n_shared > 0:
        y = y + dense_ffn(x2d, p["shared"], cfg)
    return y.to(x2d.dtype), aux


def dense_ffn(x, p, cfg: TransformerConfig):
    h1 = _mm32(x, p["w1"])
    if cfg.mlp_type == "swiglu":
        h = F.silu(h1) * _mm32(x, p["w3"])
    else:
        h = torch.square(F.relu(h1))
    return _mm32(h.to(x.dtype), p["w2"]).to(x.dtype)


# ---------------------------------------------------------------- layer/model
def _attn_proj(x, p, cfg):
    """qkv projections + optional qk-norm. x: (B, S, D)."""
    q = _mm32(x, p["wq"]).to(x.dtype)
    k = _mm32(x, p["wk"]).to(x.dtype)
    v = _mm32(x, p["wv"]).to(x.dtype)
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    return q, k, v


def layer_fn(p, x, cfg: TransformerConfig, positions, use_moe: bool):
    """One transformer (sub)layer. x: (B, S, D)."""
    h = rmsnorm(x, p["ln1"])
    q, k, v = _attn_proj(h, p, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    att = blockwise_attention(
        q, k, v, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk
    )
    x = x + _mm32(att, p["wo"], 2).to(x.dtype)

    h = rmsnorm(x, p["ln2"])
    if use_moe:
        b, s, d = h.shape
        y, aux = moe_ffn(h.reshape(-1, d), p["moe"], cfg, cfg.moe)
        y = y.reshape(b, s, d)
    else:
        y = dense_ffn(h, p["mlp"], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux, (k, v)


def _n_sub(cfg: TransformerConfig) -> int:
    """Sublayers per block: moe_every (the MoE interleave period)."""
    return cfg.moe.moe_every if cfg.moe is not None else 1


def _n_blocks(cfg: TransformerConfig) -> int:
    if cfg.n_layers % _n_sub(cfg):
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"moe_every {_n_sub(cfg)}")
    return cfg.n_layers // _n_sub(cfg)


def _sub_uses_moe(cfg: TransformerConfig, i: int) -> bool:
    """Sublayer i of a block is the MoE one iff it is the last of the period
    (the Llama-4 interleave: dense, MoE, dense, MoE, ...)."""
    return cfg.moe is not None and i == _n_sub(cfg) - 1


def block_fn(p_block, x, cfg: TransformerConfig, positions):
    """One block = ``moe_every`` consecutive sublayers (keys sub0..)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for i in range(_n_sub(cfg)):
        x, a, kv = layer_fn(
            p_block[f"sub{i}"], x, cfg, positions, _sub_uses_moe(cfg, i)
        )
        aux = aux + a
        kvs.append(kv)
    return x, aux, kvs


def _tree(params) -> dict:
    """The reference's nested tree from the module or a flat name ->
    tensor mapping (dot-joined paths)."""
    flat = (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else params)
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def _block(layers: dict, i: int) -> dict:
    """Block ``i`` of the stacked layer tree (views)."""
    return {k: _block(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _constrain(x, spec):
    """``x`` redistributed to ``spec``'s placements on its own mesh when it
    is a DTensor (the reference's ``with_sharding_constraint``); a plain
    tensor, or no spec, passes as it is."""
    if spec is None or not _is_dtensor(x):
        return x
    from ..runtime.sharding import to_placements

    want = to_placements(x.device_mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _layer_specs(use_specs):
    """The per-block nested spec tree of ``use_specs`` (or None)."""
    if not use_specs:
        return None
    flat = {k[len("layers."):]: v for k, v in use_specs.items()
            if k.startswith("layers.")}
    return _tree(flat) if flat else None


def _constrain_tree(tree: dict, specs):
    if specs is None:
        return tree
    return {k: _constrain_tree(v, specs.get(k)) if isinstance(v, dict)
            else _constrain(v, specs.get(k)) for k, v in tree.items()}


def _run_block(layers, i, x, cfg, positions, layer_specs=None):
    """Block ``i``, its weights gathered to ``layer_specs``; recomputed in
    the backward (``remat``) while autograd records."""
    def run(x):
        return block_fn(_constrain_tree(_block(layers, i), layer_specs), x,
                        cfg, positions)

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(run, x, use_reentrant=False)
    return run(x)


def _embed(p, tokens, cfg):
    return F.embedding(tokens, p["embed"]).to(cfg.dtype)


def forward(params, tokens, cfg: TransformerConfig, use_specs=None):
    """Training/prefill forward. tokens (B, S) -> (logits (B, S, V) fp32,
    aux ()). ``use_specs``: see the module docstring."""
    p = _tree(params)
    b, s = tokens.shape
    x = _embed(p, tokens, cfg)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer_specs = _layer_specs(use_specs)
    res_spec = use_specs.get("residual") if use_specs else None
    for i in range(_n_blocks(cfg)):
        x, a, _ = _run_block(p["layers"], i, x, cfg, positions, layer_specs)
        x = _constrain(x, res_spec)
        aux = aux + a
    x = rmsnorm(x, p["ln_f"])
    unembed = _constrain(p["unembed"], (use_specs or {}).get("unembed"))
    return _mm32(x, unembed), aux


def loss_fn(params, tokens, labels, cfg: TransformerConfig, use_specs=None):
    """Mean next-token cross-entropy (+ MoE aux). labels -1 = masked."""
    logits, aux = forward(params, tokens, cfg, use_specs)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------- decode path
def init_cache(cfg: TransformerConfig, batch: int, dtype=None, device=None):
    """Zero KV cache ``(n_layers, batch, max_seq_len, n_kv_heads, d_head)``
    and ``length`` 0, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "length": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _sharded_cache(cfg, batch: int, like, spec):
    """A zero cache whose ``k`` / ``v`` are DTensors on ``like``'s mesh,
    placed by ``spec`` (prefill's ``use_specs["cache"]``)."""
    from torch.distributed.tensor import DTensor

    from ..runtime.sharding import local_shape, to_placements

    mesh = like.device_mesh
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads,
             cfg.d_head)
    loc = local_shape(mesh, shape, spec)

    def zeros():
        return DTensor.from_local(
            torch.zeros(loc, dtype=cfg.dtype, device=like.device), mesh,
            to_placements(mesh, spec), run_check=False)

    return {"k": zeros(), "v": zeros(),
            "length": torch.zeros((), dtype=torch.int32, device=like.device)}


def prefill(params, tokens, cfg: TransformerConfig, use_specs=None):
    """Run the prompt, return last-position logits (B, V) fp32 + a cache
    filled to ``S`` in true layer order. ``use_specs``: see the module
    docstring."""
    p = _tree(params)
    b, s = tokens.shape
    if s > cfg.max_seq_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    x = _embed(p, tokens, cfg)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache_spec = (use_specs or {}).get("cache")
    if cache_spec is not None and _is_dtensor(p["embed"]):
        cache = _sharded_cache(cfg, b, p["embed"], cache_spec)
    else:
        cache = init_cache(cfg, b, device=x.device)
    layer_specs = _layer_specs(use_specs)
    n_sub = _n_sub(cfg)
    for i in range(_n_blocks(cfg)):
        x, _, kvs = _run_block(p["layers"], i, x, cfg, positions,
                               layer_specs)
        for j, (k, v) in enumerate(kvs):
            cache["k"][i * n_sub + j, :, :s] = k
            cache["v"][i * n_sub + j, :, :s] = v
    cache["length"].fill_(s)
    x = rmsnorm(x[:, -1:], p["ln_f"])
    unembed = _constrain(p["unembed"], (use_specs or {}).get("unembed"))
    return _mm32(x, unembed)[:, 0], cache


def decode_step(params, cache, token, cfg: TransformerConfig):
    """One decode step. token (B,) -> (logits (B, V) fp32, cache).

    Writes the new k/v into ``cache`` in place at ``min(length,
    max_seq_len - 1)`` (the reference's clamped ``dynamic_update_slice``),
    adds one to ``cache["length"]`` in place and returns the same dict."""
    p = _tree(params)
    b = token.shape[0]
    x = _embed(p, token, cfg)[:, None, :]
    length = cache["length"]
    positions = length.reshape(1, 1).expand(b, 1)
    slot = torch.clamp(length, max=cfg.max_seq_len - 1).reshape(1).long()
    n_sub = _n_sub(cfg)
    for i in range(_n_blocks(cfg)):
        p_blk = _block(p["layers"], i)
        for j in range(n_sub):
            pl = p_blk[f"sub{j}"]
            ck, cv = cache["k"][i * n_sub + j], cache["v"][i * n_sub + j]
            h = rmsnorm(x, pl["ln1"])
            q, k, v = _attn_proj(h, pl, cfg)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            ck.index_copy_(1, slot, k)
            cv.index_copy_(1, slot, v)
            att = decode_attention(q, ck, cv, length + 1)
            x = x + _mm32(att, pl["wo"], 2).to(x.dtype)
            h = rmsnorm(x, pl["ln2"])
            if _sub_uses_moe(cfg, j):
                d = h.shape[-1]
                y, _ = moe_ffn(h.reshape(-1, d), pl["moe"], cfg, cfg.moe)
                y = y.reshape(b, 1, d)
            else:
                y = dense_ffn(h, pl["mlp"], cfg)
            x = x + y
    x = rmsnorm(x, p["ln_f"])
    logits = _mm32(x, p["unembed"])
    length.add_(1)
    return logits[:, 0], cache


# -------------------------------------------------------------------- params
def _sublayer_shapes(cfg: TransformerConfig, with_moe: bool) -> dict:
    d, h, kv, dh, f = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
    )
    shapes = {
        "ln1": (d,),
        "ln2": (d,),
        "wq": (d, h, dh),
        "wk": (d, kv, dh),
        "wv": (d, kv, dh),
        "wo": (h, dh, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (dh,)
        shapes["k_norm"] = (dh,)
    if with_moe:
        m = cfg.moe
        moe = {
            "router": (d, m.n_experts),
            "w1": (m.n_experts, d, m.d_expert),
            "w2": (m.n_experts, m.d_expert, d),
        }
        if cfg.mlp_type == "swiglu":
            moe["w3"] = (m.n_experts, d, m.d_expert)
        if m.n_shared > 0:
            fs = m.d_expert * m.n_shared
            moe["shared"] = {"w1": (d, fs), "w2": (fs, d)}
            if cfg.mlp_type == "swiglu":
                moe["shared"]["w3"] = (d, fs)
        shapes["moe"] = moe
    else:
        shapes["mlp"] = {"w1": (d, f), "w2": (f, d)}
        if cfg.mlp_type == "swiglu":
            shapes["mlp"]["w3"] = (d, f)
    return shapes


def _block_shapes(cfg: TransformerConfig) -> dict:
    """One block: ``moe_every`` sublayers, keys sub0..sub{n-1}."""
    return {
        f"sub{i}": _sublayer_shapes(cfg, _sub_uses_moe(cfg, i))
        for i in range(_n_sub(cfg))
    }


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested mapping -> {dot-joined path: leaf}; a flat mapping passes."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def param_specs(cfg: TransformerConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, layer leaves stacked ``(n_blocks,
    ...)``; nothing is allocated. All are stored in ``cfg.dtype``."""
    nb = _n_blocks(cfg)
    layers = {name: (nb, *shape)
              for name, shape in _flatten(_block_shapes(cfg)).items()}
    return {
        "embed": (cfg.vocab, cfg.d_model),
        **{f"layers.{name}": shape for name, shape in layers.items()},
        "ln_f": (cfg.d_model,),
        "unembed": (cfg.d_model, cfg.vocab),
    }


_NORM_NAMES = ("ln1", "ln2", "ln_f", "q_norm", "k_norm")
# Elements drawn at a time in fp32 (1 GiB): the draw goes straight into the
# storage dtype on the device, chunk by chunk along the leading dim.
_INIT_CHUNK = 1 << 28


def _init_leaf(cfg, leaf: str, shape, generator, dev) -> torch.Tensor:
    """The reference's ``init_params`` rule for one leaf: norms are ones;
    ``embed``, ``unembed`` and ``router`` draw ``N(0, 1/d_model)``; every
    other leaf ``N(0, 1/shape[-2])`` on the stacked shape — so ``wq``,
    ``wk``, ``wv`` take ``1/n_heads`` / ``1/n_kv_heads`` and ``wo``
    ``1/d_head``, the reference's fan-in."""
    if any(n in leaf for n in _NORM_NAMES):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)
    if leaf in ("embed", "unembed", "router"):
        scale = cfg.d_model ** -0.5
    else:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = (1.0 / max(fan_in, 1)) ** 0.5
    out = torch.empty(shape, dtype=cfg.dtype, device=dev)
    rows = max(1, _INIT_CHUNK // max(1, int(np.prod(shape[1:]))))
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        w = torch.randn((n, *shape[1:]), generator=generator,
                        device=generator.device, dtype=torch.float32)
        out[i:i + n].copy_(w.mul_(scale))
    return out


class Transformer(nn.Module):
    """The LM's parameters under the reference's tree paths (see the
    module docstring), on ``device`` (the card unless the caller asks for
    the CPU), drawn by the reference's rules from ``generator`` (default:
    seed 0 on the device)."""

    def __init__(self, cfg: TransformerConfig, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for name, shape in param_specs(cfg).items():
            *path, leaf = name.split(".")
            owner: nn.Module = self
            for key in path:
                if key not in owner._modules:
                    owner.add_module(key, nn.Module())
                owner = owner._modules[key]
            owner.register_parameter(leaf, nn.Parameter(
                _init_leaf(cfg, leaf, shape, generator, dev)))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """A freshly drawn :class:`Transformer` (the reference's
    ``init_params``; a torch generator cannot replay ``jax.random``, so
    parity runs carry the reference's draw by
    :func:`from_reference_params`)."""
    return Transformer(cfg, generator=generator, device=device)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch; bf16 leaves (``ml_dtypes``) through a uint16 view."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def from_reference_params(cfg: TransformerConfig, params: Mapping, *,
                          device=None) -> Transformer:
    """The port's module holding the reference's parameters: its nested
    pytree of numpy arrays (``init_params(cfg, key)`` through
    ``np.asarray``) or the same flattened to dot-joined names. Raises
    ``KeyError`` on missing or unexpected names and ``ValueError`` on a
    shape that differs."""
    flat = _flatten(params)
    model = Transformer(cfg, device=device)
    have = dict(model.named_parameters())
    if set(have) != set(flat):
        raise KeyError(f"parameters do not match {cfg.name}: missing "
                       f"{sorted(set(have) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(have))}")
    with torch.no_grad():
        for name, value in flat.items():
            t = _tensor(np.asarray(value))
            if tuple(t.shape) != tuple(have[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(have[name].shape)}")
            have[name].copy_(t)
    return model


def count_params(cfg: TransformerConfig) -> int:
    return sum(int(np.prod(s)) for s in param_specs(cfg).values())


def active_params(cfg: TransformerConfig) -> int:
    """Per-token touched parameters (MoE: top-k + shared experts only).

    Used for MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens
    (serve). Embedding-table rows excluded (gather, not matmul); the unembed
    projection included (it is a matmul).
    """
    total = count_params(cfg)
    embed = cfg.vocab * cfg.d_model          # embed only; unembed stays
    if cfg.moe is None:
        return total - embed
    m = cfg.moe
    n_moe_layers = sum(
        1 for i in range(cfg.n_layers)
        if (i % m.moe_every) == (m.moe_every - 1)
    )
    n_mats = 3 if cfg.mlp_type == "swiglu" else 2
    per_expert = n_mats * cfg.d_model * m.d_expert
    routed_total = n_moe_layers * m.n_experts * per_expert
    routed_active = n_moe_layers * m.top_k * per_expert
    return total - embed - routed_total + routed_active
