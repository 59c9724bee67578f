"""PyTorch port, the LM family's layer functions
(``repro_torch.models.transformer``) against the JAX reference's
(``repro.models.transformer``) on the same numpy inputs, drawn from a seed.

Tolerances, each with its reason:

* fp32: both sides compute the same formulas; sums (and XLA's ``pow`` /
  ``cos`` against torch's) differ in the last ulps, so values of order 1
  are held to ``F32_TOL``.
* bf16 (``rmsnorm``, ``_qk_norm``, ``rope``): both sides round at the same
  places, but XLA on the CPU may keep an intermediate in fp32 that torch
  rounds to bf16 (and ``cos``/``sin`` differ in the last fp32 ulp before
  their rounding), so an element may land one bf16 rounding away: held
  to ``BF16_ULP`` = 2^-8 relative to the element's magnitude (one ulp of
  the bf16 significand), and most elements are bit-equal.
* The attention and MoE tests run fp32 (the products' fp32 sums in
  another order only): ``F32_TOL`` on values of order 1 to 10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as R  # noqa: E402
from repro_torch.models import transformer as P  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ULP = 2.0 ** -8
CPU = "cpu"

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _to_np(x):
    """A reference array as fp32 numpy (bf16 widened exactly)."""
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _close_bf16(got: torch.Tensor, want):
    """Within one bf16 rounding of the reference, element by element."""
    g = got.float().numpy()
    w = _to_np(want)
    bound = BF16_ULP * np.maximum(np.abs(w), np.abs(g)) + 1e-30
    assert np.all(np.abs(g - w) <= bound), float(np.max(np.abs(g - w) / bound))


def _cfg(**kw):
    base = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
                d_ff=48, vocab=97, attn_q_chunk=8, attn_kv_chunk=8,
                max_seq_len=32)
    base.update(kw)
    moe = base.pop("moe", None)
    rc = R.TransformerConfig(**base, moe=moe and R.MoEConfig(**moe))
    pc = P.TransformerConfig(**base, moe=moe and P.MoEConfig(**moe))
    return rc, pc


# ------------------------------------------------------------- norms, rope
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_and_qk_norm_match_reference(dtype):
    jd, td = DTYPES[dtype]
    rng = _rng(0)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32) * 3.0
    scale = rng.normal(size=(16,)).astype(np.float32)
    for r_fn, p_fn in ((R.rmsnorm, P.rmsnorm), (R._qk_norm, P._qk_norm)):
        want = r_fn(jnp.asarray(x, jd), jnp.asarray(scale, jd))
        got = p_fn(_t(x, td), _t(scale, td))
        assert got.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), _to_np(want), **F32_TOL)
        else:
            _close_bf16(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_matches_reference(dtype):
    """Half-split rotation at positions up to 4095 (the full configs'
    ``max_seq_len``), theta 10,000."""
    jd, td = DTYPES[dtype]
    rng = _rng(1)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.array([0, 1, 511, 2047, 4094, 4095])])
    want = R.rope(jnp.asarray(x, jd), jnp.asarray(pos), 10_000.0)
    got = P.rope(_t(x, td), torch.as_tensor(pos), 10_000.0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _to_np(want), **F32_TOL)
    else:
        _close_bf16(got, want)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("s,qc,kc,hq,hk", [
    (13, 4, 8, 4, 2),      # S a multiple of neither chunk, G = 2
    (24, 8, 8, 6, 2),      # G = 3, q blocks wholly above a kv block
    (9, 16, 16, 4, 4),     # chunks larger than S (clamped), MHA
    (17, 8, 4, 8, 1),      # one kv head for 8 q heads (G = 8)
])
def test_blockwise_attention_matches_reference(s, qc, kc, hq, hk):
    """Rows of a q block above the diagonal of a kv block are fully masked
    in that block (the ``m_safe`` / ``corr`` guard) in every case with
    more than one kv block."""
    rng = _rng(s)
    q = rng.normal(size=(2, s, hq, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, hk, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, hk, 8)).astype(np.float32)
    want = R.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_chunk=qc, kv_chunk=kc)
    got = P.blockwise_attention(_t(q), _t(k), _t(v), q_chunk=qc, kv_chunk=kc)
    assert got.shape == (2, s, hq, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # GQA: q head h reads kv head h // G (repeat_interleave, not repeat)
    g = hq // hk
    kk = _t(k).repeat_interleave(g, dim=2).double()
    vv = _t(v).repeat_interleave(g, dim=2).double()
    sc = torch.einsum("bshd,bthd->bhst", _t(q).double(), kk) * 8 ** -0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -np.inf)
    naive = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), vv)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), **F32_TOL)


@pytest.mark.parametrize("length", [1, 7, 16])
def test_decode_attention_matches_reference(length):
    """Masked to ``pos < length`` over the whole cache (G = 3)."""
    rng = _rng(length)
    q = rng.normal(size=(2, 1, 6, 8)).astype(np.float32)
    ck = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    cv = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    want = R.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.asarray(length))
    got = P.decode_attention(_t(q), _t(ck), _t(cv), torch.tensor(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # positions past length do not matter
    cv2 = cv.copy()
    cv2[:, length:] = 1e3
    again = P.decode_attention(_t(q), _t(ck), _t(cv2), torch.tensor(length))
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0, atol=0)


# --------------------------------------------------------------------- FFNs
def _ffn_params(rng, d, f, mlp_type):
    p = {"w1": rng.normal(size=(d, f)) / np.sqrt(d),
         "w2": rng.normal(size=(f, d)) / np.sqrt(f)}
    if mlp_type == "swiglu":
        p["w3"] = rng.normal(size=(d, f)) / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2"])
def test_dense_ffn_matches_reference(mlp_type):
    rc, pc = _cfg(mlp_type=mlp_type)
    rng = _rng(3)
    p = _ffn_params(rng, 32, 48, mlp_type)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = R.dense_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                       rc)
    got = P.dense_ffn(_t(x), {k: _t(v) for k, v in p.items()}, pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def _moe_params(rng, d, e, de, n_shared, mlp_type, tie=False):
    p = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "w1": rng.normal(size=(e, d, de)) / np.sqrt(d),
         "w2": rng.normal(size=(e, de, d)) / np.sqrt(de)}
    if mlp_type == "swiglu":
        p["w3"] = rng.normal(size=(e, d, de)) / np.sqrt(d)
    if tie:
        # experts 2 and 5, and 1 and 6, get equal router columns: their
        # probabilities tie exactly for every token
        p["router"][:, 5] = p["router"][:, 2]
        p["router"][:, 6] = p["router"][:, 1]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if n_shared:
        p["shared"] = _ffn_params(rng, d, de * n_shared, mlp_type)
    return p


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", [
    dict(top_k=2, capacity_factor=1.25, n_shared=0, mlp_type="swiglu",
         tie=True),                        # router ties
    dict(top_k=2, capacity_factor=0.3, n_shared=0, mlp_type="swiglu",
         tie=False),                       # slots dropped at capacity
    dict(top_k=1, capacity_factor=0.5, n_shared=2, mlp_type="relu2",
         tie=True),                        # ties + drops + shared experts
    dict(top_k=4, capacity_factor=8.0, n_shared=1, mlp_type="swiglu",
         tie=False),                       # no drops, shared
])
def test_moe_ffn_matches_reference(case):
    """Output and aux loss; with ties ``lax.top_k`` takes the lower expert
    (``stable_topk``); dropped slots scatter zeros at (E-1, C-1) and
    combine with weight 0."""
    e, d, de, t = 8, 32, 24, 40
    moe = dict(n_experts=e, top_k=case["top_k"], d_expert=de,
               n_shared=case["n_shared"],
               capacity_factor=case["capacity_factor"])
    rc, pc = _cfg(mlp_type=case["mlp_type"], moe=moe)
    rng = _rng(7)
    p = _moe_params(rng, d, e, de, case["n_shared"], case["mlp_type"],
                    case["tie"])
    x = rng.normal(size=(t, d)).astype(np.float32)
    y_r, aux_r = R.moe_ffn(jnp.asarray(x), _tree_map(jnp.asarray, p), rc,
                           rc.moe)
    y_p, aux_p = P.moe_ffn(_t(x), _tree_map(_t, p), pc, pc.moe)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **F32_TOL)
    np.testing.assert_allclose(float(aux_p), float(aux_r), rtol=1e-6)
    cap = P.moe_capacity(t, pc.moe)
    probs = torch.softmax(_t(x) @ _t(p["router"]), -1)
    _, expert = P.stable_topk(probs, case["top_k"])
    load = torch.bincount(expert.reshape(-1), minlength=e)
    if case["capacity_factor"] < 1:
        assert int(load.max()) > cap           # the case really drops slots
    if case["tie"]:
        # the tie is real, and torch.topk's order is not what is used
        assert torch.equal(probs[:, 2], probs[:, 5])
        has2, has5 = (expert == 2).any(-1), (expert == 5).any(-1)
        assert bool((has5 <= has2).all())      # 5 only beside 2
        assert bool(has2.any())


# ------------------------------------------------------------ decode clamp
def test_decode_step_at_full_cache_clamps_like_reference():
    """At ``length == max_seq_len`` the reference's dynamic_update_slice
    clamps its start: the token overwrites the last slot and ``length``
    becomes ``max_seq_len + 1``. The port keeps that."""
    rc, pc = _cfg(max_seq_len=16, n_layers=2)
    params = R.init_params(rc, jax.random.PRNGKey(0))
    model = P.from_reference_params(pc, jax.tree.map(np.asarray, params),
                                    device=CPU)
    toks = _rng(5).integers(0, rc.vocab, (2, 16)).astype(np.int32)
    lr, cr = R.prefill(params, jnp.asarray(toks), rc)
    with torch.no_grad():
        lp, cp = P.prefill(model, torch.as_tensor(toks), pc)
    before = cp["k"].clone()
    nxt = np.array([3, 4], np.int32)
    for _ in range(2):
        lr, cr = R.decode_step(params, cr, jnp.asarray(nxt), rc)
        with torch.no_grad():
            lp, cp = P.decode_step(model, cp, torch.as_tensor(nxt), pc)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), **F32_TOL)
        np.testing.assert_allclose(cp["k"].numpy(), np.asarray(cr["k"]),
                                   **F32_TOL)
        np.testing.assert_allclose(cp["v"].numpy(), np.asarray(cr["v"]),
                                   **F32_TOL)
        assert int(cp["length"]) == int(cr["length"])
    assert int(cp["length"]) == 18
    # only the last slot changed
    assert torch.equal(cp["k"][:, :, :15], before[:, :, :15])
    assert not torch.equal(cp["k"][:, :, 15], before[:, :, 15])


# ------------------------------------------------------------------- init
def test_init_params_draws_the_reference_scales():
    """Norms are ones; embed / unembed / router draw N(0, 1/d_model); every
    other leaf N(0, 1/shape[-2]) on the STACKED shape (the reference's
    fan-in: wq/wk/wv take 1/n_heads or 1/n_kv_heads, wo 1/d_head). The
    port's empirical std and the reference's are both held to the rule
    (within 6 %: each leaf has >= 4,096 draws, sampling error ~1.1 %)."""
    rc, pc = _cfg(d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=96,
                  vocab=211, qk_norm=True,
                  moe=dict(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                           moe_every=2),
                  n_layers=4)
    ref = P._flatten(jax.tree.map(np.asarray,
                                  R.init_params(rc, jax.random.PRNGKey(0))))
    model = P.init_params(pc, torch.Generator().manual_seed(0), CPU)
    got = {n: t.detach() for n, t in model.named_parameters()}
    assert set(got) == set(ref)
    d = pc.d_model
    want_scale = {"embed": d ** -0.5, "unembed": d ** -0.5,
                  "layers.sub1.moe.router": d ** -0.5,
                  "layers.sub0.wq": pc.n_heads ** -0.5,
                  "layers.sub0.wk": pc.n_kv_heads ** -0.5,
                  "layers.sub0.wv": pc.n_kv_heads ** -0.5,
                  "layers.sub0.wo": pc.d_head ** -0.5,
                  "layers.sub0.mlp.w1": d ** -0.5,
                  "layers.sub0.mlp.w2": pc.d_ff ** -0.5,
                  "layers.sub1.moe.w1": d ** -0.5,
                  "layers.sub1.moe.w2": 64 ** -0.5,
                  "layers.sub1.moe.shared.w1": d ** -0.5,
                  "layers.sub1.moe.shared.w2": 64 ** -0.5}
    for name, t in got.items():
        assert tuple(t.shape) == ref[name].shape, name
        leaf = name.split(".")[-1]
        if leaf in ("ln1", "ln2", "ln_f", "q_norm", "k_norm"):
            assert torch.all(t == 1) and np.all(ref[name] == 1), name
            continue
        shape = t.shape
        rule = (d ** -0.5 if leaf in ("embed", "unembed", "router")
                else shape[-2] ** -0.5)
        if name in want_scale:
            assert rule == pytest.approx(want_scale[name]), name
        for std in (float(t.std()), float(ref[name].std())):
            assert std == pytest.approx(rule, rel=0.06), (name, std, rule)
    # a seeded generator gives the same draw twice
    again = P.init_params(pc, torch.Generator().manual_seed(0), CPU)
    assert torch.equal(again.embed, model.embed)


def test_init_params_draws_in_chunks_into_the_storage_dtype(monkeypatch):
    """Drawn chunk by chunk along the leading dim (a chunk of 100
    elements forced here, so every stacked leaf is drawn block by block
    and ``embed`` a row at a time) straight into bf16, by the same
    rules."""
    _, pc = _cfg(dtype=torch.bfloat16, d_model=128, vocab=400)
    calls = []
    real = torch.randn

    def counting_randn(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(P, "_INIT_CHUNK", 100)
    monkeypatch.setattr(torch, "randn", counting_randn)
    model = P.init_params(pc, torch.Generator().manual_seed(3), CPU)
    monkeypatch.undo()
    specs = P.param_specs(pc)
    drawn = [n for n in specs if n.split(".")[-1] not in
             ("ln1", "ln2", "ln_f", "q_norm", "k_norm")]
    assert len(calls) == sum(specs[n][0] for n in drawn)
    assert max(int(np.prod(c)) for c in calls) <= max(
        int(np.prod(specs[n][1:])) for n in drawn)
    for n, t in model.named_parameters():
        assert t.dtype == torch.bfloat16, n
    assert float(model.embed.detach().float().std()) == pytest.approx(128 ** -0.5,
                                                             rel=0.06)


def test_matmul32_on_cpu_is_the_fp32_upcast_product():
    rng = _rng(9)
    a = _t(rng.normal(size=(5, 7)), torch.bfloat16)
    b = _t(rng.normal(size=(7, 3)), torch.bfloat16)
    got = P.matmul32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, a.float() @ b.float())
    a3, b3 = a[None].expand(2, 5, 7), b[None].expand(2, 7, 3)
    assert torch.equal(P.matmul32(a3, b3)[1], got)


def test_layer_fn_bf16_matches_reference_within_bf16_rounding():
    """One sublayer in bf16 (the card's storage dtype) on the CPU: both
    sides round at the same places, so outputs agree to a few bf16 ulps of
    the output's largest value (2^-6: the attention and the FFN each add
    one rounding of their own to the residual sum)."""
    jd, td = DTYPES["bfloat16"]
    rc, pc = _cfg(qk_norm=True, d_model=64, d_ff=96, n_layers=1)
    rc, pc = (dataclasses.replace(rc, dtype=jd),
              dataclasses.replace(pc, dtype=td))
    params = R.init_params(rc, jax.random.PRNGKey(1))
    model = P.from_reference_params(pc, jax.tree.map(np.asarray, params),
                                    device=CPU)
    x = _rng(4).normal(size=(2, 11, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    p_r = jax.tree.map(lambda a: a[0], params["layers"]["sub0"])
    want, _, _ = R.layer_fn(p_r, jnp.asarray(x, jd), rc, jnp.asarray(pos),
                            False)
    with torch.no_grad():
        p_p = P._block(P._tree(model)["layers"], 0)["sub0"]
        got, _, _ = P.layer_fn(p_p, _t(x, td), pc, torch.as_tensor(pos), False)
    w = _to_np(want)
    err = np.abs(got.float().numpy() - w).max()
    assert err <= 2.0 ** -6 * np.abs(w).max(), (err, np.abs(w).max())
