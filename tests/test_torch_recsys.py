"""PyTorch port, the recsys serving path: data generators, embedding
tables and ``embed_bag``, the DLRM / BST / AutoInt / MIND forwards and
losses, the serve and retrieval steps and the configs, against the JAX
reference on the same numpy inputs.

Weights come from the reference's ``*_init`` and are carried across by
``from_reference_params``; batches come from each package's own
generator (bit-identical, checked first). Both sides run in fp32 on the
CPU, so the forwards differ only in summation order: logits and losses are
held to ``FWD_TOL`` below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.core import FieldSpec as RFieldSpec  # noqa: E402
from repro.core import weighted_query as r_weighted_query  # noqa: E402
from repro.data import recsys_data as r_data  # noqa: E402
from repro.models import embedding as r_emb  # noqa: E402
from repro.models import recsys as r_rs  # noqa: E402
from repro_torch import configs as P_configs  # noqa: E402
from repro_torch.configs.common import (  # noqa: E402
    recsys_retrieval_step, recsys_serve_step)
from repro_torch.core import FieldSpec, weighted_query  # noqa: E402
from repro_torch.data import recsys_data as p_data  # noqa: E402
from repro_torch.models import embedding as p_emb  # noqa: E402
from repro_torch.models import recsys as p_rs  # noqa: E402

# fp32 on both sides; the sums (dots of <= a few hundred terms, MLPs of
# width <= 64 at the smoke configs) only run in another order.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# embed_bag on a bf16 table: both sum in fp32 and round to bf16 once; on
# "mean" the reference then divides in bf16 (a second rounding), the port
# in fp32 before its one rounding, so they may differ by one bf16 rounding
# of the result: a relative 2**-8, twice that for safety.
BF16_RTOL = 2.0 ** -7

ARCHS = ("dlrm-mlperf", "bst", "autoint", "mind")
CPU = "cpu"


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _routing_logits(cfg, hist_len=None):
    """The reference's draw inside mind_interests (recsys.py:384-386)."""
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(17), (1, cfg.n_interests, hist_len or cfg.hist_len),
        jnp.float32))


def _pair(arch, seed=0):
    """(reference cfg, port cfg, reference params, port model) at the
    arch's smoke config, weights carried from the reference's init."""
    rcfg = r_get_arch(arch).make_smoke_config()
    pcfg = P_configs.get_arch(arch).make_smoke_config()
    init = {"dlrm-mlperf": r_rs.dlrm_init, "bst": r_rs.bst_init,
            "autoint": r_rs.autoint_init, "mind": r_rs.mind_init}[arch]
    params = init(rcfg, jax.random.PRNGKey(seed))
    extra = ({"routing_logits": _routing_logits(rcfg)} if arch == "mind"
             else {})
    model = p_rs.from_reference_params(pcfg, _np(params), device=CPU, **extra)
    return rcfg, pcfg, params, model


def _batch(arch, cfg, batch=16, step=0, multi_hot=1):
    """One numpy batch from the port's generator (equal to the
    reference's, test_*_bit_identical)."""
    if arch in ("dlrm-mlperf", "autoint"):
        bc = p_data.RecsysBatchConfig(
            n_dense=getattr(cfg, "n_dense", 13), vocab_sizes=cfg.vocab_sizes,
            multi_hot=multi_hot)
        dense, sparse, y = p_data.click_batch(bc, batch, step=step)
        if multi_hot == 1:
            sparse = sparse[..., 0]
        out = {"sparse": sparse, "label": y}
        if arch == "dlrm-mlperf":
            out["dense"] = dense
        return out
    n_items = cfg.n_items
    hist_len = cfg.seq_len if arch == "bst" else cfg.hist_len
    hist, target, y = p_data.history_batch(n_items, batch, hist_len,
                                           step=step)
    hist = hist.copy()
    hist[::3, -4:] = -1                       # padded histories
    return {"hist": hist, "target": target, "label": y}


def _to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("multi_hot,seed,step,shard", [
    (1, 0, 0, 0), (3, 0, 5, 1), (8, 7, 2, 3)])
def test_click_batch_bit_identical(multi_hot, seed, step, shard):
    vocabs = (1000, 50, 3000, 7, 120, 4000) + (64,) * 20
    kw = dict(n_dense=13, vocab_sizes=vocabs, multi_hot=multi_hot, seed=seed)
    got = p_data.click_batch(p_data.RecsysBatchConfig(**kw), 64, step=step,
                             shard=shard)
    want = r_data.click_batch(r_data.RecsysBatchConfig(**kw), 64, step=step,
                              shard=shard)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert got[1].shape == (64, len(vocabs), multi_hot)


@pytest.mark.parametrize("n_items,hist_len,seed,step,shard", [
    (2000, 20, 0, 0, 0), (3000, 50, 3, 1, 2), (1_000_448, 50, 0, 4, 0)])
def test_history_batch_bit_identical(n_items, hist_len, seed, step, shard):
    got = p_data.history_batch(n_items, 32, hist_len, step=step, shard=shard,
                               seed=seed)
    want = r_data.history_batch(n_items, 32, hist_len, step=step,
                                shard=shard, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_log_uniform_bit_identical():
    a = p_data._log_uniform(np.random.default_rng(3), 39_884_544, (256, 8))
    b = r_data._log_uniform(np.random.default_rng(3), 39_884_544, (256, 8))
    assert np.array_equal(a, b)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["make_config", "make_smoke_config"])
def test_configs_match_reference_field_for_field(arch, which):
    r_cfg = getattr(r_get_arch(arch), which)()
    p_cfg = getattr(P_configs.get_arch(arch), which)()
    assert P_configs.get_arch(arch).ARCH_ID == r_get_arch(arch).ARCH_ID
    assert type(p_cfg).__name__ == type(r_cfg).__name__
    assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
    assert p_cfg.dtype == torch.float32 and r_cfg.dtype == jnp.float32
    for prop in ("n_sparse", "n_interact", "top_mlp", "full_seq",
                 "n_fields"):
        if hasattr(r_cfg, prop):
            assert getattr(p_cfg, prop) == getattr(r_cfg, prop), prop
    if hasattr(r_cfg, "tables"):
        # the reference's row_shard_threshold feeds its table_shardings,
        # which the port does not have yet
        r_tables = dataclasses.asdict(r_cfg.tables)
        r_tables.pop("row_shard_threshold")
        assert dataclasses.asdict(p_cfg.tables) == r_tables
        specs = p_emb.table_specs(p_cfg.tables)
        r_specs = r_emb.table_specs(r_cfg.tables)
        assert {k: tuple(v.shape) for k, v in specs.items()} == {
            k: tuple(v.shape) for k, v in r_specs.items()}
    # the parameter shapes the modules hold are the reference's
    r_specs_fn = {"dlrm-mlperf": r_rs.dlrm_param_specs,
                  "bst": r_rs.bst_param_specs,
                  "autoint": r_rs.autoint_param_specs,
                  "mind": r_rs.mind_param_specs}[arch]
    assert p_rs.param_specs(p_cfg) == {
        k: tuple(v.shape) for k, v in r_specs_fn(r_cfg).items()}


def test_vocab_tables_match_reference():
    from repro.configs import autoint as r_ai, dlrm_mlperf as r_dl
    from repro_torch.configs import autoint as p_ai, dlrm_mlperf as p_dl

    assert p_dl.CRITEO_TB_VOCABS == r_dl.CRITEO_TB_VOCABS
    assert p_ai.CRITEO_KAGGLE_VOCABS == r_ai.CRITEO_KAGGLE_VOCABS
    for v in (1, 3, 511, 512, 513, 39_884_406):
        assert p_dl._pad512(v) == r_dl._pad512(v) == p_ai._pad512(v)


LM_ARCHS = ("llama4-maverick-400b-a17b", "qwen2-moe-a2.7b",
            "mistral-large-123b", "minitron-8b", "qwen3-8b")


@pytest.mark.parametrize("arch_id", ["mistral-large", "gcn-cora",
                                     "paper-retrieval", "nope"])
def test_get_arch_unknown_or_unported_raises_naming_ported(arch_id):
    with pytest.raises(KeyError) as e:
        P_configs.get_arch(arch_id)
    for ported in ARCHS + LM_ARCHS:
        assert ported in str(e.value)
    assert set(P_configs.ARCH_IDS) == set(ARCHS + LM_ARCHS)


# ------------------------------------------------------ embedding substrate
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_matches_reference(dtype, combiner, weighted):
    rng = np.random.default_rng(11)
    v, e, b, l = 300, 24, 17, 9
    table = rng.normal(size=(v, e)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.3] = -1           # -1 padding
    idx[0] = -1                                  # an empty bag
    w = rng.uniform(0.1, 2.0, size=(b, l)).astype(np.float32)
    wts = w if weighted else None
    want = r_emb.embed_bag_jax(
        jnp.asarray(table).astype(dtype), jnp.asarray(idx),
        None if wts is None else jnp.asarray(wts), combiner=combiner)
    got = p_emb.embed_bag(
        torch.as_tensor(table).to(getattr(torch, dtype)),
        torch.as_tensor(idx), None if wts is None else torch.as_tensor(wts),
        combiner=combiner)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, e)
    got32 = got.float().numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    assert np.all(got32[0] == 0)
    if dtype == "float32":
        np.testing.assert_allclose(got32, want32, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got32, want32, rtol=BF16_RTOL, atol=1e-6)


def test_lookup_matches_reference():
    rng = np.random.default_rng(2)
    vocabs = (50, 7, 300)
    tables = {f"table_{i}": rng.normal(size=(v, 8)).astype(np.float32)
              for i, v in enumerate(vocabs)}
    ids = np.stack([rng.integers(0, v, 20) for v in vocabs], 1).astype(
        np.int32)
    got = p_emb.lookup({k: torch.as_tensor(t) for k, t in tables.items()},
                       torch.as_tensor(ids))
    want = r_emb.lookup({k: jnp.asarray(t) for k, t in tables.items()},
                        jnp.asarray(ids))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_init_tables_shapes_and_scale():
    cfg = p_emb.EmbedTablesConfig((4000, 7), 16)
    t = p_emb.init_tables(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in t.items()} == {
        "table_0": (4000, 16), "table_1": (7, 16)}
    assert abs(float(t["table_0"].std()) - 16 ** -0.5) < 0.01
    again = p_emb.init_tables(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(t[k], again[k]) for k in t)


def test_embed_bag_refuses_a_table_that_requires_grad():
    """The calls this guard used to refuse (a table that requires grad,
    under grad mode) now build a graph: ``embed_bag`` has a backward, and
    the gradient equals ``jax.grad`` of ``embed_bag_jax``; under no_grad
    the same call builds none. DLRM's multi-hot forward under grad mode
    has a ``grad_fn`` and reaches every table; the serve step still runs
    under inference mode. (The name is the guard's, kept for the record of
    runs; the full backward suite is ``tests/test_torch_recsys_train.py``.)"""
    table = torch.randn(10, 4, requires_grad=True)
    idx = torch.tensor([[1, 2, -1]])
    out = p_emb.embed_bag(table, idx)
    assert out.grad_fn is not None
    cot = torch.arange(4.0)[None]
    (out * cot).sum().backward()
    want = jax.grad(lambda t: jnp.sum(r_emb.embed_bag_jax(
        t, jnp.asarray(idx.numpy())) * jnp.asarray(cot.numpy())))(
        jnp.asarray(table.detach().numpy()))
    np.testing.assert_array_equal(table.grad.numpy(), np.asarray(want))
    with torch.no_grad():
        out = p_emb.embed_bag(table, idx)
    assert out.grad_fn is None
    torch.testing.assert_close(out, (table[1] + table[2]).detach()[None])
    _, _, _, model = _pair("dlrm-mlperf")
    b = _to_torch(_batch("dlrm-mlperf", model.cfg, multi_hot=3))
    logits = model(b["dense"], b["sparse"])
    assert logits.grad_fn is not None
    logits.sum().backward()
    assert all(model.p[f"table_{i}"].grad is not None
               for i in range(model.cfg.n_sparse))
    assert recsys_serve_step(model, b).shape == (16,)


# ---------------------------------------------------------- pinned hazards
@pytest.mark.parametrize("f", [2, 5, 27])
def test_tril_indices_order_is_numpys(f):
    iu, ju = np.tril_indices(f, k=-1)
    t = torch.tril_indices(f, f, offset=-1)
    assert np.array_equal(t[0].numpy(), iu) and np.array_equal(t[1].numpy(),
                                                               ju)


def test_leaky_relu_slope_is_jaxs():
    import inspect

    slope = inspect.signature(jax.nn.leaky_relu).parameters[
        "negative_slope"].default
    assert slope == p_rs.LEAKY_SLOPE == 0.01
    x = np.linspace(-3, 3, 13, dtype=np.float32)
    np.testing.assert_array_equal(
        torch.nn.functional.leaky_relu(torch.as_tensor(x),
                                       p_rs.LEAKY_SLOPE).numpy(),
        np.asarray(jax.nn.leaky_relu(jnp.asarray(x))))


def test_bst_layernorm_is_scale_only_population_variance():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 3 + 1
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    got = p_rs._layernorm(torch.as_tensor(x), torch.as_tensor(scale))
    want = r_rs._layernorm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_squash_matches_reference():
    s = np.random.default_rng(1).normal(size=(4, 4, 16)).astype(np.float32)
    s[0, 0] = 0.0                                 # rsqrt(0 + 1e-9) stays finite
    np.testing.assert_allclose(p_rs._squash(torch.as_tensor(s)).numpy(),
                               np.asarray(r_rs._squash(jnp.asarray(s))),
                               **FWD_TOL)


# --------------------------------------------------- forwards and losses
def _reference_forward(arch, params, b, cfg):
    j = _to_jax(b)
    if arch == "dlrm-mlperf":
        return (r_rs.dlrm_forward(params, j["dense"], j["sparse"], cfg),
                r_rs.dlrm_loss(params, j, cfg))
    if arch == "bst":
        return (r_rs.bst_forward(params, j["hist"], j["target"], cfg),
                r_rs.bst_loss(params, j, cfg))
    if arch == "autoint":
        return (r_rs.autoint_forward(params, j["sparse"], cfg),
                r_rs.autoint_loss(params, j, cfg))
    return (r_rs.mind_interests(params, j["hist"], cfg),
            r_rs.mind_loss(params, j, cfg))


def _port_forward(arch, model, b):
    t = _to_torch(b)
    with torch.no_grad():
        if arch == "dlrm-mlperf":
            return model(t["dense"], t["sparse"]), p_rs.dlrm_loss(model, t)
        if arch == "bst":
            return model(t["hist"], t["target"]), p_rs.bst_loss(model, t)
        if arch == "autoint":
            return model(t["sparse"]), p_rs.autoint_loss(model, t)
        return model(t["hist"]), p_rs.mind_loss(model, t)


@pytest.mark.parametrize("arch,multi_hot", [
    ("dlrm-mlperf", 1), ("dlrm-mlperf", 3), ("bst", 1), ("autoint", 1),
    ("mind", 1)])
def test_forward_and_loss_match_reference(arch, multi_hot):
    """The four forwards and losses at their smoke configs; DLRM one-hot
    (the gather) and multi-hot M = 3 (embed_bag); BST and MIND on padded
    histories; MIND with the reference's routing logits."""
    rcfg, pcfg, params, model = _pair(arch)
    b = _batch(arch, pcfg, multi_hot=multi_hot)
    if arch == "dlrm-mlperf" and multi_hot == 1:
        b3 = dict(b, sparse=b["sparse"][..., None])   # (B, F, 1): the gather
        o3, _ = _port_forward(arch, model, b3)
    want_out, want_loss = _reference_forward(arch, params, b, rcfg)
    got_out, got_loss = _port_forward(arch, model, b)
    assert got_out.shape == tuple(want_out.shape)
    assert got_out.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               **FWD_TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **FWD_TOL)
    assert np.isfinite(got_out.numpy()).all()
    if arch == "dlrm-mlperf" and multi_hot == 1:
        assert torch.equal(o3, got_out)


def test_dlrm_multi_hot_goes_through_embed_bag_one_launch_per_field(
        monkeypatch):
    """(B, F, M > 1) calls embed_bag once per field; (B, F) and (B, F, 1)
    never do (the MLPerf one-hot cell does not reach the kernel)."""
    _, pcfg, _, model = _pair("dlrm-mlperf")
    calls = []
    real = p_rs.embed_bag

    def counting(*a, **kw):
        calls.append(kw.get("combiner"))
        return real(*a, **kw)

    monkeypatch.setattr(p_rs, "embed_bag", counting)
    for m in (1, 3):
        b = _to_torch(_batch("dlrm-mlperf", pcfg, multi_hot=m))
        recsys_serve_step(model, b)
        if m == 1:
            recsys_serve_step(model, dict(b, sparse=b["sparse"][..., None]))
            assert calls == []
    assert calls == ["sum"] * pcfg.n_sparse


def test_mind_interests_with_carried_routing_logits():
    """MIND at another history length, with that length's routing logits
    carried across; the module's default logits (a torch draw) differ."""
    rcfg = r_rs.MINDConfig(n_items=700, embed_dim=16, n_interests=4,
                           hist_len=12)
    pcfg = p_rs.MINDConfig(n_items=700, embed_dim=16, n_interests=4,
                           hist_len=12)
    params = r_rs.mind_init(rcfg, jax.random.PRNGKey(5))
    hist = np.random.default_rng(5).integers(0, 700, (6, 12)).astype(np.int32)
    hist[1, 3:] = -1
    want = np.asarray(r_rs.mind_interests(params, jnp.asarray(hist), rcfg))
    model = p_rs.from_reference_params(pcfg, _np(params), device=CPU,
                                       routing_logits=_routing_logits(rcfg))
    with torch.no_grad():
        got = model(torch.as_tensor(hist)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    default = p_rs.from_reference_params(pcfg, _np(params), device=CPU)
    assert tuple(default.routing_logits.shape) == (1, 4, 12)
    assert torch.equal(default.routing_logits, torch.randn(
        (1, 4, 12), generator=torch.Generator().manual_seed(17)))
    with torch.no_grad():
        other = default(torch.as_tensor(hist)).numpy()
    assert not np.allclose(other, want, atol=1e-3)


def test_mind_routing_logits_guards_raise():
    """A batch whose length has no logits raises (never a silent redraw);
    logits of the wrong shape, or for another arch, raise too."""
    rcfg, pcfg, params, model = _pair("mind")
    with pytest.raises(ValueError, match="history length 20"):
        model(torch.zeros((2, 21), dtype=torch.int32))
    with pytest.raises(ValueError, match="routing logits must be"):
        p_rs.from_reference_params(pcfg, _np(params), device=CPU,
                                   routing_logits=_routing_logits(rcfg, 21))
    _, dcfg, dparams, _ = _pair("dlrm-mlperf")
    r_dparams = r_rs.dlrm_init(r_get_arch("dlrm-mlperf").make_smoke_config(),
                               jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="MIND only"):
        p_rs.from_reference_params(dcfg, _np(r_dparams), device=CPU,
                                   routing_logits=_routing_logits(rcfg))
    with pytest.raises(KeyError, match="missing"):
        bad = _np(r_dparams)
        bad.pop("top_w0")
        p_rs.from_reference_params(dcfg, bad, device=CPU)


def test_models_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_rs.MIND(P_configs.get_arch("mind").make_smoke_config())
    model = p_rs.MIND(P_configs.get_arch("mind").make_smoke_config(),
                      device=CPU)
    assert model.device == torch.device("cpu")


# ------------------------------------------------- serve and retrieval
def _reference_serve(arch, params, b, cfg):
    """The step of recsys_serve_cell (common.py:540-579), on jax arrays."""
    j = _to_jax(b)
    if arch == "dlrm-mlperf":
        return r_rs.dlrm_forward(params, j["dense"], j["sparse"], cfg)
    if arch == "autoint":
        return r_rs.autoint_forward(params, j["sparse"], cfg)
    if arch == "bst":
        return r_rs.bst_forward(params, j["hist"], j["target"], cfg)
    ints = r_rs.mind_interests(params, j["hist"], cfg)
    tgt = jnp.take(params["item_emb"], j["target"], axis=0)
    return jnp.max(jnp.einsum("bke,be->bk", ints, tgt), axis=-1)


@pytest.mark.parametrize("arch,multi_hot", [
    ("dlrm-mlperf", 1), ("dlrm-mlperf", 3), ("bst", 1), ("autoint", 1),
    ("mind", 1)])
def test_serve_step_matches_reference(arch, multi_hot):
    rcfg, pcfg, params, model = _pair(arch, seed=3)
    b = _batch(arch, pcfg, batch=24, step=2, multi_hot=multi_hot)
    b.pop("label")
    want = np.asarray(_reference_serve(arch, params, b, rcfg))
    got = recsys_serve_step(model, _to_torch(b))
    assert not got.requires_grad and got.shape == (24,)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_retrieval_scores_match_reference(weighted):
    rng = np.random.default_rng(4)
    users = rng.normal(size=(3, 4, 16)).astype(np.float32)
    items = rng.normal(size=(200, 16)).astype(np.float32)
    w = rng.dirichlet([1.0] * 4, 3).astype(np.float32) if weighted else None
    got = p_rs.retrieval_scores(torch.as_tensor(users), torch.as_tensor(items),
                                weights=None if w is None
                                else torch.as_tensor(w))
    want = r_rs.retrieval_scores(jnp.asarray(users), jnp.asarray(items),
                                 weights=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    got2 = p_rs.retrieval_scores(torch.as_tensor(users[:, 0]),
                                 torch.as_tensor(items))
    want2 = r_rs.retrieval_scores(jnp.asarray(users[:, 0]),
                                  jnp.asarray(items))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **FWD_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_retrieval_step_matches_reference_with_ties(weighted):
    """MIND's retrieval_cand step (common.py:583-647): interests, weighted
    (or max-sim) scores, top-k with ties to the lower index as lax.top_k.
    Candidates repeat, so every score comes in tied pairs."""
    rcfg, pcfg, params, model = _pair("mind", seed=1)
    rng = np.random.default_rng(9)
    base = np.asarray(params["item_emb"])[:150]
    cands = np.concatenate([base, base[::-1]], 0)      # 300 rows, all tied
    hist = rng.integers(0, pcfg.n_items, (2, pcfg.hist_len)).astype(np.int32)
    w = rng.dirichlet([1.0] * 4, 2).astype(np.float32)
    k = 40
    ints = r_rs.mind_interests(params, jnp.asarray(hist), rcfg)
    scores = r_rs.retrieval_scores(
        ints, jnp.asarray(cands), weights=jnp.asarray(w) if weighted else None)
    wv, wi = jax.lax.top_k(scores, k)
    gv, gi = recsys_retrieval_step(
        model, torch.as_tensor(hist), torch.as_tensor(cands),
        weights=torch.as_tensor(w) if weighted else None, k=k)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **FWD_TOL)
    # ties: the pair (j, 299 - j) holds one score, so the lower index first
    assert np.all(np.asarray(wi)[:, 0::2] < np.asarray(wi)[:, 1::2])
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    # a user vector (the other archs' form)
    uv = np.array(ints)[:, 0]
    _, _, _, dlrm = _pair("dlrm-mlperf")
    sv, si = recsys_retrieval_step(dlrm, torch.as_tensor(uv),
                                   torch.as_tensor(cands), k=k)
    tv, ti = jax.lax.top_k(r_rs.retrieval_scores(jnp.asarray(uv),
                                                 jnp.asarray(cands)), k)
    np.testing.assert_allclose(sv.numpy(), np.asarray(tv), **FWD_TOL)
    assert np.array_equal(si.numpy(), np.asarray(ti))


def test_mind_is_dynamic_vector_score_aggregation():
    """The reference's property (tests/test_models_smoke.py), on the port:
    scoring with interest weights w equals cosine scoring by the normalised
    weighted concatenated query (identical ranking); and the port's
    interests equal the reference's with the carried weights."""
    rcfg = r_rs.MINDConfig(n_items=500, embed_dim=16, n_interests=4,
                           hist_len=8)
    pcfg = p_rs.MINDConfig(n_items=500, embed_dim=16, n_interests=4,
                           hist_len=8)
    params = r_rs.mind_init(rcfg, jax.random.PRNGKey(0))
    hist = jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0, 500)
    model = p_rs.from_reference_params(pcfg, _np(params), device=CPU,
                                       routing_logits=_routing_logits(rcfg))
    with torch.no_grad():
        ints = model(torch.as_tensor(np.array(hist)))
    np.testing.assert_allclose(
        ints.numpy(), np.asarray(r_rs.mind_interests(params, hist, rcfg)),
        **FWD_TOL)
    ints_n = ints / torch.linalg.vector_norm(ints, dim=-1, keepdim=True)
    w = torch.tensor([[0.5, 0.1, 0.3, 0.1]])
    cands = model.p["item_emb"].detach()[:200]
    cands_n = cands / torch.linalg.vector_norm(cands, dim=-1, keepdim=True)
    direct = p_rs.retrieval_scores(ints_n, cands_n, weights=w)[0]
    spec = FieldSpec(names=tuple("abcd"), dims=(16,) * 4)
    qw = weighted_query(ints_n.reshape(1, -1), w, spec)[0]
    reduced = torch.tile(cands_n, (1, 4)) @ qw
    assert torch.equal(torch.argsort(-direct, stable=True),
                       torch.argsort(-reduced, stable=True))
    # the same reduced query as the reference's weighted_query
    r_qw = r_weighted_query(jnp.asarray(ints_n.reshape(1, -1).numpy()),
                            jnp.asarray(w.numpy()),
                            RFieldSpec(names=tuple("abcd"), dims=(16,) * 4))
    np.testing.assert_allclose(qw.numpy(), np.asarray(r_qw)[0], atol=1e-6)
