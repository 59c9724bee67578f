"""PyTorch port, first layer: import rule, device rule, corpus, fields and
weights against the JAX reference (same numpy inputs to both)."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.data import CorpusConfig as RCorpusConfig  # noqa: E402
from repro.data import make_corpus as r_make_corpus  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.data import CorpusConfig, make_corpus  # noqa: E402

SPEC_NAMES, SPEC_DIMS = ("title", "authors", "abstract"), (16, 8, 24)


def _specs():
    return (R.FieldSpec(SPEC_NAMES, SPEC_DIMS),
            P.FieldSpec(SPEC_NAMES, SPEC_DIMS))


def test_import_rule_no_jax_no_repro():
    """Importing every module of repro_torch pulls in neither jax nor the
    reference package (``repro_torch`` itself starts with ``repro``, so the
    check matches names exactly)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "jaxlib" or m.startswith("jaxlib.")
                     or m == "ml_dtypes" or m.startswith("ml_dtypes.")
                     or m == "repro" or m.startswith("repro."))
        assert len(names) >= 15, names
        for need in ("repro_torch.core.celldec",
                     "repro_torch.benchmarks.common",
                     "repro_torch.benchmarks.table1_preprocessing",
                     "repro_torch.benchmarks.fig1_querytime",
                     "repro_torch.benchmarks.table2_quality",
                     "repro_torch.benchmarks.repro_paper",
                     "repro_torch.serving",
                     "repro_torch.serving.server",
                     "repro_torch.benchmarks.loadtest",
                     "repro_torch.core.distributed",
                     "repro_torch.benchmarks.throughput",
                     "repro_torch.data.recsys_data",
                     "repro_torch.models",
                     "repro_torch.models.embedding",
                     "repro_torch.models.recsys",
                     "repro_torch.configs",
                     "repro_torch.configs.common",
                     "repro_torch.configs.dlrm_mlperf",
                     "repro_torch.configs.autoint",
                     "repro_torch.configs.bst",
                     "repro_torch.configs.mind",
                     "repro_torch.configs.qwen3_8b",
                     "repro_torch.configs.qwen2_moe_a2_7b",
                     "repro_torch.configs.minitron_8b",
                     "repro_torch.configs.mistral_large_123b",
                     "repro_torch.configs.llama4_maverick_400b_a17b",
                     "repro_torch.models.transformer",
                     "repro_torch.data.lm",
                     "repro_torch.examples.quickstart",
                     "repro_torch.examples.serve_retrieval",
                     "repro_torch.examples.recsys_retrieval",
                     "repro_torch.benchmarks.run",
                     "repro_torch.optim",
                     "repro_torch.optim.adamw",
                     "repro_torch.optim.sgd",
                     "repro_torch.optim.adafactor",
                     "repro_torch.optim.grad_accum",
                     "repro_torch.optim.compress",
                     "repro_torch.checkpoint",
                     "repro_torch.checkpoint.manager",
                     "repro_torch.runtime",
                     "repro_torch.runtime.fault",
                     "repro_torch.launch.train",
                     "repro_torch.examples.train_lm",
                     "repro_torch.models.gnn",
                     "repro_torch.data.graphs",
                     "repro_torch.configs.gcn_cora"):
            assert need in names and need in sys.modules, need
        assert not bad, bad
        print("OK", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("OK")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a card and without device="cpu" every entry point raises;
    with device="cpu" they run, and pick_backend/pick_clusterer follow the
    index's device."""
    from repro_torch.benchmarks import run
    from repro_torch.configs import get_arch
    from repro_torch.examples import (quickstart, recsys_retrieval,
                                      serve_retrieval)
    from repro_torch.launch import serve
    from repro_torch.models.recsys import DLRM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs, spec, _ = make_corpus(CorpusConfig(n_docs=64, field_dims=SPEC_DIMS,
                                             vocab_sizes=(80, 70, 90),
                                             n_topics=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.ClusterPruneIndex.build(docs, spec, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Retriever.build(docs, spec, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--docs", "64", "--queries", "2"])
    for main, argv in ((quickstart.main, ["--docs", "64"]),
                       (serve_retrieval.main, ["--docs", "64"]),
                       (recsys_retrieval.main, []),
                       (run.main, ["--scale", "tiny"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DLRM(get_arch("dlrm-mlperf").make_smoke_config())
    index = P.ClusterPruneIndex.build(docs, spec, 4, device="cpu")
    arrays = index._archive()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.ClusterPruneIndex.from_numpy(arrays)
    assert index.method == "fpf"
    assert P.pick_backend(index) == "reference"
    assert P.pick_clusterer("cpu") == "fpf"
    assert P.pick_clusterer("cuda") == "fpf_fused"
    assert P.Retriever(index).backend == "reference"


@pytest.mark.parametrize("n_cards,want", [(0, "reference"), (1, "fused"),
                                          (2, "sharded")])
def test_pick_backend_answers_from_the_platform(monkeypatch, n_cards, want):
    """With no index, pick_backend (and exec_shape's "auto") answers from
    the platform: no card -> reference, one -> fused, more -> sharded; an
    index answers from its own device (a CPU index -> reference)."""
    from repro_torch.core.api import SearchRequest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    assert P.pick_backend() == want
    shape = P.exec_shape(SearchRequest(like=0, weights={"a": 1.0}),
                         default_backend="auto", default_probes=12)
    assert shape.backend == want
    explicit = P.exec_shape(SearchRequest(like=0, weights={"a": 1.0},
                                          backend="fused"),
                            default_backend="auto", default_probes=12)
    assert explicit.backend == "fused"
    docs, spec, _ = make_corpus(CorpusConfig(n_docs=64, field_dims=SPEC_DIMS,
                                             vocab_sizes=(80, 70, 90),
                                             n_topics=4))
    index = P.ClusterPruneIndex.build(docs, spec, 4, device="cpu")
    assert P.pick_backend(index) == "reference"


@pytest.mark.parametrize("cfg", [
    dict(n_docs=300, field_dims=(64, 64, 128), vocab_sizes=(800, 1200, 3000),
         n_topics=16, seed=3),
    dict(n_docs=200, seed=5),
])
def test_make_corpus_bit_identical(cfg):
    a, spec_a, ta = make_corpus(CorpusConfig(**cfg))
    b, spec_b, tb = r_make_corpus(RCorpusConfig(**cfg))
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b) and np.array_equal(ta, tb)
    assert spec_a.names == spec_b.names and spec_a.dims == spec_b.dims


def test_field_spec_and_normalize_match():
    rspec, pspec = _specs()
    assert pspec.offsets == rspec.offsets and pspec.slices() == rspec.slices()
    assert np.array_equal(pspec.field_mask(), rspec.field_mask())
    x = np.random.default_rng(0).normal(size=(5, pspec.total_dim)).astype(
        np.float32)
    x[1, :16] = 0.0                               # a zero field block stays 0
    got = P.normalize_fields(torch.as_tensor(x), pspec).numpy()
    want = np.asarray(R.normalize_fields(jnp.asarray(x), rspec))
    np.testing.assert_allclose(got, want, atol=1e-6)
    parts = P.split_fields(torch.as_tensor(x), pspec)
    assert np.array_equal(P.concat_fields(parts).numpy(), x)
    with pytest.raises(ValueError):
        P.FieldSpec(("a",), (1, 2))


@pytest.mark.parametrize("batched", [False, True])
def test_weighted_query_matches(batched):
    """Concatenated, per-field and unnormalised forms, single and batched."""
    rspec, pspec = _specs()
    rng = np.random.default_rng(1)
    nq = 4 if batched else 1
    q = rng.normal(size=(nq, pspec.total_dim)).astype(np.float32)
    q = np.asarray(R.normalize_fields(jnp.asarray(q), rspec))
    w = rng.dirichlet([1.0] * 3, size=nq).astype(np.float32)
    if not batched:
        q, w = q[0], w[0]
    for normalize in (True, False):
        got = P.weighted_query(torch.as_tensor(q), torch.as_tensor(w), pspec,
                               normalize=normalize).numpy()
        want = np.asarray(R.weighted_query(jnp.asarray(q), jnp.asarray(w),
                                           rspec, normalize=normalize))
        np.testing.assert_allclose(got, want, atol=1e-6)
    blocks_p = [torch.as_tensor(q[..., sl]) for sl in pspec.slices()]
    blocks_r = [jnp.asarray(q[..., sl]) for sl in rspec.slices()]
    got = P.weighted_query(blocks_p, torch.as_tensor(w), pspec).numpy()
    want = np.asarray(R.weighted_query(blocks_r, jnp.asarray(w), rspec))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the aggregate (definitional) form matches too
    p = rng.normal(size=(6, pspec.total_dim)).astype(np.float32)
    if not batched:
        got = P.aggregate_similarity(torch.as_tensor(q), torch.as_tensor(w),
                                     torch.as_tensor(p), pspec).numpy()
        want = np.asarray(R.aggregate_similarity(
            jnp.asarray(q), jnp.asarray(w), jnp.asarray(p), rspec))
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_expand_weights_matches():
    rspec, pspec = _specs()
    w = np.asarray([[0.2, 0.3, 0.5], [1.0, 0.0, 2.0]], np.float32)
    got = P.expand_weights(torch.as_tensor(w), pspec).numpy()
    want = np.asarray(R.expand_weights(jnp.asarray(w), rspec))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w", [
    [0.2, 0.3, 0.5], [[0.1, 0.0, 0.9], [1.0, 1.0, 1.0]], [0.0, 0.0, 1e-9],
    [-0.1, 0.5, 0.6], [0.0, 0.0, 0.0], [[0.1, 0.2, 0.3], [0.0, 0.0, 0.0]],
    [np.nan, 0.2, 0.3], [np.inf, 0.2, 0.3], [0.5, 0.5], [1.0], 0.5,
])
def test_validate_weights_same_verdict(w):
    """validate_weights accepts and rejects exactly what the reference
    does (the error cases of tests/test_weights.py, plus shape errors)."""
    rspec, pspec = _specs()
    try:
        want = R.validate_weights(w, rspec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.validate_weights(w, pspec)
        assert str(got.value).split(",")[0] == str(e).split(",")[0]
    else:
        np.testing.assert_array_equal(P.validate_weights(w, pspec), want)


def test_weighted_query_treats_bare_batch_as_concatenated():
    """A bare (nq, D) array is a batch of concatenated queries, never a list
    of per-field blocks (the reference's weights.py:102 fix)."""
    _, pspec = _specs()
    q = torch.randn(2, pspec.total_dim, generator=torch.Generator()
                    .manual_seed(0))
    w = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    out = P.weighted_query(q, w, pspec)
    assert out.shape == (2, pspec.total_dim)
    assert torch.all(out[0, 16:] == 0) and torch.all(out[1, :24] == 0)


def test_cosine_distance_and_nwd_match():
    rspec, pspec = _specs()
    rng = np.random.default_rng(4)
    x = np.asarray(R.normalize_fields(jnp.asarray(rng.normal(
        size=(6, pspec.total_dim)).astype(np.float32)), rspec))
    y = x[::-1].copy()
    np.testing.assert_allclose(
        P.cosine_distance(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
        np.asarray(R.cosine_distance(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-6)
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    got = P.nwd(torch.as_tensor(x[0]), torch.as_tensor(w),
                torch.as_tensor(x), pspec).numpy()
    want = np.asarray(R.nwd(jnp.asarray(x[0]), jnp.asarray(w), jnp.asarray(x),
                            rspec))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("seed", range(12))
def test_nwd_affine_in_ws(seed):
    """NWD = 1 - WS/|Q_w| (tests/test_weights.py::test_nwd_affine_in_ws),
    at the same tolerance, on the port; and equal to the reference's NWD."""
    rspec, pspec = _specs()
    rng = np.random.default_rng(seed)
    docs = np.asarray(R.normalize_fields(jnp.asarray(rng.normal(
        size=(32, pspec.total_dim)).astype(np.float32)), rspec))
    q = docs[seed % 32]
    w = rng.uniform(0.0, 1.0, size=3).astype(np.float32)
    w[seed % 3] += 0.1
    qt, wt, dt = (torch.as_tensor(v) for v in (q, w, docs))
    ws = P.aggregate_similarity(qt, wt, dt, pspec)
    norm = torch.linalg.vector_norm(P.weighted_query(qt, wt, pspec,
                                                     normalize=False))
    d = P.nwd(qt, wt, dt, pspec)
    np.testing.assert_allclose(d.numpy(), (1.0 - ws / norm).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        d.numpy(), np.asarray(R.nwd(jnp.asarray(q), jnp.asarray(w),
                                    jnp.asarray(docs), rspec)),
        atol=1e-6)
