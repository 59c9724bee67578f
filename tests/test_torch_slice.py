"""PyTorch port, the slice end to end: the JAX package builds and saves an
index, the port loads it, and both engines of the port (the fused one
through the plain kernel versions on the CPU) and the typed API answer as
the reference does. The saved archive is the bridge both ways."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro_torch import core as P  # noqa: E402

K_CLUSTERS, PROBES, K = 24, 12, 10


@pytest.fixture(scope="module")
def saved(small_corpus, tmp_path_factory):
    docs, spec, _ = small_corpus
    index = R.ClusterPruneIndex.build(
        docs, spec, K_CLUSTERS, n_clusterings=3, method="fpf",
        key=jax.random.PRNGKey(0),
    )
    path = tmp_path_factory.mktemp("bridge") / "index.npz"
    index.save(path)
    return index, path


@pytest.fixture(scope="module")
def port_index(saved):
    return P.ClusterPruneIndex.load(saved[1], device="cpu")


@pytest.fixture(scope="module")
def queries(saved):
    """MLT queries with Dirichlet field weights, checked free of near ties
    at the k-th result and at every clustering's probe boundary, so that
    exact id parity is meaningful."""
    index, _ = saved
    rng = np.random.default_rng(11)
    qids = rng.choice(index.n_docs, 20, replace=False)
    w = rng.dirichlet([1.0] * 3, size=20).astype(np.float32)
    qw = np.array(R.weighted_query(index.docs[qids], jnp.asarray(w),
                                   index.spec))
    s, _, _ = R.get_engine(index, "reference").search(
        jnp.asarray(qw), probes=PROBES, k=K + 1,
        exclude=jnp.asarray(qids, jnp.int32))
    s = np.asarray(s)
    assert np.all(s[:, K - 1] - s[:, K] > 1e-5)
    lsims = np.einsum("tkd,qd->qtk", np.asarray(index.leaders, np.float64),
                      qw.astype(np.float64))
    srt = -np.sort(-lsims, axis=-1)
    for t, p in enumerate(R.split_probes(PROBES, 3)):
        assert np.all(srt[:, t, p - 1] - srt[:, t, p] > 1e-6)
    return qids, w, qw


def test_load_equals_from_numpy_equals_reference(saved, port_index):
    index, path = saved
    with np.load(path) as z:
        again = P.ClusterPruneIndex.from_numpy(dict(z), device="cpu")
    for got in (port_index, again):
        assert got.spec.names == index.spec.names
        assert got.spec.dims == index.spec.dims
        for name in ("docs", "leaders", "buckets", "counts"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(index, name)))
        np.testing.assert_array_equal(got.assign, index.assign)
        assert got.method == index.method and got.pack_dtype is None
        assert got.n_docs == got.n_live == index.n_docs


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("case", ["plain", "exclude", "rescore", "clamp"])
def test_engines_match_reference(saved, port_index, queries, backend, case):
    """Ids and n_scored equal to the JAX reference backend, scores within
    1e-5: with per-query exclude, the exact-rescore tail, and an oversized
    probe budget that clamps to T·K."""
    index, _ = saved
    qids, _, qw = queries
    kw = dict(probes=PROBES, k=K)
    excl = None
    if case != "plain":
        excl = qids.astype(np.int32)
    if case == "rescore":
        kw["rescore"] = 3 * K
    if case == "clamp":
        kw["probes"] = 10_000
    r_s, r_i, r_n = R.get_engine(index, "reference").search(
        jnp.asarray(qw), exclude=None if excl is None else jnp.asarray(excl),
        **kw)
    p_s, p_i, p_n = P.get_engine(port_index, backend).search(
        torch.as_tensor(qw),
        exclude=None if excl is None else torch.as_tensor(excl), **kw)
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(p_n.numpy(), np.asarray(r_n))
    np.testing.assert_allclose(p_s.numpy(), np.asarray(r_s), atol=1e-5)
    if excl is not None:
        assert not np.any(p_i.numpy() == excl[:, None])


def test_single_query_and_engine_cache(port_index, queries):
    _, _, qw = queries
    eng = P.get_engine(port_index, "fused")
    assert P.get_engine(port_index, "fused") is eng
    assert P.get_engine(port_index, "fused", query_tile=8) is not eng
    s1, i1, n1 = eng.search(torch.as_tensor(qw[0]), probes=PROBES, k=K)
    s, i, n = eng.search(torch.as_tensor(qw[:1]), probes=PROBES, k=K)
    assert s1.shape == (K,) and torch.equal(i1, i[0]) and int(n1) == int(n[0])
    with pytest.raises(ValueError, match="unknown backend"):
        P.get_engine(port_index, "sharded")


@pytest.mark.parametrize("pack_dtype", [None, "bfloat16", "int8"])
def test_exact_tier_equals_brute_force(saved, port_index, queries,
                                       pack_dtype):
    """Both backends' exact tier equal brute force id for id (quantised
    packs through the fp32 rescore tail), and the port's brute force equals
    the reference's."""
    index, _ = saved
    qids, _, qw = queries
    excl = qids.astype(np.int32)
    r_s, r_i = R.brute_force_topk(index.docs, jnp.asarray(qw), K,
                                  exclude=jnp.asarray(excl))
    p_s, p_i = P.brute_force_topk(port_index.docs, torch.as_tensor(qw), K,
                                  exclude=torch.as_tensor(excl), chunk=500)
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(p_s.numpy(), np.asarray(r_s), atol=1e-5)
    idx = dataclasses.replace(port_index, bucket_data=None,
                              bucket_scales=None, pack_dtype=pack_dtype)
    backends = ["fused"] if pack_dtype else ["reference", "fused"]
    for backend in backends:
        s, i, _ = P.get_engine(idx, backend).search_exact(
            torch.as_tensor(qw), k=K, exclude=torch.as_tensor(excl))
        np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
        np.testing.assert_allclose(s.numpy(), np.asarray(r_s), atol=1e-5)


def test_quantised_packs_keep_the_overlap_floors(port_index, queries):
    """bf16 / int8 packs: top-k overlap with the fp32 pack >= 0.97 / 0.95
    (the floors of tests/test_quality.py); n_scored is unchanged."""
    _, _, qw = queries
    s32, i32, n32 = P.get_engine(port_index, "fused").search(
        torch.as_tensor(qw), probes=PROBES, k=K)
    for pack_dtype, floor in (("bfloat16", 0.97), ("int8", 0.95)):
        idx = dataclasses.replace(port_index, bucket_data=None,
                                  bucket_scales=None, pack_dtype=pack_dtype)
        s, i, n = P.get_engine(idx, "fused").search(torch.as_tensor(qw),
                                                    probes=PROBES, k=K)
        assert idx.bucket_data.dtype == getattr(torch, pack_dtype)
        overlap = np.mean([len(set(a) & set(b)) / K for a, b in
                           zip(i.tolist(), i32.tolist())])
        assert overlap >= floor, (pack_dtype, overlap)
        assert torch.equal(n, n32)


def _requests(mod, qids, w, spec, **kw):
    return [mod.SearchRequest(like=int(q), weights=dict(
        zip(spec.names, map(float, wi))), k=K, **kw)
        for q, wi in zip(qids, w)]


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_retriever_matches_reference(saved, port_index, queries, backend):
    """SearchResponse ids, scores, n_scored, probes and tier equal the
    reference Retriever's, for budgeted, rescored and exact requests in one
    heterogeneous batch; field scores sum to the score."""
    index, _ = saved
    qids, w, _ = queries
    r_ret = R.Retriever(index, backend="reference")
    p_ret = P.Retriever(port_index, backend=backend)
    mix = dict(probes=PROBES)
    reqs = {}
    for mod in (R, P):
        spec = index.spec if mod is R else port_index.spec
        reqs[mod] = (_requests(mod, qids[:8], w[:8], spec, **mix)
                     + _requests(mod, qids[8:12], w[8:12], spec,
                                 probes=PROBES, rescore=2 * K)
                     + _requests(mod, qids[12:16], w[12:16], spec, exact=True)
                     + [mod.SearchRequest(like=int(qids[16]), k=K,
                                          probes=PROBES)])
    r_resp = r_ret.search(reqs[R])
    p_resp = p_ret.search(reqs[P])
    assert len(p_resp) == len(r_resp) == 17
    for a, b in zip(p_resp, r_resp):
        assert a.ids == b.ids
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        assert (a.n_scored, a.probes, a.tier, a.batch_size) == (
            b.n_scored, b.probes, b.tier, b.batch_size)
        assert a.backend == backend
        for h, hb in zip(a.hits, b.hits):
            assert sum(h.field_scores.values()) == pytest.approx(h.score,
                                                                 abs=1e-5)
            for name in h.field_scores:
                assert h.field_scores[name] == pytest.approx(
                    hb.field_scores[name], abs=1e-5)
    # the response cache answers a byte-identical repeat without the engine
    again = p_ret.search(reqs[P][0])
    assert again is p_resp[0]


def test_retriever_validation_and_vector_queries(port_index, queries):
    _, w, qw = queries
    ret = P.Retriever(port_index, backend="fused")
    spec = port_index.spec
    with pytest.raises(ValueError, match="unknown field"):
        ret.search(P.SearchRequest(like=0, weights={"nope": 1.0}))
    with pytest.raises(ValueError, match="non-finite"):
        ret.search(P.SearchRequest(query=np.full(spec.total_dim, np.nan)))
    with pytest.raises(ValueError, match="out of range"):
        ret.search(P.SearchRequest(like=port_index.n_docs))
    with pytest.raises(ValueError, match="calibrate_opts"):
        P.Retriever.build(np.zeros((4, spec.total_dim), np.float32), spec, 2,
                          calibrate_opts={"k": 5}, device="cpu")
    # a raw vector query (per-field blocks) equals the same vector as MLT
    v = port_index.docs[5].numpy()
    blocks = [v[sl] for sl in spec.slices()]
    a = ret.search(P.SearchRequest(query=blocks, weights=list(w[0]),
                                   probes=PROBES, exclude=5))
    b = ret.search(P.SearchRequest(like=5, weights=list(w[0]), probes=PROBES))
    assert a.ids == b.ids
    with pytest.warns(UserWarning, match="static"):
        r = ret.search(P.SearchRequest(like=5, recall_target=0.9))
    assert r.probes == R.plan_probes(0.9, 3, K_CLUSTERS)
    m = ret.search(P.SearchRequest(like=5, min_recall=0.9))
    assert m.tier == "exact" and m.probes == 3 * K_CLUSTERS


def test_port_save_loads_in_reference(port_index, queries, tmp_path):
    """An archive the port writes loads in the reference, and the reference
    answers the same on it."""
    _, _, qw = queries
    idx = dataclasses.replace(port_index, bucket_data=None,
                              bucket_scales=None, pack_dtype="int8")
    idx.ensure_bucket_major()
    idx.save(tmp_path / "port")
    back = R.ClusterPruneIndex.load(tmp_path / "port.npz")
    assert back.pack_dtype == "int8"
    np.testing.assert_array_equal(np.asarray(back.bucket_scales),
                                  idx.bucket_scales.numpy())
    np.testing.assert_array_equal(np.asarray(back.buckets),
                                  idx.buckets.numpy())
    r_s, r_i, r_n = R.get_engine(back, "reference").search(
        jnp.asarray(qw), probes=PROBES, k=K)
    p_s, p_i, p_n = P.get_engine(idx, "reference").search(
        torch.as_tensor(qw), probes=PROBES, k=K)
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(p_n.numpy(), np.asarray(r_n))


def test_load_rejects_ladders_and_corruption(saved, tmp_path):
    """A reference archive with a calibrated ladder loads with that ladder;
    invalid ladder JSON and a truncated archive raise CorruptIndexError."""
    index, path = saved
    from repro.core.calibrate import ProbeLadder

    ladder = ProbeLadder(probes=(3, 6), recall=(0.5, 0.8), n_clusterings=3,
                         k_clusters=K_CLUSTERS, meta={"k": 10})
    laddered = dataclasses.replace(index, ladder=ladder)
    laddered.save(tmp_path / "laddered.npz")
    got = P.ClusterPruneIndex.load(tmp_path / "laddered.npz", device="cpu")
    assert got.ladder.to_dict() == ladder.to_dict()
    with np.load(tmp_path / "laddered.npz") as z:
        members = dict(z)
    members["ladder"] = np.str_("{not json")
    np.savez(tmp_path / "badladder.npz", **members)
    with pytest.raises(P.CorruptIndexError, match="ladder"):
        P.ClusterPruneIndex.load(tmp_path / "badladder.npz", device="cpu")
    raw = path.read_bytes()
    (tmp_path / "cut.npz").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(P.CorruptIndexError):
        P.ClusterPruneIndex.load(tmp_path / "cut.npz", device="cpu")
    with pytest.raises(ValueError, match="unsupported pack_dtype"):
        P.validate_pack_dtype("float16")


def test_port_builds_its_own_index_on_cpu(small_corpus, saved):
    """The port's own build (fpf_fused through the plain rounds on the CPU)
    gives a usable index: recall against brute force at the budget close to
    the reference's own index."""
    docs, spec_j, _ = small_corpus
    index, _ = saved
    spec = P.FieldSpec(spec_j.names, spec_j.dims)
    ret = P.Retriever.build(np.array(docs), spec, K_CLUSTERS,
                            method="fpf_fused", device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert ret.index.method == "fpf_fused" and ret.backend == "reference"
    rng = np.random.default_rng(3)
    qids = rng.choice(index.n_docs, 32, replace=False)
    w = rng.dirichlet([1.0] * 3, size=32).astype(np.float32)
    resp = ret.search(_requests(P, qids, w, spec, probes=PROBES,
                                backend="fused"))
    qw = P.weighted_query(ret.index.docs[torch.as_tensor(qids)],
                          torch.as_tensor(w), spec)
    _, gt = P.brute_force_topk(ret.index.docs, qw, K,
                               exclude=torch.as_tensor(qids))
    got = torch.as_tensor(np.stack([r.doc_ids for r in resp]))
    port_cr = float(P.competitive_recall(got, gt).mean())
    r_resp = R.Retriever(index, backend="reference").search(
        _requests(R, qids, w, spec_j, probes=PROBES))
    r_got = jnp.asarray(np.stack([r.doc_ids for r in r_resp]))
    ref_cr = float(jnp.mean(R.competitive_recall(r_got, jnp.asarray(gt))))
    assert port_cr >= ref_cr - 1.0, (port_cr, ref_cr)


@pytest.mark.parametrize("fn", ["brute_force_topk", "brute_force_bottomk"])
def test_brute_force_with_mask_matches_reference(saved, port_index, queries,
                                                 fn):
    """Ground truth with a tombstone mask and per-query exclude (the port's
    runs through the topk_score plain version): ids equal, scores within
    1e-5, masked rows never returned."""
    index, _ = saved
    qids, _, qw = queries
    mask = np.random.default_rng(9).random(index.n_docs) > 0.1
    excl = qids.astype(np.int32)
    r_s, r_i = getattr(R, fn)(index.docs, jnp.asarray(qw), K,
                              exclude=jnp.asarray(excl),
                              mask=jnp.asarray(mask))
    p_s, p_i = getattr(P, fn)(port_index.docs, torch.as_tensor(qw), K,
                              exclude=torch.as_tensor(excl),
                              mask=torch.as_tensor(mask), chunk=400)
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(p_s.numpy(), np.asarray(r_s), atol=1e-5)
    assert mask[p_i.numpy()].all()


@pytest.fixture(scope="module")
def saved_d300(tmp_path_factory):
    """A reference index over fields of 100, 100 and 100 dims (D = 300,
    rows of no whole 16-byte words in bf16), saved and loaded by the port."""
    from repro.data import CorpusConfig, make_corpus

    docs, spec, _ = make_corpus(CorpusConfig(
        n_docs=600, field_dims=(100, 100, 100), vocab_sizes=(500, 500, 900),
        n_topics=8, seed=4))
    index = R.ClusterPruneIndex.build(jnp.asarray(docs), spec, 16,
                                      n_clusterings=3, method="fpf",
                                      key=jax.random.PRNGKey(1))
    path = tmp_path_factory.mktemp("d300") / "index.npz"
    index.save(path)
    return index, P.ClusterPruneIndex.load(path, device="cpu")


@pytest.mark.parametrize("case", ["d300", "query_tile_32"])
def test_fused_matches_reference_at_any_d_and_tile(saved, port_index,
                                                   queries, saved_d300,
                                                   case):
    """The fused backend at D = 300 and with a 32-query tile: ids equal
    to the reference on rows free of near ties, scores within 1e-5,
    n_scored equal."""
    if case == "d300":
        index, port = saved_d300
        rng = np.random.default_rng(6)
        qids = rng.choice(index.n_docs, 40, replace=False)
        w = rng.dirichlet([1.0] * 3, size=40).astype(np.float32)
        qw = np.array(R.weighted_query(index.docs[qids], jnp.asarray(w),
                                       index.spec))
        opts = {}
    else:
        (index, _), port = saved, port_index
        qids, _, qw = queries
        opts = {"query_tile": 32}
    excl = qids.astype(np.int32)
    r_s, r_i, r_n = (np.asarray(x) for x in R.get_engine(
        index, "reference").search(jnp.asarray(qw), probes=PROBES, k=K + 1,
                                   exclude=jnp.asarray(excl)))
    p_s, p_i, p_n = (x.numpy() for x in P.get_engine(
        port, "fused", **opts).search(torch.as_tensor(qw), probes=PROBES,
                                      k=K, exclude=torch.as_tensor(excl)))
    gaps = -np.diff(np.where(np.isfinite(r_s), r_s, -1e30), axis=1)
    ok = np.all(gaps > 1e-5, axis=1)
    assert ok.mean() > 0.8
    np.testing.assert_array_equal(p_i[ok], r_i[ok, :K])
    np.testing.assert_allclose(p_s, r_s[:, :K], atol=1e-5)
    np.testing.assert_array_equal(p_n, r_n)


# ------------------------- search_weighted, index.search (nav_query, qchunk)
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_search_weighted_matches_reference(saved, port_index, queries,
                                           backend):
    """engine.search_weighted and index.search_weighted (tests/test_engine.py
    :82-110): the same ids and n_scored as the reference's, scores within
    1e-5; a 1-D query keeps the squeezed shape."""
    index, _ = saved
    qids, w, _ = queries
    q = np.array(index.docs[qids])
    r_s, r_i, r_n = R.get_engine(index, "reference").search_weighted(
        jnp.asarray(q), jnp.asarray(w), probes=PROBES, k=K)
    for out in (P.get_engine(port_index, backend).search_weighted(
                    torch.as_tensor(q), torch.as_tensor(w), probes=PROBES,
                    k=K),
                port_index.search_weighted(torch.as_tensor(q),
                                           torch.as_tensor(w), probes=PROBES,
                                           k=K, backend=backend)):
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(r_i))
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(r_n))
        np.testing.assert_allclose(out[0].numpy(), np.asarray(r_s),
                                   atol=1e-5)
    eng = P.get_engine(port_index, backend)
    s, i, n = eng.search_weighted(torch.as_tensor(q[0]), torch.as_tensor(w[0]),
                                  probes=PROBES, k=K)
    assert s.shape == (K,) and i.shape == (K,) and n.shape == ()
    assert torch.equal(i, torch.as_tensor(np.array(r_i[0])))
    s, i, n = port_index.search(torch.as_tensor(q[0]), probes=PROBES, k=K,
                                backend=backend)
    assert s.shape == (K,) and n.shape == ()


def test_index_search_delegates_with_nav_query(saved, port_index, queries):
    """index.search defaults to the reference backend, passes nav_query to
    navigation (probes from nav, scores from qw) as the reference does,
    and both backends agree."""
    index, _ = saved
    qids, _, qw = queries
    nav = np.roll(qw, 1, axis=0)
    want = index.search(jnp.asarray(qw), probes=PROBES, k=K,
                        nav_query=jnp.asarray(nav))
    for backend in ("reference", "fused"):
        got = port_index.search(torch.as_tensor(qw), probes=PROBES, k=K,
                                nav_query=torch.as_tensor(nav),
                                backend=backend)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5)
    plain = port_index.search(torch.as_tensor(qw), probes=PROBES, k=K)
    eng = P.get_engine(port_index, "reference").search(
        torch.as_tensor(qw), probes=PROBES, k=K)
    assert all(torch.equal(a, b) for a, b in zip(plain, eng))


def test_index_search_qchunk_silent_drop_fixed(port_index, queries):
    """qchunk with a non-reference backend raises instead of being dropped
    (tests/test_api.py::test_index_search_qchunk_silent_drop_fixed); the
    reference backend honours it."""
    _, _, qw = queries
    x = torch.as_tensor(qw[5:7])
    with pytest.raises(ValueError, match="qchunk"):
        port_index.search(x, probes=6, k=5, qchunk=4, backend="fused")
    s, i, n = port_index.search(x, probes=6, k=5, qchunk=1,
                                backend="reference")
    s2, i2, n2 = port_index.search(x, probes=6, k=5, backend="fused")
    assert torch.equal(i, i2) and torch.equal(n, n2)
    assert ("reference", (("qchunk", 1),)) in port_index._engines
