"""PyTorch port, the baselines: the ``kmeans`` and ``random`` clusterers,
the centroid tail, and the CellDec weight-region index, against the JAX
reference on the same inputs (the reference's random draws injected, or
its saved region indexes loaded)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core.cluster import _centroids as r_centroids  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core.cluster import _centroids as p_centroids  # noqa: E402

# reps of k-means / random leaders: centroids summed in another order than
# the reference's segment_sum (2.98e-8 .. 5.96e-8 seen), 1e-5 allowed
REPS_ATOL = 1e-5


def _np(x):
    return np.array(x)          # writable copy for torch.as_tensor


def _pspec(spec):
    return P.FieldSpec(spec.names, spec.dims)


def _clear(x, reps, gap=1e-5):
    """Points whose best rep beats the second by more than ``gap``."""
    sims = np.asarray(x, np.float64) @ np.asarray(reps, np.float64).T
    top2 = np.sort(sims, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > gap


def test_registry_has_all_four():
    assert set(P.available_clusterers()) >= {"fpf", "fpf_fused", "kmeans",
                                             "random"}
    assert isinstance(P.get_clusterer("kmeans"), P.Clusterer)
    assert P.get_clusterer("kmeans", iters=3).iters == 3


@pytest.mark.parametrize("method", ["fpf", "fpf_fused", "kmeans", "random"])
def test_clusterers_cover(random_corpus, method):
    x, _ = random_corpus
    res = P.get_clusterer(method).cluster(torch.as_tensor(_np(x)), 16,
                                          torch.Generator().manual_seed(0))
    assert res.reps.shape == (16, x.shape[1])
    assert int(res.counts.sum()) == x.shape[0]
    assert float(res.max_radius) <= 2.0 + 1e-5


@pytest.mark.parametrize("iters", [1, 3, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_matches_reference_with_injected_init(random_corpus, iters,
                                                     seed):
    """The reference's first centroids injected as ``init_idx``: equal
    assignment on every point whose best centroid clears the second by
    more than 1e-5, reps within 1e-5. On this corpus (1200 points, K = 12)
    every one of 1..20 Lloyd iterations stayed exact: no assignment
    differed and the reps were at most 5.96e-8 apart."""
    x, _ = random_corpus
    k, key = 12, jax.random.PRNGKey(seed)
    ref = R.get_clusterer("kmeans", iters=iters).cluster(x, k, key)
    init = _np(jax.random.permutation(key, x.shape[0])[:k])
    got = P.get_clusterer("kmeans", iters=iters).cluster(
        torch.as_tensor(_np(x)), k, init_idx=init)
    np.testing.assert_allclose(got.reps.numpy(), np.asarray(ref.reps),
                               atol=REPS_ATOL, rtol=0)
    clear = _clear(x, ref.reps)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got.assign.numpy()[clear],
                                  np.asarray(ref.assign)[clear])
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(ref.counts))
    assert float(got.max_radius) == pytest.approx(float(ref.max_radius),
                                                  abs=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_leaders_match_reference_with_injected_leaders(random_corpus,
                                                              seed):
    """The reference's leaders injected as ``leader_idx``: the original
    leader assignment (clear points equal), centroid reps within 1e-5, and
    the radius measured from the centroids."""
    x, _ = random_corpus
    k, key = 12, jax.random.PRNGKey(seed)
    ref = R.get_clusterer("random").cluster(x, k, key)
    lead = _np(jax.random.permutation(key, x.shape[0])[:k])
    got = P.get_clusterer("random").cluster(torch.as_tensor(_np(x)), k,
                                            leader_idx=lead)
    clear = _clear(x, x[jnp.asarray(lead)])
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got.assign.numpy()[clear],
                                  np.asarray(ref.assign)[clear])
    np.testing.assert_allclose(got.reps.numpy(), np.asarray(ref.reps),
                               atol=REPS_ATOL, rtol=0)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(ref.counts))
    assert float(got.max_radius) == pytest.approx(float(ref.max_radius),
                                                  abs=1e-5)


def test_centroids_match_and_empty_clusters_keep_prev(random_corpus):
    x, _ = random_corpus
    xn = _np(x)
    a = np.random.default_rng(0).integers(0, 10, size=len(xn))
    a[a == 4] = 5                                  # cluster 4 empty
    prev = xn[:10]
    got = p_centroids(torch.as_tensor(xn), torch.as_tensor(a), 10,
                      torch.as_tensor(prev))
    want = r_centroids(x, jnp.asarray(a), 10, jnp.asarray(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), prev[4])


def test_assign_refine_rep_update(random_corpus):
    x, _ = random_corpus
    xt = torch.as_tensor(_np(x))
    with pytest.raises(ValueError, match="rep_update"):
        P.assign_refine(xt, 8, xt[:8], refine_iters=1, rep_update="mean")
    for mode in ("medoid", "centroid"):
        got = P.assign_refine(xt, 8, xt[:8], refine_iters=2, rep_update=mode)
        want = R.assign_refine(x, 8, x[:8], refine_iters=2, rep_update=mode)
        np.testing.assert_allclose(got.reps.numpy(), np.asarray(want.reps),
                                   atol=REPS_ATOL, rtol=0)


def test_function_forms(random_corpus):
    x, _ = random_corpus
    xt = torch.as_tensor(_np(x))
    for fn, name, opts in ((P.fpf_cluster, "fpf", {}),
                           (P.kmeans_cluster, "kmeans", {"iters": 2}),
                           (P.random_leader_cluster, "random", {})):
        a = fn(xt, 8, torch.Generator().manual_seed(5), **opts)
        b = P.get_clusterer(name, **opts).cluster(
            xt, 8, torch.Generator().manual_seed(5))
        assert torch.equal(a.assign, b.assign) and torch.equal(a.reps, b.reps)


def test_custom_clusterer_builds_an_index(random_corpus):
    """register -> build(method=name) -> search, as the reference's
    recipe; the full probe is exact."""
    x, spec = random_corpus
    pspec = _pspec(spec)

    @P.register_clusterer("_test_stride")
    class StrideClusterer:
        def __init__(self, **_):
            pass

        def cluster(self, x, k, generator=None):
            reps = x[:: max(1, x.shape[0] // k)][:k]
            return P.assign_refine(x, k, reps)

    try:
        idx = P.ClusterPruneIndex.build(_np(x), pspec, 8, n_clusterings=2,
                                        method="_test_stride", device="cpu")
        assert idx.method == "_test_stride"
        qw = P.weighted_query(idx.docs[:4], torch.ones(4, 3) / 3, pspec)
        _, ids, _ = idx.search(qw, probes=16, k=5)
        _, gt = P.brute_force_topk(idx.docs, qw, 5)
        np.testing.assert_array_equal(np.sort(ids.numpy()),
                                      np.sort(gt.numpy()))
    finally:
        P.CLUSTERERS.pop("_test_stride", None)


# ------------------------------------------------------------- CellDec
def test_celldec_regions():
    assert int(P.region_of(torch.tensor([0.6, 0.2, 0.2]), 3)) == 0
    assert int(P.region_of(torch.tensor([0.2, 0.6, 0.2]), 3)) == 1
    assert int(P.region_of(torch.tensor([0.2, 0.2, 0.6]), 3)) == 2
    assert int(P.region_of(torch.tensor([0.34, 0.33, 0.33]), 3)) == 3
    # ties among the big weights go to the first maximum
    w = np.asarray([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5],
                    [0.5, 0.25, 0.25], [0.49, 0.02, 0.49]], np.float32)
    w = np.concatenate([w, np.random.default_rng(0).dirichlet(
        [0.5] * 3, size=200).astype(np.float32)])
    np.testing.assert_array_equal(P.region_of(torch.as_tensor(w), 3).numpy(),
                                  np.asarray(R.region_of(jnp.asarray(w), 3)))
    spec = R.FieldSpec(("a", "b", "c"), (2, 2, 2))
    for theta in (0.5, 0.25):
        np.testing.assert_array_equal(P.region_weights(_pspec(spec), theta),
                                      R.region_weights(spec, theta))


def test_celldec_search(small_corpus):
    docs, spec, _ = small_corpus
    pspec = _pspec(spec)
    cd = P.CellDecIndex.build(_np(docs), pspec, 30, method="kmeans", iters=3,
                              device="cpu")
    assert len(cd.indexes) == 4
    assert all(i.bucket_data is None and i.method == "kmeans"
               for i in cd.indexes)
    w = torch.tensor([[0.6, 0.2, 0.2], [0.33, 0.34, 0.33]])
    s, i, n = cd.search_weighted(cd.docs[4:6], w, probes=8, k=10)
    qw = P.weighted_query(cd.docs[4:6], w, pspec)
    _, gt_i = P.brute_force_topk(cd.docs, qw, 10)
    assert float(P.competitive_recall(i, gt_i).mean()) >= 3.0


@pytest.fixture(scope="module")
def celldec_pair(small_corpus, tmp_path_factory):
    """The reference's CellDec (k-means, 3 iterations, K = 30) and the
    port's, made of the reference's region indexes saved and loaded."""
    docs, spec, _ = small_corpus
    ref = R.CellDecIndex.build(docs, spec, 30, method="kmeans", iters=3,
                               key=jax.random.PRNGKey(4))
    d = tmp_path_factory.mktemp("celldec")
    regions = []
    for r, idx in enumerate(ref.indexes):
        idx.save(d / f"region{r}.npz")
        regions.append(P.ClusterPruneIndex.load(d / f"region{r}.npz",
                                                device="cpu"))
    port = P.CellDecIndex(spec=_pspec(spec), theta=ref.theta,
                          indexes=regions,
                          docs=torch.as_tensor(_np(docs)))
    return ref, port


def test_celldec_search_matches_reference_on_its_regions(celldec_pair,
                                                         small_corpus):
    """Queries of every region, with exclude: equal ids, exact scores
    within 1e-5 and equal n_scored (the queries are checked free of near
    ties at the k-th composite score, so ids are fixed)."""
    ref, port = celldec_pair
    docs, spec, _ = small_corpus
    rng = np.random.default_rng(7)
    nq = 24
    qids = rng.choice(docs.shape[0], nq, replace=False).astype(np.int32)
    w = np.concatenate([
        np.tile([[0.6, 0.2, 0.2], [0.2, 0.7, 0.1], [0.1, 0.2, 0.7]], (4, 1)),
        rng.dirichlet([4.0] * 3, size=nq - 12)]).astype(np.float32)
    regions = np.asarray(R.region_of(jnp.asarray(w), 3))
    assert set(regions.tolist()) == {0, 1, 2, 3}
    q = _np(docs)[qids]
    s_r, i_r, n_r = ref.search_weighted(jnp.asarray(q), jnp.asarray(w),
                                        probes=6, k=10,
                                        exclude=jnp.asarray(qids))
    s_p, i_p, n_p = port.search_weighted(torch.as_tensor(q),
                                         torch.as_tensor(w), probes=6, k=10,
                                         exclude=torch.as_tensor(qids))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), atol=1e-5)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))
    # the exact rescore: scores are docs[ids] . qw, sorted descending
    qw = P.weighted_query(torch.as_tensor(q), torch.as_tensor(w), port.spec)
    want = torch.einsum("qkd,qd->qk", port.docs[i_p.long()], qw)
    np.testing.assert_allclose(s_p.numpy(), want.numpy(), atol=1e-6)
    assert torch.all(s_p[:, :-1] >= s_p[:, 1:])
    assert not np.any(i_p.numpy() == qids[:, None])


def test_celldec_sort_is_stable_on_equal_scores(celldec_pair):
    """Equal exact scores keep the region index's order, as
    jnp.argsort(-exact) does: a query whose only weighted field is zero
    scores every candidate 0."""
    _, port = celldec_pair
    q = port.docs[:1].clone()
    q[:, port.spec.slices()[0]] = 0.0
    s, i, _ = port.search_weighted(q, torch.tensor([[1.0, 0.0, 0.0]]),
                                   probes=30, k=10)
    assert torch.all(s == 0)
    comp_q = P.weighted_query(q, torch.tensor([[1.0, 0.5, 0.5]]), port.spec)
    _, i_idx, _ = port.indexes[0].search(comp_q, probes=30, k=10)
    assert torch.equal(i, i_idx)


def test_celldec_build_with_injected_draws_matches_reference(small_corpus):
    """CellDec built by the port with the reference's per-region k-means
    draws: each region's leaders within 1e-5 and its assignment equal on
    points clear of near ties."""
    docs, spec, _ = small_corpus
    key = jax.random.PRNGKey(1)
    ref = R.CellDecIndex.build(docs, spec, 20, method="kmeans", iters=2,
                               key=key)
    n = docs.shape[0]
    draws = []
    for sub in jax.random.split(key, spec.s + 1):
        (sub_t,) = jax.random.split(sub, 1)
        draws.append([{"init_idx": _np(jax.random.permutation(sub_t, n)[:20])}])
    port = P.CellDecIndex.build(_np(docs), _pspec(spec), 20, method="kmeans",
                                iters=2, device="cpu", draws=draws)
    for r_idx, p_idx in zip(ref.indexes, port.indexes):
        np.testing.assert_allclose(p_idx.leaders.numpy(),
                                   np.asarray(r_idx.leaders), atol=REPS_ATOL)
        np.testing.assert_allclose(p_idx.docs.numpy(),
                                   np.asarray(r_idx.docs), atol=1e-6)
        clear = _clear(r_idx.docs, r_idx.leaders[0])
        assert clear.mean() > 0.95
        np.testing.assert_array_equal(p_idx.assign[0][clear],
                                      r_idx.assign[0][clear])


def test_celldec_composites_are_equal_in_both_packages(small_corpus):
    """The reference's composite re-normalises each field after squeezing
    it, which undoes the squeeze: the four region corpora are the same
    (the regions differ only in their draws). The port keeps this."""
    docs, spec, _ = small_corpus
    ref = R.CellDecIndex.build(docs[:300], spec, 8, method="random")
    port = P.CellDecIndex.build(_np(docs[:300]), _pspec(spec), 8,
                                method="random", device="cpu")
    for cd in (ref, port):
        first = np.asarray(cd.indexes[0].docs)
        for idx in cd.indexes[1:]:
            np.testing.assert_array_equal(np.asarray(idx.docs), first)


def test_celldec_refuses_cpu_fallback(monkeypatch, small_corpus):
    docs, spec, _ = small_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.CellDecIndex.build(_np(docs[:100]), _pspec(spec), 4)


def test_paper_ordering_on_structured_corpus(small_corpus):
    """Our FPF x3 >= PODS07 (random leaders, one clustering) - 0.2 at equal
    probes on a topical corpus with unequal weights, built by the port."""
    docs, spec, _ = small_corpus
    pspec = _pspec(spec)
    n = docs.shape[0]
    rng = np.random.default_rng(0)
    qids = torch.as_tensor(rng.choice(n, 40, replace=False), dtype=torch.int32)
    dt = torch.as_tensor(_np(docs))
    qw = P.weighted_query(dt[qids.long()],
                          torch.tensor([[0.6, 0.2, 0.2]]).repeat(40, 1), pspec)
    _, gt_i = P.brute_force_topk(dt, qw, 10, exclude=qids)
    ours = P.ClusterPruneIndex.build(dt, pspec, 40, n_clusterings=3,
                                     method="fpf", device="cpu")
    pods = P.ClusterPruneIndex.build(dt, pspec, 40, n_clusterings=1,
                                     method="random", device="cpu")
    _, ids_o, _ = ours.search(qw, probes=9, k=10, exclude=qids)
    _, ids_p, _ = pods.search(qw, probes=9, k=10, exclude=qids)
    rec_o = float(P.competitive_recall(ids_o, gt_i).mean())
    rec_p = float(P.competitive_recall(ids_p, gt_i).mean())
    assert rec_o >= rec_p - 0.2, (rec_o, rec_p)
