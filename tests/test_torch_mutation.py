"""PyTorch port, index mutations: ``add_documents`` / ``remove_documents``,
``Retriever.add`` / ``remove`` and their caches, replayed against the JAX
reference on the same inputs (the reference builds and saves the index, the
port loads it, and both apply the same mutations)."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro_torch import core as P  # noqa: E402

BACKENDS = ("reference", "fused")
N_BASE, K_CLUSTERS = 1000, 16


def _np(x):
    return np.array(x)          # writable copy for torch.as_tensor


@pytest.fixture(scope="module")
def saved(random_corpus, tmp_path_factory):
    """The reference's index over the first 1000 docs (the remaining 200
    are add fodder), saved for the port."""
    docs, spec = random_corpus
    idx = R.ClusterPruneIndex.build(docs[:N_BASE], spec, K_CLUSTERS,
                                    n_clusterings=3, method="fpf",
                                    key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("mutation") / "index.npz"
    idx.save(path)
    return path


@pytest.fixture()
def pair(saved, random_corpus):
    """A fresh reference index and the port's copy of it, and the corpus
    as numpy."""
    docs, spec = random_corpus
    return (R.ClusterPruneIndex.load(saved),
            P.ClusterPruneIndex.load(saved, device="cpu"), _np(docs), spec)


def _qw(docs, rows, spec, w=None):
    w = np.full((len(rows), 3), 1 / 3, np.float32) if w is None else w
    return _np(R.weighted_query(jnp.asarray(docs[rows]), jnp.asarray(w), spec))


def _assert_same_state(ref, port):
    np.testing.assert_array_equal(port.buckets.numpy(), np.asarray(ref.buckets))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(port.assign, ref.assign)
    # added rows pass through normalize_fields: fp32 ulps apart
    np.testing.assert_allclose(port.docs.numpy(), np.asarray(ref.docs),
                               atol=1e-6, rtol=0)
    assert (port.n_docs, port.n_live, port.n_mutations) == (
        ref.n_docs, ref.n_live, ref.n_mutations)
    if ref.removed is None:
        assert port.removed is None
    else:
        np.testing.assert_array_equal(port.removed, ref.removed)


def _clear_margins(x, leaders, gap=1e-5):
    """(T, m) mask of points whose best leader beats the second by more
    than ``gap`` (float64), where argmax is fixed whatever the order of
    the fp32 sums."""
    sims = np.einsum("nd,tkd->tnk", x.astype(np.float64),
                     leaders.astype(np.float64))
    top2 = np.sort(sims, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > gap


def test_add_documents_matches_reference(pair):
    """add_documents on the reference's archive gives the reference's
    buckets, counts and assign exactly (every new doc's best leader clears
    the second by more than 1e-5 here, so the argmax is not a near tie)."""
    ref, port, docs, _ = pair
    new = docs[N_BASE:N_BASE + 100]
    assert _clear_margins(new, port.leaders.numpy()).all()
    ids_r = ref.add_documents(jnp.asarray(new))
    ids_p = port.add_documents(new)
    np.testing.assert_array_equal(ids_p, ids_r)
    _assert_same_state(ref, port)
    assert port.version == 1 and port.bucket_data is None


def test_assign_multi_matches_per_clustering_loop(pair):
    _, port, docs, _ = pair
    x = torch.as_tensor(docs[N_BASE:N_BASE + 100])
    multi_a, multi_s = P.assign_to_centers_multi(x, port.leaders, chunk=32)
    for ti in range(port.leaders.shape[0]):
        a, s = P.assign_to_centers(x, port.leaders[ti], chunk=32)
        assert torch.equal(multi_a[ti], a)
        np.testing.assert_allclose(multi_s[ti].numpy(), s.numpy(), atol=1e-6)


def test_batched_ingest_matches_one_by_one(pair):
    _, port, docs, _ = pair
    port2 = copy.deepcopy(port)
    port.add_documents(docs[N_BASE:N_BASE + 100])
    for i in range(N_BASE, N_BASE + 100):
        port2.add_documents(docs[i:i + 1])
    assert torch.equal(port.counts, port2.counts)
    np.testing.assert_array_equal(port.assign, port2.assign)
    b1, b2 = port.buckets.numpy(), port2.buckets.numpy()
    assert b1.shape == b2.shape
    np.testing.assert_array_equal(np.sort(b1, axis=-1), np.sort(b2, axis=-1))


def test_add_documents_ids_and_state(pair):
    _, port, docs, _ = pair
    port.ensure_bucket_major()
    v0 = port.version
    ids = port.add_documents(docs[N_BASE:N_BASE + 100])
    np.testing.assert_array_equal(ids, np.arange(N_BASE, N_BASE + 100))
    assert port.n_docs == 1100 and port.n_live == 1100
    assert port.version == v0 + 1 and port.n_mutations == 100
    assert port.assign.shape == (3, 1100)
    assert port.bucket_data is None
    assert "_bucket_major_flat" not in port.__dict__
    bk = port.buckets.numpy()
    assert int((bk < 1100).sum()) == 3 * 1100
    assert int(port.counts.sum()) == 3 * 1100
    # padding holds the new sentinel; the bucket-major ids are -1 there
    assert set(np.unique(bk[bk >= 1100]).tolist()) <= {1100}
    _, flat_ids, _ = port.ensure_bucket_major()
    assert int((flat_ids >= 0).sum()) == 3 * 1100
    assert int(flat_ids.min()) == -1 and int(flat_ids.max()) < 1100


@pytest.mark.parametrize("backend", BACKENDS)
def test_added_docs_retrievable_on_every_backend(pair, backend):
    """A copy of doc q is q's nearest neighbour: after adding copies, hit
    #1 for like=q is the copy, in both packages."""
    ref, port, docs, spec = pair
    src = np.asarray([3, 141, 592, 888])
    new_r = ref.add_documents(jnp.asarray(docs[src]))
    new_p = port.add_documents(docs[src])
    np.testing.assert_array_equal(new_p, new_r)
    qw = _qw(docs, src, spec)
    s, ids, n = P.get_engine(port, backend).search(
        torch.as_tensor(qw), probes=12, k=5,
        exclude=torch.as_tensor(src, dtype=torch.int32))
    np.testing.assert_array_equal(ids[:, 0].numpy(), new_p)
    s_r, ids_r, n_r = R.get_engine(ref, backend).search(
        jnp.asarray(qw), probes=12, k=5, exclude=jnp.asarray(src, jnp.int32))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_r))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), atol=1e-5)


def test_full_probe_after_add_is_exact(pair):
    _, port, docs, spec = pair
    port.add_documents(docs[N_BASE:])
    qw = torch.as_tensor(_qw(docs, np.arange(37, 41), spec))
    _, ids, _ = port.search(qw, probes=3 * K_CLUSTERS, k=7)
    _, gt_i = P.brute_force_topk(port.docs, qw, 7)
    np.testing.assert_array_equal(np.sort(ids.numpy()),
                                  np.sort(gt_i.numpy()))


def test_bucket_padding_grows_on_overflow(pair):
    """Clones of one doc overflow its bucket: B grows to the next multiple
    of 8 (the reference's B), every copy stays retrievable."""
    ref, port, docs, spec = pair
    b_before = port.buckets.shape[-1]
    clones = np.tile(docs[7][None, :], (b_before + 5, 1))
    new_ids = port.add_documents(clones)
    ref.add_documents(jnp.asarray(clones))
    b_after = port.buckets.shape[-1]
    assert b_after > b_before and b_after % 8 == 0
    _assert_same_state(ref, port)
    qw = torch.as_tensor(_qw(docs, [7], spec))
    for backend in BACKENDS:
        _, ids, _ = port.search(qw, probes=3 * K_CLUSTERS, k=len(new_ids),
                                exclude=torch.tensor([7]), backend=backend)
        assert set(new_ids.tolist()) <= set(ids.reshape(-1).tolist())


def test_add_grows_b_only_on_overflow(pair):
    """Adds that fit in the padding keep B."""
    _, port, docs, _ = pair
    b = port.buckets.shape[-1]
    port.add_documents(docs[N_BASE:N_BASE + 3])
    assert port.buckets.shape[-1] == b


def test_add_rejects_bad_dim(pair):
    _, port, _, spec = pair
    with pytest.raises(ValueError, match="concat dim"):
        port.add_documents(np.ones((2, 5), np.float32))
    assert port.add_documents(np.zeros((0, spec.total_dim))).size == 0
    assert port.version == 0


def test_add_normalises_fields_as_reference(pair):
    ref, port, docs, _ = pair
    raw = 3.0 * docs[N_BASE:N_BASE + 5]
    raw[:, :32] *= 2.0
    ref.add_documents(jnp.asarray(raw))
    port.add_documents(raw)
    np.testing.assert_allclose(port.docs[N_BASE:].numpy(),
                               np.asarray(ref.docs[N_BASE:]), atol=1e-6)


def test_removed_docs_never_returned(pair):
    ref, port, docs, spec = pair
    qw = torch.as_tensor(_qw(docs, np.arange(10, 14), spec))
    _, ids0, _ = port.search(qw, probes=12, k=5)
    victims = np.unique(ids0.numpy().reshape(-1))
    victims = victims[victims >= 0][:6]
    assert port.remove_documents(victims) == len(victims)
    assert ref.remove_documents(victims) == len(victims)
    _assert_same_state(ref, port)
    assert port.n_live == N_BASE - len(victims)
    for backend in BACKENDS:
        _, ids, _ = P.get_engine(port, backend).search(qw, probes=48, k=10)
        live = ids.numpy().reshape(-1)
        assert not set(victims.tolist()) & set(live[live >= 0].tolist())
    _, gt = P.brute_force_topk(port.docs, qw, 10,
                               mask=torch.as_tensor(~port.removed))
    assert not set(victims.tolist()) & set(gt.reshape(-1).tolist())
    v = port.version
    assert port.remove_documents(victims) == 0 and port.version == v
    with pytest.raises(ValueError, match="doc ids must be in"):
        port.remove_documents([10_000])
    with pytest.raises(ValueError, match="doc ids must be in"):
        port.remove_documents([-1])


def test_remove_then_add_reuses_slots(pair):
    ref, port, docs, spec = pair
    b_before = port.buckets.shape[-1]
    port.remove_documents(np.arange(100))
    ref.remove_documents(np.arange(100))
    assert int(port.counts.sum()) == 3 * 900
    port.add_documents(docs[N_BASE:N_BASE + 100])
    ref.add_documents(jnp.asarray(docs[N_BASE:N_BASE + 100]))
    assert port.buckets.shape[-1] == b_before
    assert int(port.counts.sum()) == 3 * 1000
    _assert_same_state(ref, port)
    qw = torch.as_tensor(_qw(docs, np.arange(50, 54), spec))
    _, ids, _ = port.search(qw, probes=48, k=10)
    live = ids.numpy().reshape(-1)
    assert not (set(range(100)) & set(live[live >= 0].tolist()))


def test_engine_cache_and_pack_dropped_on_mutation(pair):
    """A cached engine and the bucket-major pack never outlive a mutation:
    the fused answer after an add sees the new doc."""
    _, port, docs, spec = pair
    eng = P.get_engine(port, "fused")
    qw = torch.as_tensor(_qw(docs, [5], spec))
    eng.search(qw, probes=12, k=3, exclude=torch.tensor([5]))
    data0 = port.ensure_bucket_major()[0]
    [new_id] = port.add_documents(docs[5:6])
    assert "_engines" not in port.__dict__ and port.bucket_data is None
    eng2 = P.get_engine(port, "fused")
    assert eng2 is not eng
    _, ids, _ = eng2.search(qw, probes=12, k=3, exclude=torch.tensor([5]))
    assert int(ids[0, 0]) == int(new_id)
    assert port.ensure_bucket_major()[0] is not data0


def test_ladder_stale_tracks_drift(pair):
    _, port, docs, _ = pair
    assert not port.ladder_stale
    P.calibrate_index(port, n_queries=8, n_weight_draws=2, probe_grid=(3, 12))
    assert not port.ladder_stale and port.n_mutations == 0
    port.add_documents(docs[N_BASE:N_BASE + 40])
    assert not port.ladder_stale
    port.add_documents(docs[N_BASE + 40:N_BASE + 150])
    assert port.n_mutations > P.LADDER_DRIFT_THRESHOLD * port.n_live
    assert port.ladder_stale
    P.calibrate_index(port, n_queries=8, n_weight_draws=2, probe_grid=(3, 12))
    assert not port.ladder_stale and port.n_mutations == 0


def test_mutated_index_save_load_roundtrip(tmp_path, pair):
    """The port's mutated archive loads into both packages with its
    tombstones, drift counter and ladder, and answers as before."""
    _, port, docs, spec = pair
    P.calibrate_index(port, n_queries=8, n_weight_draws=2, probe_grid=(3, 12))
    port.add_documents(docs[N_BASE:N_BASE + 150])
    port.remove_documents([4, 9, 1003])
    assert port.ladder_stale
    port.save(tmp_path / "mutated.npz")
    loaded = P.ClusterPruneIndex.load(tmp_path / "mutated.npz", device="cpu")
    back = R.ClusterPruneIndex.load(tmp_path / "mutated.npz")
    for got in (loaded, back):
        np.testing.assert_array_equal(np.asarray(got.buckets),
                                      port.buckets.numpy())
        np.testing.assert_array_equal(got.removed, port.removed)
        assert got.n_mutations == port.n_mutations
        assert got.n_live == port.n_live and got.ladder_stale
    qw = _qw(docs, np.arange(20, 24), spec)
    _, i0, _ = port.search(torch.as_tensor(qw), probes=12, k=8)
    _, i1, _ = loaded.search(torch.as_tensor(qw), probes=12, k=8)
    _, i2, _ = back.search(jnp.asarray(qw), probes=12, k=8)
    assert torch.equal(i0, i1)
    np.testing.assert_array_equal(i0.numpy(), np.asarray(i2))
    for gone in (4, 9, 1003):
        assert gone not in i1.reshape(-1).tolist()


def test_calibrate_masks_removed_docs(pair):
    _, port, _, _ = pair
    port.remove_documents(np.arange(0, N_BASE, 3))
    ladder = P.calibrate_index(port, n_queries=8, n_weight_draws=2,
                               probe_grid=(3, 48))
    assert ladder.recall[-1] >= 0.999


# ------------------------------------------------ the facade and its caches
@pytest.fixture()
def fresh_retriever(saved, random_corpus):
    docs, spec = random_corpus
    return (P.Retriever(P.ClusterPruneIndex.load(saved, device="cpu"),
                        backend="reference"), _np(docs), spec)


def test_cache_invalidated_by_mutation(fresh_retriever):
    retriever, docs, _ = fresh_retriever
    req = P.SearchRequest(like=33, probes=12, k=5)
    before = retriever.search(req)
    assert retriever.search(req) is before
    [new_id] = retriever.add(docs[33][None, :])
    after = retriever.search(req)
    assert after is not before
    assert after.hits[0].doc_id == int(new_id)
    assert retriever.remove([new_id]) == 1
    final = retriever.search(req)
    assert int(new_id) not in final.ids
    np.testing.assert_array_equal(final.doc_ids, before.doc_ids)
    assert retriever.add_documents == retriever.add
    assert retriever.remove_documents == retriever.remove


def test_cache_invalidated_by_direct_index_mutation(fresh_retriever):
    retriever, docs, _ = fresh_retriever
    req = P.SearchRequest(like=8, probes=12, k=5)
    before = retriever.search(req)
    retriever.index.add_documents(docs[8][None, :])
    after = retriever.search(req)
    assert after is not before
    assert after.hits[0].doc_id == N_BASE


def test_cached_like_answer_does_not_outlive_removal(fresh_retriever):
    retriever, _, _ = fresh_retriever
    req = P.SearchRequest(like=12, probes=6, k=5)
    first = retriever.search(req)
    assert retriever.search(req) is first
    retriever.remove([12])
    with pytest.raises(ValueError, match="removed"):
        retriever.search(req)
    req2 = P.SearchRequest(like=13, probes=6, k=5)
    second = retriever.search(req2)
    assert retriever.search(req2) is second
    retriever.index.remove_documents([13])
    with pytest.raises(ValueError, match="removed"):
        retriever.search(req2)


# --------------------------------------------- quality after a 10% ingest
# CR and NAG after ingest, each cell held to the reference's own number on
# the same archive and the same added docs: CR within one hit over the
# cell's 32 queries (an id swap on an fp32 near tie), NAG within 1e-3.
CR_ATOL, NAG_ATOL = 1 / 32 + 1e-6, 1e-3


@pytest.mark.slow
def test_incremental_add_quality_matches_reference(tmp_path):
    """The recipe of tests/test_cluster.py::test_incremental_add_quality_
    floors: 1350 docs built by the reference, 150 ingested by each
    package, CR and NAG at probes 6/12/24 over three weight sets on both
    backends, against the reference's numbers (not its floors, which the
    reference itself misses)."""
    from repro.data import CorpusConfig, make_corpus

    docs_np, spec, _ = make_corpus(CorpusConfig(
        n_docs=1500, field_dims=(64, 64, 128),
        vocab_sizes=(800, 1200, 3000), n_topics=200, topic_mix_alpha=1.0,
        noise_terms=(4, 2, 24), seed=3,
    ))
    docs = jnp.asarray(docs_np)
    n_base = 1350
    ref = R.ClusterPruneIndex.build(docs[:n_base], spec, 40,
                                    n_clusterings=3, method="fpf",
                                    key=jax.random.PRNGKey(2))
    ref.save(tmp_path / "base.npz")
    port = P.ClusterPruneIndex.load(tmp_path / "base.npz", device="cpu")
    ref.add_documents(docs[n_base:])
    new_ids = port.add_documents(docs_np[n_base:])
    assert new_ids[0] == n_base and port.n_docs == 1500
    np.testing.assert_array_equal(port.buckets.numpy(), np.asarray(ref.buckets))

    rng = np.random.default_rng(11)
    qids = rng.choice(1500, 32, replace=False).astype(np.int32)
    added_seen = 0
    for w in ((1 / 3, 1 / 3, 1 / 3), (0.6, 0.2, 0.2), (0.15, 0.15, 0.7)):
        qw = R.weighted_query(docs[qids], jnp.tile(
            jnp.asarray(w, jnp.float32)[None], (32, 1)), spec)
        gt_s, gt_i = R.brute_force_topk(docs, qw, 10, exclude=qids)
        far_s, _ = R.brute_force_bottomk(docs, qw, 10, exclude=qids)
        qw_t = torch.as_tensor(_np(qw))
        for backend in BACKENDS:
            for probes in (6, 12, 24):
                s_r, i_r, _ = R.get_engine(ref, backend).search(
                    qw, probes=probes, k=10, exclude=jnp.asarray(qids))
                s_p, i_p, _ = P.get_engine(port, backend).search(
                    qw_t, probes=probes, k=10,
                    exclude=torch.as_tensor(qids))
                cr_r = float(jnp.mean(R.competitive_recall(i_r, gt_i)))
                nag_r = float(jnp.mean(R.normalized_aggregate_goodness(
                    s_r, gt_s, far_s)))
                cr_p = float(P.competitive_recall(
                    i_p, torch.as_tensor(_np(gt_i))).mean())
                nag_p = float(P.normalized_aggregate_goodness(
                    s_p, torch.as_tensor(_np(gt_s)),
                    torch.as_tensor(_np(far_s))).mean())
                assert abs(cr_p - cr_r) <= CR_ATOL, (w, backend, probes,
                                                     cr_p, cr_r)
                assert abs(nag_p - nag_r) <= NAG_ATOL, (w, backend, probes,
                                                        nag_p, nag_r)
                added_seen += int((i_p.numpy() >= n_base).sum())
    assert added_seen > 0


def test_serve_mutate_round_trip(capsys):
    """serve --mutate N: the copies come back as hit #1, then never."""
    from repro_torch.launch import serve

    serve.main(["--docs", "600", "--queries", "8", "--device", "cpu",
                "--mutate", "4"])
    out = capsys.readouterr().out
    assert "4/4 copies came back as hit #1" in out
    assert "0 leaked back into any top-k (OK)" in out
