"""PyTorch port, the calibrated planner: ``isotonic_fit``,
``default_probe_grid``, ``ProbeLadder`` and ``calibrate_index`` against the
JAX reference (same numpy inputs, same saved index), the ladder's passage
through the ``.npz`` both ways, and ``recall_target=`` planning and
``min_recall=`` escalation through both packages' ``Retriever``."""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import calibrate as RC  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core import calibrate as PC  # noqa: E402

K_CLUSTERS, K = 24, 10
CAL = dict(n_queries=16, n_weight_draws=2, k=K, seed=3)


@pytest.fixture(scope="module")
def saved(small_corpus, tmp_path_factory):
    docs, spec, _ = small_corpus
    index = R.ClusterPruneIndex.build(
        docs, spec, K_CLUSTERS, n_clusterings=3, method="fpf",
        key=jax.random.PRNGKey(0),
    )
    path = tmp_path_factory.mktemp("calib") / "index.npz"
    index.save(path)
    return index, path


@pytest.fixture(scope="module")
def ref_ladder(saved):
    """The reference's fit on its own index (reference backend)."""
    index, _ = saved
    return RC.calibrate_index(index, backend="reference", store=False, **CAL)


@pytest.mark.parametrize("y,w", [
    ([0.1, 0.3, 0.2, 0.5, 0.4, 0.4, 0.9], None),
    ([1.0, 0.0, 0.5, 0.25], [1.0, 2.0, 0.5, 3.0]),
    ([0.2], None),
    (list(np.random.default_rng(0).random(40)), None),
])
def test_isotonic_fit_matches_reference(y, w):
    np.testing.assert_array_equal(PC.isotonic_fit(y, w), RC.isotonic_fit(y, w))
    with pytest.raises(ValueError):
        PC.isotonic_fit([0.1, 0.2], [1.0])


@pytest.mark.parametrize("t,kc", [(3, 24), (3, 316), (1, 5), (4, 1000)])
def test_default_probe_grid_matches_reference(t, kc):
    assert PC.default_probe_grid(t, kc) == RC.default_probe_grid(t, kc)


def test_probe_ladder_matches_reference_byte_for_byte():
    """The same ladder serialises to byte-equal JSON in both packages, reads
    back across them, and plans and predicts the same; invalid ladders are
    refused by both."""
    kw = dict(probes=(3, 5, 10, 16, 26), recall=(0.41, 0.6, 0.8, 0.9, 0.97),
              n_clusterings=3, k_clusters=K_CLUSTERS,
              meta={"k": 10, "seed": 0, "measured_recall": [0.4, 0.61]})
    r, p = RC.ProbeLadder(**kw), PC.ProbeLadder(**kw)
    assert json.dumps(p.to_dict()) == json.dumps(r.to_dict())
    assert PC.ProbeLadder.from_dict(json.loads(json.dumps(r.to_dict()))) == p
    for target in (0.05, 0.41, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert p.plan(target) == r.plan(target)
    for probes in range(0, 80, 3):
        assert p.predicted_recall(probes) == r.predicted_recall(probes)
    for bad in (dict(kw, probes=(5, 3, 10, 16, 26)),
                dict(kw, recall=(0.9, 0.6, 0.8, 0.9, 0.97)),
                dict(kw, probes=(3,))):
        with pytest.raises(ValueError):
            RC.ProbeLadder(**bad)
        with pytest.raises(ValueError):
            PC.ProbeLadder(**bad)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_calibrate_index_matches_reference(saved, ref_ladder, backend):
    """On the reference's saved index, the same seed samples the same
    queries and weights: the same grid, and measured recall within one
    query's miss, 1/(k·nq·draws), of the reference's (both backends of the
    port; the fused one through the plain kernel version)."""
    _, path = saved
    index = P.ClusterPruneIndex.load(path, device="cpu")
    index.n_mutations = 7
    ladder = P.calibrate_index(index, backend=backend, **CAL)
    assert index.ladder is ladder and index.n_mutations == 0
    assert ladder.probes == ref_ladder.probes
    step = 1.0 / (K * CAL["n_queries"] * CAL["n_weight_draws"])
    np.testing.assert_allclose(ladder.meta["measured_recall"],
                               ref_ladder.meta["measured_recall"],
                               atol=step + 1e-6)
    np.testing.assert_allclose(ladder.recall, ref_ladder.recall,
                               atol=step + 1e-6)
    meta = {k: v for k, v in ladder.meta.items() if k != "measured_recall"}
    want = {k: v for k, v in ref_ladder.meta.items()
            if k != "measured_recall"}
    assert meta == dict(want, backend=backend)
    assert (ladder.n_clusterings, ladder.k_clusters) == (3, K_CLUSTERS)


def test_ladder_crosses_the_npz_both_ways(saved, ref_ladder, tmp_path):
    index, _ = saved
    dataclasses.replace(index, ladder=ref_ladder).save(tmp_path / "ref.npz")
    port = P.ClusterPruneIndex.load(tmp_path / "ref.npz", device="cpu")
    assert port.ladder.to_dict() == ref_ladder.to_dict()
    port.save(tmp_path / "port.npz")
    back = R.ClusterPruneIndex.load(tmp_path / "port.npz")
    assert back.ladder.to_dict() == ref_ladder.to_dict()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") \
            as b:
        assert str(a["ladder"]) == str(b["ladder"])


def _requests(mod, qids, w, spec, **kw):
    return [mod.SearchRequest(like=int(q), weights=dict(
        zip(spec.names, map(float, wi))), k=K, **kw)
        for q, wi in zip(qids, w)]


def test_planning_and_escalation_match_reference(saved, ref_ladder,
                                                 tmp_path):
    """One laddered index in both packages: recall_target= plans, min_recall=
    escalations (from a budget below the floor), tiers, n_scored, ids and
    predicted recall all equal the reference's."""
    index, _ = saved
    laddered = dataclasses.replace(index, ladder=ref_ladder)
    laddered.save(tmp_path / "laddered.npz")
    port = P.ClusterPruneIndex.load(tmp_path / "laddered.npz", device="cpu")
    r_ret = R.Retriever(laddered, backend="reference")
    rng = np.random.default_rng(5)
    qids = rng.choice(index.n_docs, 8, replace=False)
    w = rng.dirichlet([1.0] * 3, size=8).astype(np.float32)
    mixes = [dict(recall_target=t) for t in (0.5, 0.8, 0.9, 0.99)]
    mixes += [dict(probes=3, min_recall=0.9), dict(probes=3, min_recall=0.6),
              dict(recall_target=0.5, min_recall=0.95)]
    for backend in ("reference", "fused"):
        p_ret = P.Retriever(port, backend=backend)
        for mix in mixes:
            a = p_ret.search(_requests(P, qids, w, port.spec, **mix))
            b = r_ret.search(_requests(R, qids, w, index.spec, **mix))
            for x, y in zip(a, b):
                assert (x.probes, x.tier, x.escalations, x.n_scored) == (
                    y.probes, y.tier, y.escalations, y.n_scored), mix
                assert x.predicted_recall == pytest.approx(
                    y.predicted_recall, abs=1e-12)
                assert x.ids == y.ids
    tiers = {r.tier for r in p_ret.search(_requests(
        P, qids, w, port.spec, probes=3, min_recall=0.9))}
    assert tiers & {"escalated", "exact"}


def test_retriever_calibrates_lazily_and_refits_stale(saved):
    """calibrate=True fits on the first recall_target= (or min_recall=)
    request and refits a stale ladder; calibrate=False plans a stale ladder
    with one warning; calibrate_opts without opting in is an error."""
    _, path = saved
    index = P.ClusterPruneIndex.load(path, device="cpu")
    opts = dict(n_queries=8, n_weight_draws=2, seed=1)
    ret = P.Retriever(index, calibrate=True, calibrate_opts=opts)
    assert index.ladder is None
    resp = ret.search(P.SearchRequest(like=3, recall_target=0.9))
    first = index.ladder
    assert first is not None and first.meta["n_queries"] == 8
    assert resp.probes == first.plan(0.9)
    assert resp.predicted_recall == first.predicted_recall(resp.probes)
    index.n_mutations = index.n_docs                 # far past the drift
    assert index.ladder_stale
    ret.search(P.SearchRequest(like=4, min_recall=0.8, probes=3))
    assert index.ladder is not first and not index.ladder_stale
    index.n_mutations = index.n_docs
    quiet = P.Retriever(index)
    with pytest.warns(UserWarning, match="stale"):
        quiet.search(P.SearchRequest(like=5, recall_target=0.9))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.search(P.SearchRequest(like=6, recall_target=0.9))
    with pytest.raises(ValueError, match="calibrate_opts"):
        P.Retriever.build(np.zeros((4, 256), np.float32), index.spec, 2,
                          calibrate_opts=opts, device="cpu")


def test_build_with_calibrate_fits_a_ladder(small_corpus):
    docs, spec_j, _ = small_corpus
    spec = P.FieldSpec(spec_j.names, spec_j.dims)
    ret = P.Retriever.build(np.array(docs)[:600], spec, 12, device="cpu",
                            calibrate={"n_queries": 8, "n_weight_draws": 2},
                            calibrate_opts={"seed": 4})
    ladder = ret.index.ladder
    assert ladder is not None and ladder.meta["seed"] == 4
    assert ladder.probes == PC.default_probe_grid(3, 12)
    assert ret.calibrate and ret.calibrate_opts == {
        "n_queries": 8, "n_weight_draws": 2, "seed": 4}


def test_serve_planner_flags_on_cpu(capsys):
    """serve --min-recall / --recall-target on the CPU: the index is
    calibrated after the build, the floor holds on held-out queries, and
    --exact refuses to combine with either flag."""
    from repro_torch.launch import serve

    serve.main(["--docs", "400", "--queries", "8", "--device", "cpu",
                "--min-recall", "0.8", "--recall-target", "0.8"])
    out = capsys.readouterr().out
    assert "planner calibrated" in out and "planner predicted" in out
    assert "recall floor 0.80" in out and "(OK)" in out and "tiers {" in out
    with pytest.raises(SystemExit):
        serve.main(["--docs", "400", "--device", "cpu", "--exact",
                    "--min-recall", "0.9"])


# A rung's measured recall: the port's exact mean against the reference's
# jnp.mean of float32 fractions on the same ids. 300 random batches gave at
# most 1 ulp of 1.0 apart, before and after isotonic_fit; 2 are allowed.
RUNG_ULPS = 2
ULP_ONE = float(np.spacing(np.float32(1.0)))


def _hit_batch(rng, nq, k):
    """Ground truth 0..k-1 per row; each row returns its first h of them
    (h uniform in [0, k]) and -1 fillers."""
    gt = np.tile(np.arange(k, dtype=np.int32), (nq, 1))
    hits = rng.integers(0, k + 1, size=nq)
    ids = np.where(np.arange(k)[None, :] < hits[:, None], gt, -1)
    return ids.astype(np.int32), gt


@pytest.mark.parametrize("seed", range(4))
def test_measured_rungs_are_exact_means_within_ulps_of_reference(seed):
    """The port's rung is hits / (k·nq) rounded once to float32: within
    RUNG_ULPS ulps of 1.0 of the reference's jnp.mean on the same ids,
    before and after isotonic_fit, and bit-equal whatever the order of
    the queries."""
    import jax.numpy as jnp

    from repro.core.metrics import recall_fraction as r_recall_fraction

    rng = np.random.default_rng(seed)
    k = 10
    ref_rungs, port_rungs = [], []
    for nq in rng.integers(8, 400, size=6):
        ids, gt = _hit_batch(rng, int(nq), k)
        want = float(jnp.mean(r_recall_fraction(jnp.asarray(ids),
                                                jnp.asarray(gt))))
        got = PC.exact_mean_recall(torch.as_tensor(ids), torch.as_tensor(gt))
        hits = int(np.sum(ids >= 0))
        assert got == float(np.float32(hits / (k * int(nq))))
        assert abs(got - want) <= RUNG_ULPS * ULP_ONE
        perm = rng.permutation(int(nq))
        assert PC.exact_mean_recall(torch.as_tensor(ids[perm]),
                                    torch.as_tensor(gt[perm])) == got
        ref_rungs.append(want)
        port_rungs.append(got)
    np.testing.assert_allclose(PC.isotonic_fit(port_rungs),
                               RC.isotonic_fit(ref_rungs),
                               atol=RUNG_ULPS * ULP_ONE, rtol=0)


def test_calibrate_measures_exact_means(saved):
    """calibrate_index stores the exact mean of each sweep level: a float32
    value that is a whole number of hits over k·nq."""
    _, path = saved
    index = P.ClusterPruneIndex.load(path, device="cpu")
    ladder = P.calibrate_index(index, backend="reference", store=False,
                               **CAL)
    for r in ladder.meta["measured_recall"]:
        assert r == float(np.float32(r))
        hits = r * K * CAL["n_queries"] * CAL["n_weight_draws"]
        assert abs(hits - round(hits)) < 1e-3
