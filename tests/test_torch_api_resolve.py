"""``Retriever`` resolves a batch's requests together: the raw query
vectors as one ``(n, D)`` tensor with one read of their validity, the
``like=`` rows in one gather, the weights as one ``(n, s)`` array with one
check. On the CPU the batch's weighted queries match the JAX package's
requests resolved one at a time and equal the port's own bit for bit, its
answers match the JAX package's ``Retriever`` and equal one-by-one
searches, and a bad batch raises the ``ValueError`` the JAX package's
``Retriever`` raises on the same batch, leaving nothing cached and running
no engine. The JAX package builds and saves the index; the port loads it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro_torch.core import engine
from repro_torch.core.api import Retriever, SearchRequest, _resolve_queries
from repro_torch.core.fields import FieldSpec
from repro_torch.core.index import ClusterPruneIndex
from repro_torch.core.weights import weighted_query
from repro_torch.runtime import trace

SPEC = FieldSpec(names=("i0", "i1", "i2", "i3"), dims=(8, 8, 8, 8))
N_DOCS = 300

# words of each fault's message, so that a batch refused for another
# reason than the one put into it does not pass
KIND = {"nan": "non-finite", "inf": "non-finite", "dim": "query has dim 31",
        "unknown": "unknown field name(s) ['title']",
        "negative": "must be non-negative", "range": "out of range",
        "removed": "refers to a removed document"}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    rng = np.random.default_rng(0)
    spec = R.FieldSpec(names=SPEC.names, dims=SPEC.dims)
    docs = R.normalize_fields(
        jnp.asarray(rng.standard_normal((N_DOCS, SPEC.total_dim),
                                        np.float32)), spec)
    ref = R.ClusterPruneIndex.build(docs, spec, 6, n_clusterings=2,
                                    method="fpf", key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("resolve") / "index.npz"
    ref.save(path)
    return path


@pytest.fixture(scope="module")
def index(saved):
    return ClusterPruneIndex.load(saved, device="cpu")


@pytest.fixture(scope="module")
def ref(saved):
    return R.ClusterPruneIndex.load(saved)


@pytest.fixture(autouse=True)
def _clean_trace():
    trace.reset()
    yield
    trace.reset()


def _query(form, v, i):
    """One raw query in the caller's ``form``: per-field tensors, per-field
    numpy arrays (float64) or one flat vector."""
    if form == "tensors":
        return list(v.reshape(SPEC.s, -1))
    if form == "arrays":
        return [b.numpy().astype(np.float64) for b in v.reshape(SPEC.s, -1)]
    return v if i % 2 else v.numpy()


def _weights(kind, w, i):
    if kind == "mapping":      # every fifth user leaves a field out
        names = SPEC.names[:-1] if i % 5 == 4 else SPEC.names
        return {n: float(x) for n, x in zip(names, w)}
    if kind == "sequence":
        return [float(x) for x in w] if i % 2 else w
    return None


def _requests(n, form="tensors", weights="mapping", mixed=False, seed=1,
              **kw):
    """``n`` requests of raw queries (a zero field block in row 3), every
    third a ``like=`` request when ``mixed``."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(n, SPEC.total_dim, generator=g)
    v[3 % n, :8] = 0.0
    w = np.random.default_rng(seed).dirichlet(np.ones(SPEC.s), n)
    out = []
    for i in range(n):
        wi = _weights(weights, w[i], i)
        if mixed and i % 3 == 0:
            out.append(SearchRequest(like=(7 * i) % N_DOCS, weights=wi, **kw))
        else:
            out.append(SearchRequest(query=_query(form, v[i], i), weights=wi,
                                     **kw))
    return out


def _numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _mirror(reqs):
    """The JAX package's requests for the same queries and weights (its
    queries take numpy arrays where the port's take tensors)."""
    out = []
    for r in reqs:
        q = r.query
        if isinstance(q, (list, tuple)):
            q = [_numpy(b) for b in q]
        elif q is not None:
            q = _numpy(q)
        out.append(R.SearchRequest(query=q, like=r.like, weights=r.weights,
                                   k=r.k, probes=r.probes))
    return out


@pytest.mark.parametrize("mixed", [False, True], ids=["raw", "mixed"])
@pytest.mark.parametrize("weights", ["mapping", "sequence", "none"])
@pytest.mark.parametrize("form", ["tensors", "arrays", "flat"])
@pytest.mark.parametrize("n", [1, 7, 512])
def test_batch_queries_match_the_jax_package(index, ref, n, form, weights,
                                             mixed):
    """The batch's weighted queries against the JAX package's
    ``resolve_query`` rows stacked and weighted with its
    ``resolve_weights``."""
    reqs = _requests(n, form, weights, mixed)
    jreqs = _mirror(reqs)
    q = jnp.stack([r.resolve_query(ref) for r in jreqs])
    w = np.stack([r.resolve_weights(ref.spec) for r in jreqs])
    want = np.asarray(R.weighted_query(q, jnp.asarray(w), ref.spec))
    got = Retriever(index, backend="fused")._resolve_qw(reqs)
    assert got.dtype == torch.float32 and got.shape == (n, SPEC.total_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mixed", [False, True], ids=["raw", "mixed"])
@pytest.mark.parametrize("weights", ["mapping", "sequence", "none"])
@pytest.mark.parametrize("form", ["tensors", "arrays", "flat"])
@pytest.mark.parametrize("n", [1, 7, 512])
def test_batch_queries_equal_one_at_a_time_bit_for_bit(index, n, form,
                                                       weights, mixed):
    reqs = _requests(n, form, weights, mixed)
    q_one = torch.stack([r.resolve_query(index) for r in reqs])
    w_one = np.stack([r.resolve_weights(SPEC) for r in reqs])
    want = weighted_query(q_one, torch.as_tensor(w_one), SPEC)
    assert torch.equal(_resolve_queries(index, reqs), q_one)
    got = Retriever(index, backend="fused")._resolve_qw(reqs)
    assert got.dtype == torch.float32 and got.shape == (n, SPEC.total_dim)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mixed", [False, True], ids=["raw", "mixed"])
def test_batch_answers_equal_one_by_one_searches(index, mixed):
    reqs = _requests(24, "tensors", "mapping", mixed, seed=5, k=5, probes=4)
    batch = Retriever(index, backend="fused").search(reqs)
    solo = Retriever(index, backend="fused")
    for r, got in zip(reqs, batch):
        want = solo.search(r)
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0,
                                   atol=1e-6)
        assert got.n_scored == want.n_scored
        for h, hw in zip(got.hits, want.hits):
            assert h.doc_id == hw.doc_id
            assert list(h.field_scores) == list(hw.field_scores)
            for name in h.field_scores:
                assert h.field_scores[name] == pytest.approx(
                    hw.field_scores[name], rel=0, abs=1e-6)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("weights", ["mapping", "sequence", "none"])
@pytest.mark.parametrize("mixed", [False, True], ids=["raw", "mixed"])
def test_batch_answers_match_the_jax_retriever(index, ref, mixed, weights,
                                               backend):
    """Ids, scores, n_scored, probes and field scores equal the JAX
    package's ``Retriever`` on the same batch."""
    reqs = _requests(24, "tensors", weights, mixed, seed=5, k=5, probes=4)
    got = Retriever(index, backend=backend).search(reqs)
    want = R.Retriever(ref, backend="reference").search(_mirror(reqs))
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=1e-5)
        assert (a.n_scored, a.probes, a.tier, a.batch_size) == (
            b.n_scored, b.probes, b.tier, b.batch_size)
        for h, hb in zip(a.hits, b.hits):
            assert list(h.field_scores) == list(hb.field_scores)
            for name in h.field_scores:
                assert h.field_scores[name] == pytest.approx(
                    hb.field_scores[name], rel=0, abs=1e-5)


def _fault(reqs, row, fault):
    """Put ``fault`` into request ``row`` of the batch."""
    r = reqs[row]
    if fault in ("nan", "inf", "dim"):
        v = torch.ones(SPEC.total_dim)
        if fault == "dim":
            v = v[:-1]
        else:
            v[9] = float(fault)
        reqs[row] = SearchRequest(query=list(v.split(8)), weights=r.weights)
    elif fault == "unknown":
        reqs[row] = SearchRequest(query=r.query, like=r.like,
                                  weights={"i0": 1.0, "title": 2.0})
    elif fault == "negative":
        reqs[row] = SearchRequest(query=r.query, like=r.like,
                                  weights=[0.5, -0.25, 0.5, 0.25])
    elif fault == "range":
        reqs[row] = SearchRequest(like=N_DOCS + 6, weights=r.weights)
    elif fault == "removed":
        reqs[row] = SearchRequest(like=3, weights=r.weights)


def _jax_refusal(ret, reqs, kind):
    """The ``ValueError`` text the JAX package's ``Retriever`` raises on
    the same batch, checked to be the ``kind`` of fault expected."""
    with pytest.raises(ValueError) as err:
        ret.search(_mirror(reqs))
    assert KIND[kind] in str(err.value)
    return str(err.value)


def _assert_refused(ret, reqs, message, monkeypatch):
    def no_engine(*a, **kw):
        raise AssertionError("an engine ran for a refused batch")

    monkeypatch.setattr(engine, "get_engine", no_engine)
    with pytest.raises(ValueError) as err:
        ret.search(reqs)
    assert str(err.value) == message
    assert not ret._qw_cache and not ret._response_cache


@pytest.mark.parametrize("row", [0, 6, 511])
@pytest.mark.parametrize("fault", ["nan", "inf", "dim", "unknown",
                                   "negative"])
@pytest.mark.parametrize("mixed", [False, True], ids=["raw", "mixed"])
def test_a_bad_request_raises_its_own_error(index, ref, monkeypatch, mixed,
                                            fault, row):
    reqs = _requests(512, mixed=mixed)
    _fault(reqs, row, fault)
    message = _jax_refusal(R.Retriever(ref, backend="reference"), reqs,
                           fault)
    with pytest.raises(ValueError) as alone:
        reqs[row].resolve_query(index)
        reqs[row].resolve_weights(SPEC)
    assert str(alone.value) == message
    _assert_refused(Retriever(index, backend="fused"), reqs, message,
                    monkeypatch)


# (faults by row, the error raised): queries in request order, then the
# weights in request order; an all-like batch checks its ids together
ORDER = {
    "nan-before-dim": ({0: "nan", 6: "dim"}, "nan"),
    "dim-before-nan": ({0: "dim", 6: "nan"}, "dim"),
    "nan-before-dim-at-the-end": ({6: "inf", 511: "dim"}, "inf"),
    "negative-before-unknown": ({0: "negative", 6: "unknown"}, "negative"),
    "unknown-before-negative": ({6: "unknown", 511: "negative"}, "unknown"),
    "query-before-weights": ({0: "unknown", 511: "nan"}, "nan"),
    "like-before-query": ({6: "range", 511: "nan"}, "range"),
    "query-before-like": ({6: "dim", 9: "range"}, "dim"),
}


@pytest.mark.parametrize("case", list(ORDER))
def test_a_bad_batch_raises_in_one_at_a_time_order(index, ref, monkeypatch,
                                                   case):
    faults, first = ORDER[case]
    reqs = _requests(512, mixed=True)
    for row, fault in faults.items():
        _fault(reqs, row, fault)
    message = _jax_refusal(R.Retriever(ref, backend="reference"), reqs,
                           first)
    _assert_refused(Retriever(index, backend="fused"), reqs, message,
                    monkeypatch)


def test_an_all_like_batch_checks_its_ids_together(saved, monkeypatch):
    ret = Retriever(ClusterPruneIndex.load(saved, device="cpu"),
                    backend="fused")
    jret = R.Retriever(R.ClusterPruneIndex.load(saved), backend="reference")
    ret.remove([3])
    jret.remove([3])
    reqs = [SearchRequest(like=i + 10) for i in range(12)]
    _fault(reqs, 0, "removed")
    _fault(reqs, 6, "range")
    _assert_refused(ret, reqs, _jax_refusal(jret, reqs, "range"),
                    monkeypatch)
    _assert_refused(ret, reqs[:6], _jax_refusal(jret, reqs[:6], "removed"),
                    monkeypatch)


def test_counters_name_the_raw_queries_and_one_read_a_batch(index):
    reqs = _requests(30, mixed=True, k=5, probes=4)
    ret = Retriever(index, backend="fused")
    ret.search(reqs)                             # not profiled: not counted
    assert trace.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ret.search(reqs)          # the like= rows now come from the cache
        ret.search([r for r in reqs if r.like is not None])
        reqs[1].resolve_query(index)
    c = trace.counters()
    assert c["api.raw_queries"] == 20 + 1
    assert c["api.resolve_syncs"] == 2
