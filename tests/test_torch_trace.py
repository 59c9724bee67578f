"""The port's spans and counters (``repro_torch.runtime.trace``): off, a
span is one shared null context that never calls into the profiler and no
counter moves; on, spans land in the profiler's trace, nest, and keep their
host self time; the tile-fill and gathered / distinct counters equal a
recount from the numpy schedule and ``np.unique``."""

import numpy as np
import pytest
import torch

from repro_torch.configs import paper_retrieval as TP
from repro_torch.configs.mind import make_smoke_config
from repro_torch.core.api import Retriever, SearchRequest
from repro_torch.core import engine
from repro_torch.core.fields import FieldSpec
from repro_torch.core.index import ClusterPruneIndex
from repro_torch.kernels import common
from repro_torch.kernels.bucket_score import ops as bs
from repro_torch.models.recsys import MIND
from repro_torch.runtime import trace

SPEC = FieldSpec(names=("a", "b"), dims=(8, 8))


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _docs(n, seed=0):
    return _unit(torch.randn(n, 16, generator=torch.Generator().manual_seed(
        seed)))


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


def _search_build_and_serve():
    docs = _docs(300)
    idx = ClusterPruneIndex.build(docs, SPEC, 8, n_clusterings=2,
                                  method="fpf_fused", device="cpu",
                                  pack_major=True)
    w = torch.rand(6, 2) + 0.1
    idx.search_weighted(docs[:6], w, probes=4, k=5, exclude=torch.arange(6),
                        backend="fused")
    leaders = idx.leaders
    bkt = idx.buckets
    qw = _unit(torch.randn(5, 16))
    s, i = TP.serve_online_rank(docs, leaders, bkt, qw, probes_t=(2, 2),
                                k=5, offset=0)
    TP.gather_merge(s, i, 5)
    s, i = TP.serve_brute_rank(docs, qw, k=5, offset=0, n_valid=300)
    TP.gather_merge(s, i, 5)
    model = MIND(make_smoke_config(), generator=torch.Generator().manual_seed(
        0), device="cpu")
    with torch.no_grad():
        interests = model(torch.zeros((2, model.cfg.hist_len),
                                      dtype=torch.int32))
    Retriever(idx, backend="fused").search([
        SearchRequest(query=interests[0, :2].reshape(-1)[:16], k=5,
                      probes=4),
        SearchRequest(like=7, weights={"a": 0.3, "b": 0.7}, k=5, probes=4)])


def test_span_off_is_one_null_context_and_never_enters_the_profiler(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    assert not trace.profiling()
    assert trace.span("engine.navigate") is trace.span("build.pack")
    with trace.span("entry.merge") as got:
        assert got is None
    _search_build_and_serve()
    trace.count("online.gathered", 5)
    trace.count_device("tile_fill.marked", torch.tensor(3))
    assert trace.counters() == {}
    assert trace.span_self_ns() == {}


def test_spans_land_in_the_trace_nest_and_keep_self_time():
    names = [f"entry.s{i}" for i in range(6)]
    with _profiled() as prof:
        assert trace.profiling()

        def nest(depth):
            with trace.span(names[depth]):
                if depth + 1 < len(names):
                    nest(depth + 1)
                    nest(depth + 1)
                else:
                    torch.ones(64).sum()

        nest(0)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(events) == {trace.PREFIX + n for n in names}
    for outer, inner in zip(names, names[1:]):
        for lo, hi in events[trace.PREFIX + inner]:
            assert any(plo <= lo and hi <= phi
                       for plo, phi in events[trace.PREFIX + outer])
    got = trace.span_self_ns()
    assert [got[trace.PREFIX + n][0] for n in names] == [2 ** i for i in
                                                         range(6)]
    assert all(ns >= 0 for _, ns in got.values())
    # the self times add up to no more than the outermost span's duration
    (top,) = events[trace.PREFIX + names[0]]
    total = sum(ns for _, ns in got.values())
    assert total <= top[1] - top[0] + 1_000_000


def test_traced_paths_record_only_the_four_layers():
    with _profiled():
        _search_build_and_serve()
    spans = trace.span_self_ns()
    layers = {name[len(trace.PREFIX):].split(".")[0] for name in spans}
    assert layers == set(trace.LAYERS)
    for want in ("entry.weighted_query", "entry.online_gather",
                 "entry.online_dedup", "entry.brute", "entry.merge",
                 "engine.prepare", "engine.navigate", "engine.schedule",
                 "engine.finish", "kernels.bucket_score_tiled",
                 "kernels.topk_score", "kernels.fpf_iter", "build.fpf",
                 "build.assign", "build.buckets", "build.pack",
                 "api.resolve", "api.plan", "api.respond", "model.mind"):
        assert trace.PREFIX + want in spans, want


def test_counters_count_only_while_profiling_and_reset_clears_them():
    trace.count("x", 2)
    with _profiled():
        trace.count("x", 2)
        trace.count_device("y", torch.tensor(3))
        trace.count_device("y", torch.tensor(4, dtype=torch.int32))
        trace.count("y", 1)
    trace.count("x", 5)
    assert trace.counters() == {"x": 2, "y": 8}
    trace.reset()
    assert trace.counters() == {}


def test_api_counters_equal_the_responses_scored_and_live_rows():
    docs = _docs(300, seed=2)
    idx = ClusterPruneIndex.build(docs, SPEC, 8, n_clusterings=2,
                                  method="fpf_fused", device="cpu",
                                  pack_major=True)
    ret = Retriever(idx, backend="fused")
    ret.remove([5, 9])
    reqs = [SearchRequest(query=docs[q], weights=[0.4, 0.6], k=4, probes=p)
            for q, p in ((0, 3), (1, 3), (2, 16))]
    ret.search(reqs)                             # not profiled: not counted
    with _profiled():
        got = ret.search(reqs)
    c = trace.counters()
    assert c["api.scored"] == sum(r.n_scored for r in got)
    assert c["api.candidates"] == len(reqs) * 298


def test_count_launch_lives_beside_the_spans():
    assert common.count_launch is trace.count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    common.count_launch(wrapper)
    common.count_launch(wrapper, n=2)
    assert wrapper.launches == 3


@pytest.mark.parametrize("nq,qt,p,n_buckets", [(64, 16, 9, 40),
                                               (37, 16, 3, 12),
                                               (24, 24, 5, 30)])
def test_tile_fill_counters_equal_the_numpy_schedule(nq, qt, p, n_buckets):
    g = np.random.default_rng(nq * 100 + qt)
    probes = np.stack([g.choice(n_buckets, p, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    b, d = 8, 16
    data = torch.randn(n_buckets, b, d)
    ids = torch.arange(n_buckets * b, dtype=torch.int32).reshape(n_buckets,
                                                                 b)
    flat = torch.as_tensor(probes)
    s_len = bs.schedule_length(qt, p, n_buckets)
    sched, member = bs.build_probe_schedule_device(flat, query_tile=qt,
                                                   s_len=s_len)
    with _profiled():
        bs.bucket_score_tiled(torch.randn(nq, d), data, ids, sched, member,
                              k=5)
    got = trace.counters()
    _, ref_member = bs.build_probe_schedule(probes, qt)
    n_sub = -(-qt // bs.KERNEL_TILE)
    st = -(-qt // n_sub)
    wide = np.pad(ref_member, ((0, 0), (0, 0), (0, n_sub * st - qt)))
    live = wide.reshape(*wide.shape[:2], n_sub, st).any(-1).sum()
    assert got["tile_fill.marked"] == int(ref_member.sum()) == nq * p
    assert got["tile_fill.computed"] == int(live) * st
    assert bs.schedule_block_reads(member) == int(
        ref_member.any(-1).sum())


def test_gathered_and_distinct_counters_equal_a_recount():
    n, t_cl, kc, b_l = 200, 3, 10, 12
    docs = _docs(n, seed=1)
    g = np.random.default_rng(5)
    leaders = _unit(torch.randn(t_cl, kc, 16))
    bkt = np.full((t_cl, kc, b_l), n, np.int32)
    for t in range(t_cl):
        assign = g.integers(0, kc, n)
        for c in range(kc):
            rows = np.flatnonzero(assign == c)[:b_l]
            bkt[t, c, :rows.size] = rows
    bkt = torch.as_tensor(bkt)
    qw = _unit(torch.randn(7, 16))
    probes_t = (2, 2, 1)
    with _profiled():
        TP.serve_online_rank(docs, leaders, bkt, qw, probes_t=probes_t, k=5,
                             offset=0)
    got = trace.counters()
    flat = engine.navigate(leaders, qw, probes_t).numpy()
    cand = bkt.reshape(t_cl * kc, b_l).numpy()[flat].reshape(7, -1)
    assert got["online.gathered"] == cand.size
    assert got["online.distinct"] == sum(np.unique(row[row < n]).size
                                         for row in cand)


def test_counters_and_span_times_lose_nothing_under_threads():
    """Replicas record from several threads: 8 threads, a tiny switch
    interval, no lost count or span entry, and each thread's spans nest on
    its own stack."""
    import sys
    import threading

    n_threads, n_iter = 8, 300
    old = sys.getswitchinterval()
    errors = []

    def work():
        try:
            for _ in range(n_iter):
                with trace.span("entry.outer"):
                    with trace.span("engine.inner"):
                        trace.count("hits", 1)
                    trace.count_device("dev_hits", torch.tensor(2))
        except Exception as e:          # reported by the main thread
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    total = n_threads * n_iter
    assert trace.counters() == {"hits": total, "dev_hits": 2 * total}
    spans = trace.span_self_ns()
    assert spans[trace.PREFIX + "entry.outer"][0] == total
    assert spans[trace.PREFIX + "engine.inner"][0] == total


def test_device_counts_fold_and_scale_exactly():
    n = 3 * trace._FOLD + 5
    with _profiled():
        for i in range(n):
            trace.count_device("folded", torch.tensor(i % 7))
            trace.count_device("scaled", torch.tensor(1), scale=16)
        trace.count_device("scaled", torch.tensor(2), scale=3)
    assert trace.counters() == {"folded": sum(i % 7 for i in range(n)),
                                "scaled": 16 * n + 6}
