"""PyTorch port, the async serving tier (``repro_torch.serving``) against
the reference's (``repro.serving``): the frozen-clock policy units replayed
on both packages (the same inputs, the same answers), live servers on the
port's ``reference`` and ``fused`` backends (the fused kernel's plain
version on the CPU) whose micro-batched answers equal one-by-one
synchronous search, one burst through both packages' servers, the
once-only pack / engine and the atomic launch counters under threads, and
the serving entry points (``serve --serve/--chaos``, the load test) at tiny
sizes. The index is built by the JAX package and loaded by the port from
its ``.npz``."""

import asyncio
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro.serving as RS  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch import serving as PS  # noqa: E402

PKGS = {"jax": (R, RS), "torch": (P, PS)}
BACKENDS = ("reference", "fused")
N_DOCS = 512


# ------------------------------------------------------------ policy fixtures
class FakeFuture:
    """Duck-typed asyncio.Future for event-loop-free policy tests."""

    def __init__(self):
        self.value = None
        self.exception = None
        self._done = False

    def done(self):
        return self._done

    def set_result(self, v):
        assert not self._done
        self.value, self._done = v, True

    def set_exception(self, e):
        assert not self._done
        self.exception, self._done = e, True


@pytest.fixture(params=list(PKGS))
def pkg(request):
    """``(core, serving)`` of one package: each policy unit runs on both."""
    return PKGS[request.param]


def _shape(core, probes=6):
    return core.ExecShape("reference", probes, 5, None)


def _ticket(pkg, t=0.0, deadline=None, priority=0, seq=0, shape=None):
    core, serving = pkg
    return serving.Ticket(
        request=core.SearchRequest(like=seq),
        shape=shape if shape is not None else _shape(core),
        future=FakeFuture(), t_enqueue=t, deadline=deadline,
        priority=priority, seq=seq,
    )


# ------------------------------------------------------------- policy: queues
def test_shape_queue_fifo_and_lookups(pkg):
    core, serving = pkg
    q = serving.ShapeQueue(_shape(core))
    ts = [_ticket(pkg, t=float(i), deadline=10.0 - i, priority=i % 2, seq=i)
          for i in range(5)]
    for t in ts:
        q.append(t)
    assert q.oldest_enqueue() == 0.0
    assert q.min_deadline() == 6.0                      # 10 - 4
    # shed victim: lowest priority (0), youngest among them (seq 4)
    assert q.lowest_priority() is ts[4]
    assert q.drain(2) == ts[:2] and len(q) == 3         # FIFO drain
    assert q.oldest_enqueue() == 2.0


def test_batcher_window_vs_size_flush_race(pkg):
    core, serving = pkg
    shape = _shape(core)
    b = serving.Batcher(window_s=1.0, max_batch=4)
    q = b.queue(shape)
    for i in range(3):
        q.append(_ticket(pkg, t=0.0, seq=i))
    assert b.ready(now=0.5) == []                 # neither trigger yet
    assert b.due_at(q) == 1.0 and b.next_due() == 1.0
    assert b.ready(now=1.0) == [q]                # window elapsed
    q.append(_ticket(pkg, t=0.9, seq=3))
    assert b.ready(now=0.95) == [q]               # size beat the window
    for i in range(4, 10):
        q.append(_ticket(pkg, t=0.9, seq=i))
    assert len(q.drain(b.max_batch)) == 4
    assert len(q) == 6 and b.ready(now=0.95) == [q]
    assert b.pending() == 6 and b.depths() == {shape: 6}
    with pytest.raises(ValueError, match="window_s"):
        serving.Batcher(window_s=-1.0)
    with pytest.raises(ValueError, match="max_batch"):
        serving.Batcher(max_batch=0)


def test_batcher_window_measured_from_oldest(pkg):
    core, serving = pkg
    b = serving.Batcher(window_s=1.0, max_batch=100)
    q = b.queue(_shape(core))
    q.append(_ticket(pkg, t=0.0))
    for t in (0.4, 0.8, 0.95):                    # trickle keeps arriving
        q.append(_ticket(pkg, t=t))
        assert b.due_at(q) == 1.0                 # still the oldest's due
    assert b.ready(now=1.0) == [q]


# --------------------------------------------------------- policy: scheduling
def test_deadline_expiry_and_flush_ordering(pkg):
    core, serving = pkg
    sched = serving.Scheduler(max_queue_depth=8)
    tight = serving.ShapeQueue(_shape(core, 6))
    loose = serving.ShapeQueue(_shape(core, 9))
    free = serving.ShapeQueue(_shape(core, 12))
    t_dead = _ticket(pkg, t=0.0, deadline=1.0, seq=0)
    tight.append(t_dead)
    tight.append(_ticket(pkg, t=0.0, deadline=5.0, seq=1))
    loose.append(_ticket(pkg, t=0.5, deadline=3.0, seq=2))
    free.append(_ticket(pkg, t=0.1, seq=3))       # no deadline

    dead = sched.expire([tight, loose, free], now=2.0)
    assert dead == [t_dead] and len(tight) == 1
    assert isinstance(t_dead.future.exception, serving.DeadlineExceeded)
    assert "budget" in str(t_dead.future.exception)
    assert sched.flush_order([free, tight, loose]) == [loose, tight, free]
    free2 = serving.ShapeQueue(_shape(core, 3))
    free2.append(_ticket(pkg, t=0.05, seq=4))
    assert sched.flush_order([free, free2]) == [free2, free]
    with pytest.raises(ValueError, match="max_queue_depth"):
        serving.Scheduler(max_queue_depth=0)


def test_priority_shedding_under_full_queue(pkg):
    core, serving = pkg
    sched = serving.Scheduler(max_queue_depth=2, shed_low_priority=True)
    q = serving.ShapeQueue(_shape(core))
    lo, hi = _ticket(pkg, priority=0, seq=0), _ticket(pkg, priority=1, seq=1)
    assert sched.admit(q, lo) is None and sched.admit(q, hi) is None
    vip = _ticket(pkg, priority=2, seq=2)
    victim = sched.admit(q, vip)
    assert victim is lo and list(q) == [hi, vip]
    assert isinstance(lo.future.exception, serving.Overloaded)
    assert "shed" in str(lo.future.exception)
    also_lo = _ticket(pkg, priority=1, seq=3)
    with pytest.raises(serving.Overloaded, match="preempts nothing"):
        sched.admit(q, also_lo)
    assert not also_lo.future.done() and list(q) == [hi, vip]
    strict = serving.Scheduler(max_queue_depth=1, shed_low_priority=False)
    q2 = serving.ShapeQueue(_shape(core))
    strict.admit(q2, _ticket(pkg, priority=0, seq=0))
    with pytest.raises(serving.Overloaded):
        strict.admit(q2, _ticket(pkg, priority=9, seq=1))


def test_expired_waiter_releases_queue_slot(pkg):
    core, serving = pkg
    expired_seen = []
    sched = serving.Scheduler(max_queue_depth=2, shed_low_priority=True,
                              on_expired=expired_seen.append)
    q = serving.ShapeQueue(_shape(core))
    dead = _ticket(pkg, t=0.0, deadline=1.0, seq=0)
    live = _ticket(pkg, t=0.0, deadline=50.0, seq=1)
    assert sched.admit(q, dead) is None and sched.admit(q, live) is None
    newcomer = _ticket(pkg, t=2.0, deadline=None, seq=2)
    assert sched.admit(q, newcomer) is None       # admitted, nothing shed
    assert list(q) == [live, newcomer]
    assert isinstance(dead.future.exception, serving.DeadlineExceeded)
    assert expired_seen == [dead]
    with pytest.raises(serving.Overloaded):
        sched.admit(q, _ticket(pkg, t=3.0, priority=0, seq=3))


def test_stats_aggregation(pkg):
    core, serving = pkg
    s = serving.ServerStats()
    for _ in range(3):
        s.record_submit()
    s.record_batch([0.001, 0.002], 0.010)
    s.record_batch([0.004], 0.020)
    s.record_expired()
    s.record_shape_compute(_shape(core), 0.010)
    s.record_shape_compute(_shape(core), 0.030)
    assert s.submitted == 3 and s.completed == 3 and s.batches == 2
    snap = s.snapshot({_shape(core): 4})
    assert snap["batch_size_hist"] == {1: 1, 2: 1}
    assert snap["mean_batch_size"] == 1.5
    assert snap["compute_ms"]["p50"] == pytest.approx(15.0)
    assert snap["latency_ms"]["p99"] >= snap["latency_ms"]["p50"] > 0
    assert snap["queue_depth"] == {str(_shape(core)): 4}
    assert s.shape_p99(_shape(core)) == pytest.approx(0.0298)
    assert s.shape_p99(_shape(core, 9)) is None
    line = s.format_line()
    assert "served=3/3" in line and "expired=1" in line
    s.record_retry()
    assert "retries=1" in s.format_line()


def test_both_packages_aggregate_the_same_stats():
    """One recorded history, both packages' snapshots and log lines equal
    (shapes are named tuples, so their string keys agree too)."""
    out = []
    for core, serving in PKGS.values():
        s = serving.ServerStats()
        rng = np.random.default_rng(3)
        for n in (1, 5, 8, 8, 3):
            s.record_submit()
            s.record_batch(list(rng.random(n) * 1e-3), float(rng.random()))
            s.record_shape_compute(_shape(core), float(rng.random()))
        s.record_shed(2)
        s.record_hedge()
        s.record_breaker_trip()
        out.append((s.snapshot({_shape(core): 2}), s.format_line(),
                    s.shape_p99(_shape(core))))
    assert out[0] == out[1]


# --------------------------------------------------------------- live servers
@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 512-doc, 128-wide index built by the JAX package and saved."""
    spec = R.FieldSpec(names=("title", "authors", "abstract"),
                       dims=(32, 32, 64))
    x = jax.random.normal(jax.random.PRNGKey(17), (N_DOCS, spec.total_dim))
    index = R.ClusterPruneIndex.build(
        R.normalize_fields(x, spec), spec, 16, n_clusterings=3,
        method="fpf", key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("serving") / "index.npz"
    index.save(path)
    return index, path


@pytest.fixture(scope="module")
def port_index(saved):
    return P.ClusterPruneIndex.load(saved[1], device="cpu")


def retriever_on(index, backend):
    """A fresh facade (empty request caches) on ``backend``."""
    return P.Retriever(index, backend=backend)


def mlt_requests(n, seed=0, backend=None, core=P, **shape):
    rng = np.random.default_rng(seed)
    qids = rng.choice(N_DOCS, n, replace=False)
    w = rng.dirichlet([1.0, 1.0, 1.0], size=n).astype(np.float32)
    return [
        core.SearchRequest(
            like=int(qids[i]),
            weights={"title": float(w[i, 0]), "authors": float(w[i, 1]),
                     "abstract": float(w[i, 2])},
            backend=backend, **shape,
        )
        for i in range(n)
    ]


def assert_same_answers(responses, requests, solo):
    """Every response equals one-by-one synchronous search on a fresh
    facade: ids, n_scored, scores within 1e-6."""
    for resp, req in zip(responses, requests):
        ref = solo.search(req)
        np.testing.assert_array_equal(resp.doc_ids, ref.doc_ids)
        np.testing.assert_allclose(resp.scores, ref.scores, atol=1e-6)
        assert resp.n_scored == ref.n_scored


def test_default_max_batch_is_64_with_tile_16(port_index):
    """The port's size trigger: 64 on every backend, a multiple of the CUDA
    kernel's query tile of 16 (no memory budget enters), on every pack."""
    from repro_torch.serving.server import _engine_query_tile

    assert PS.default_max_batch(retriever_on(port_index, "reference")) == 64
    assert _engine_query_tile(retriever_on(port_index, "reference")) is None
    for pack_dtype in (None, "bfloat16", "int8"):
        idx = P.ClusterPruneIndex.from_numpy(port_index._archive(),
                                             device="cpu")
        idx.pack_dtype = pack_dtype
        fused = retriever_on(idx, "fused")
        assert _engine_query_tile(fused) == 16
        assert PS.default_max_batch(fused) == 64
    wide = P.Retriever(port_index, backend="fused",
                       engine_opts={"query_tile": 24})
    assert PS.default_max_batch(wide) == 72       # rounded up to the tile


@pytest.mark.parametrize("backend", BACKENDS)
def test_ragged_batch_parity_vs_one_by_one(port_index, backend):
    """11 concurrent submits against max_batch=8 -> one full batch plus a
    ragged tail of 3; every response matches one-by-one sync search."""
    requests = mlt_requests(11, seed=1, backend=backend, probes=6, k=5)

    async def go():
        async with PS.SearchServer(
            retriever_on(port_index, backend), window_s=0.01, max_batch=8
        ) as server:
            assert all(e.stream is None for e in server.pool.entries)
            return await asyncio.gather(
                *(server.submit(r) for r in requests)
            ), server.stats.snapshot()

    responses, snap = asyncio.run(go())
    assert snap["completed"] == 11
    assert sorted(r.batch_size for r in responses) == [3] * 3 + [8] * 8
    assert_same_answers(responses, requests, retriever_on(port_index,
                                                          backend))
    for resp in responses:
        assert resp.backend == backend
        assert resp.queue_wait_s >= 0 and resp.compute_s > 0
        assert resp.latency_s == pytest.approx(
            resp.queue_wait_s + resp.compute_s)


@pytest.mark.parametrize("backend", BACKENDS)
def test_size_flush_beats_window(port_index, backend):
    """max_batch submits flush at once — nobody waits out a 30 s window."""
    requests = mlt_requests(4, seed=2, probes=6, k=5)

    async def go():
        async with PS.SearchServer(
            retriever_on(port_index, backend), window_s=30.0, max_batch=4
        ) as server:
            t0 = time.perf_counter()
            resps = await asyncio.gather(
                *(server.submit(r) for r in requests)
            )
            return resps, time.perf_counter() - t0

    responses, elapsed = asyncio.run(go())
    assert elapsed < 30.0
    assert [r.batch_size for r in responses] == [4] * 4


@pytest.mark.parametrize("backend", BACKENDS)
def test_deadline_expires_in_queue(port_index, backend):
    """A queued request whose deadline passes before its window flushes
    fails typed; its shape-mate dispatches alone after the window."""
    live_req, dead_req = mlt_requests(2, seed=3, probes=6, k=5)
    retriever = retriever_on(port_index, backend)

    async def go():
        async with PS.SearchServer(
            retriever, window_s=0.25, max_batch=64
        ) as server:
            dead = asyncio.create_task(
                server.submit(dead_req, deadline_s=0.02))
            live = asyncio.create_task(server.submit(live_req))
            with pytest.raises(PS.DeadlineExceeded, match="budget"):
                await dead
            resp = await live
            return resp, server.stats.snapshot()

    resp, snap = asyncio.run(go())
    assert resp.batch_size == 1
    assert resp.queue_wait_s >= 0.2
    assert snap["expired"] == 1 and snap["completed"] == 1

    async def instant():
        async with PS.SearchServer(retriever) as server:
            with pytest.raises(PS.DeadlineExceeded, match="at submission"):
                await server.submit(live_req, deadline_s=0.0)

    asyncio.run(instant())


@pytest.mark.parametrize("backend", BACKENDS)
def test_live_shedding_priority_order(port_index, backend):
    """Depth 1, long window: a high-priority newcomer sheds the queued
    low-priority waiter; an equal-priority newcomer is rejected."""
    reqs = mlt_requests(3, seed=4, probes=6, k=5)

    async def go():
        async with PS.SearchServer(
            retriever_on(port_index, backend), window_s=0.3, max_batch=64,
            max_queue_depth=1,
        ) as server:
            low = asyncio.create_task(server.submit(reqs[0], priority=0))
            await asyncio.sleep(0)
            high = asyncio.create_task(server.submit(reqs[1], priority=1))
            await asyncio.sleep(0)
            with pytest.raises(PS.Overloaded, match="preempts nothing"):
                await server.submit(reqs[2], priority=1)
            with pytest.raises(PS.Overloaded, match="shed"):
                await low
            resp = await high
            return resp, server.stats.snapshot()

    resp, snap = asyncio.run(go())
    assert resp.batch_size == 1
    assert snap["shed"] == 1 and snap["rejected"] == 1
    assert snap["completed"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_e2e_two_replicas_heterogeneous_shapes(port_index, backend):
    """Two shapes, two replicas: every submit answered as sync search
    answers it, per-shape batching honoured, stats coherent."""
    requests = (mlt_requests(9, seed=5, probes=6, k=5)
                + mlt_requests(6, seed=6, probes=9, k=3))

    async def go():
        async with PS.SearchServer(
            retriever_on(port_index, backend), window_s=0.02, max_batch=8,
            replicas=2,
        ) as server:
            resps = await asyncio.gather(
                *(server.submit(r) for r in requests))
            return resps, server.stats.snapshot()

    responses, snap = asyncio.run(go())
    assert snap["submitted"] == snap["completed"] == 15
    assert snap["expired"] == snap["rejected"] == snap["failed"] == 0
    assert snap["batches"] >= 3                   # 9 -> 8+1, 6 -> 6
    assert sum(n * c for n, c in snap["batch_size_hist"].items()) == 15
    for resp, req in zip(responses, requests):
        assert resp.probes == req.probes and len(resp.ids) == req.k
    assert all(r.batch_size <= 6 for r in responses if len(r.ids) == 3)
    assert_same_answers(responses, requests, retriever_on(port_index,
                                                          backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_stop_without_drain_fails_queued(port_index, backend):
    req, = mlt_requests(1, seed=7, probes=6, k=5)

    async def go():
        server = await PS.SearchServer(
            retriever_on(port_index, backend), window_s=5.0, max_batch=64
        ).start()
        fut = asyncio.create_task(server.submit(req))
        await asyncio.sleep(0)
        await server.stop(drain=False)
        with pytest.raises(PS.Overloaded, match="stopped"):
            await fut
        with pytest.raises(RuntimeError, match="not running"):
            await server.submit(req)

    asyncio.run(go())


@pytest.mark.parametrize("backend", BACKENDS)
def test_tiered_shapes_through_server(port_index, backend):
    """Exact submits key their own queue (the pinned full-sweep shape),
    batch together and answer as synchronous exact search; budgeted peers
    in the same burst are unaffected."""
    exact_reqs = mlt_requests(5, seed=8, k=5, exact=True)
    approx_reqs = mlt_requests(4, seed=9, probes=6, k=5)
    retriever = retriever_on(port_index, backend)

    async def go():
        async with PS.SearchServer(
            retriever, window_s=0.02, max_batch=8
        ) as server:
            resps = await asyncio.gather(
                *(server.submit(r) for r in exact_reqs + approx_reqs))
            return resps, server.stats.snapshot()

    responses, snap = asyncio.run(go())
    assert snap["completed"] == 9
    t, kc = retriever._tk
    for resp in responses[:5]:
        assert resp.tier == "exact" and resp.batch_size == 5
        assert resp.probes == t * kc and resp.predicted_recall == 1.0
    for resp in responses[5:]:
        assert resp.tier == "approx" and resp.batch_size == 4
        assert resp.probes == 6
    assert snap["batch_size_hist"] == {4: 1, 5: 1}
    assert_same_answers(responses, exact_reqs + approx_reqs,
                        retriever_on(port_index, backend))


def test_same_burst_through_both_packages(saved, port_index):
    """The same requests through the reference's and the port's
    SearchServer on the reference backend: equal ids and n_scored, scores
    within 1e-5, batched the same way."""
    index, _ = saved
    out = {}
    for name, core, serving, idx in (("jax", R, RS, index),
                                     ("torch", P, PS, port_index)):
        requests = (mlt_requests(12, seed=11, core=core, probes=6, k=5)
                    + mlt_requests(5, seed=12, core=core, probes=9, k=7))

        async def go():
            async with serving.SearchServer(
                core.Retriever(idx, backend="reference"), window_s=0.05,
                max_batch=8, replicas=2,
            ) as server:
                return await asyncio.gather(
                    *(server.submit(r) for r in requests))

        out[name] = asyncio.run(go())
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(b.doc_ids, a.doc_ids)
        assert b.n_scored == a.n_scored and b.probes == a.probes
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
    assert (sorted(r.batch_size for r in out["jax"])
            == sorted(r.batch_size for r in out["torch"]))


# ------------------------------------------------- once-only builds, counters
def test_pack_and_engine_built_once_under_concurrent_first_use(
        port_index, monkeypatch):
    """N threads reach a fresh index at once: the bucket-major pack is made
    once and every thread gets the same pack and the same engine."""
    import repro_torch.core.index as index_mod
    from repro_torch.core.engine import BACKENDS as ENGINES

    idx = P.ClusterPruneIndex.from_numpy(port_index._archive(), device="cpu")
    assert idx.bucket_data is None
    packs, engines = [], []
    real_pack = index_mod.pack_buckets_major
    real_engine = ENGINES["fused"]

    def slow_pack(*a, **kw):
        packs.append(1)
        time.sleep(0.05)                 # widen the check-then-set window
        return real_pack(*a, **kw)

    class SlowEngine(real_engine):
        def __init__(self, *a, **kw):
            engines.append(1)
            time.sleep(0.05)
            super().__init__(*a, **kw)

    monkeypatch.setattr(index_mod, "pack_buckets_major", slow_pack)
    monkeypatch.setitem(ENGINES, "fused", SlowEngine)
    n = 8
    barrier = threading.Barrier(n)
    got = [None] * n

    def first_use(i):
        barrier.wait(timeout=30)
        got[i] = (P.get_engine(idx, "fused"), idx.ensure_bucket_major())

    threads = [threading.Thread(target=first_use, args=(i,))
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert len(packs) == 1 and len(engines) == 1
    assert all(g[0] is got[0][0] for g in got)
    assert all(g[1][0] is got[0][1][0] for g in got)


def test_launch_counts_are_exact_under_threads():
    """count_launch under 8 threads and a tiny switch interval: no
    increment is lost (a bare ``+=`` loses some)."""
    from repro_torch.kernels.common import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.rounds = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(20_000):
                count_launch(wrapper)
                count_launch(wrapper, "rounds", 3)

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 8 * 20_000
    assert wrapper.rounds == 3 * 8 * 20_000


def test_index_copies_and_pickles_without_its_lock(port_index):
    """The build lock is per index and never copied: a deep copy (as the
    mutation tests make) gets its own."""
    import copy
    import pickle

    idx = P.ClusterPruneIndex.from_numpy(port_index._archive(), device="cpu")
    lock = idx.build_lock()
    assert idx.build_lock() is lock
    for twin in (copy.deepcopy(idx), pickle.loads(pickle.dumps(idx))):
        assert twin.build_lock() is not lock
        assert torch.equal(twin.buckets, idx.buckets)


# ------------------------------------------------------- entry points (CPU)
@pytest.mark.parametrize("extra", [["--serve", "--replicas", "2"],
                                   ["--chaos", "transient"],
                                   ["--backend", "sharded", "--shards", "3",
                                    "--serve", "--replicas", "2"]])
def test_serve_async_tier_on_cpu(extra, capsys):
    from repro_torch.launch import serve

    serve.main(["--docs", "1500", "--queries", "16", "--device", "cpu",
                *extra])
    out = capsys.readouterr().out
    assert "async parity vs one-by-one: 0 mismatches (OK)" in out
    assert "served=16/16" in out
    if "--chaos" in extra:
        assert "chaos outcome: 16 answered" in out
        assert out.count("[serve] replica ") == 4


def test_serve_sharded_compare_exact_on_cpu(capsys):
    """``serve --backend sharded --shards 3 --compare --exact`` on the CPU:
    every backend's exact tier equals brute force, and ``--shards`` goes
    only with the sharded backend."""
    from repro_torch.launch import serve

    serve.main(["--docs", "1500", "--queries", "16", "--device", "cpu",
                "--backend", "sharded", "--shards", "3", "--compare",
                "--exact"])
    out = capsys.readouterr().out
    for name in ("reference", "fused", "sharded"):
        assert (f"backend={name}: exact-tier parity vs brute force: 0 "
                f"mismatches (OK)") in out
    with pytest.raises(SystemExit):
        serve.main(["--docs", "64", "--device", "cpu", "--shards", "2"])


def test_default_max_batch_is_64_on_sharded(port_index):
    """The sharded backend runs the same kernel on each shard: tile 16,
    size trigger 64, on every pack, packed or not."""
    from repro_torch.serving.server import _engine_query_tile

    for pack_dtype in (None, "bfloat16", "int8"):
        idx = P.ClusterPruneIndex.from_numpy(port_index._archive(),
                                             device="cpu")
        idx.pack_dtype = pack_dtype
        sharded = P.Retriever(idx, backend="sharded",
                              engine_opts={"n_shards": 3})
        assert _engine_query_tile(sharded) == 16
        assert PS.default_max_batch(sharded) == 64
        idx.ensure_local_bucket_major(3)
        assert PS.default_max_batch(sharded) == 64


@pytest.mark.parametrize("extra", [[], ["--chaos", "--profiles",
                                        "transient"]])
def test_loadtest_on_cpu(extra, tmp_path, capsys):
    import json

    from repro_torch.benchmarks import loadtest

    out_path = tmp_path / "loadtest.json"
    assert loadtest.main(["--scale", "quick", "--docs", "600", "--requests",
                          "48", "--device", "cpu", "--out", str(out_path),
                          *extra]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out_path.read_text())
    assert payload["device"] == "cpu" and payload["card"] is None
    modes = [e["mode"] for e in payload["entries"]]
    assert all(e["device"] == "cpu" for e in payload["entries"])
    if extra:
        assert modes == ["chaos", "chaos"]
        assert [e["profile"] for e in payload["entries"]] == [
            "none", "transient"]
        assert all(e["parity_violations"] == 0 for e in payload["entries"])
        assert "all profiles passed" in out
    else:
        assert modes == ["sequential", "closed", "open", "server_stats"]
        closed, opened = payload["entries"][1:3]
        assert closed["completed"] == opened["completed"] == 48
        assert closed["max_batch"] == 64 and closed["concurrency"] == 64
        assert opened["rate_qps"] == pytest.approx(0.8 * closed["qps"],
                                                   abs=0.1)
