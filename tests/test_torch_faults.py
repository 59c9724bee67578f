"""PyTorch port, the fault-tolerant serving tier
(``repro_torch.serving.health`` / ``.faults``) against the reference's:
the frozen-clock units (breaker, retry budget, resilience config, replica
health, degradation ladder, fault profiles) replayed on both packages, the
fault injector's ok/error/hang traces equal in both packages for every
profile and two seeds, live servers on the port's ``reference`` and
``fused`` backends under injected faults (retries to parity, a wedged
replica timed out, the breaker tripping and recovering, guaranteed
requests failing typed), and degraded answers that keep the API's
invariants in both packages. The index is built by the JAX package and
loaded by the port from its ``.npz``."""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro.serving as RS  # noqa: E402
import repro.serving.faults as RF  # noqa: E402
from repro.core.calibrate import ProbeLadder as RLadder  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch import serving as PS  # noqa: E402
import repro_torch.serving.faults as PF  # noqa: E402

PKGS = {"jax": (R, RS, RLadder), "torch": (P, PS, P.ProbeLadder)}
BACKENDS = ("reference", "fused")
N_DOCS = 512


@pytest.fixture(params=list(PKGS))
def pkg(request):
    """``(core, serving, ProbeLadder)`` of one package."""
    return PKGS[request.param]


# ----------------------------------------------------------- circuit breaker
def test_breaker_trips_at_threshold_and_cools_down(pkg):
    b = pkg[1].CircuitBreaker(failures=3, cooldown_s=1.0)
    assert b.state == "closed" and b.allow(now=0.0)
    assert not b.record_failure(now=0.1)
    assert not b.record_failure(now=0.2)
    assert b.record_failure(now=0.3)              # third consecutive: TRIP
    assert b.state == "open" and b.trips == 1
    assert not b.allow(now=0.5)
    assert not b.would_allow(now=0.5)
    assert b.would_allow(now=1.31)
    assert b.allow(now=1.31) and b.state == "half_open"
    assert not b.allow(now=1.32)                  # second probe refused
    assert b.record_success(now=1.4)              # probe ok: RECOVERY
    assert b.state == "closed" and b.recoveries == 1
    assert b.allow(now=1.5)
    with pytest.raises(ValueError, match="failures"):
        pkg[1].CircuitBreaker(failures=0)


def test_breaker_failed_probe_reopens(pkg):
    b = pkg[1].CircuitBreaker(failures=1, cooldown_s=1.0)
    assert b.record_failure(now=0.0) and b.state == "open"
    assert b.allow(now=1.0) and b.state == "half_open"
    assert b.record_failure(now=1.1)
    assert b.state == "open" and b.trips == 2 and b.recoveries == 0
    assert not b.allow(now=1.5)
    assert b.allow(now=2.1)


def test_breaker_would_allow_is_pure(pkg):
    b = pkg[1].CircuitBreaker(failures=1, cooldown_s=0.5)
    b.record_failure(now=0.0)
    assert b.would_allow(now=0.6) and b.state == "open"
    assert b.would_allow(now=0.6)
    assert b.allow(now=0.6) and b.state == "half_open"
    assert not b.would_allow(now=0.6)
    b.record_success(now=0.7)
    b.record_failure(now=0.8)
    b.record_success(now=0.9)
    assert b.consecutive == 0


def test_retry_budget_drains_and_refills(pkg):
    budget = pkg[1].RetryBudget(ratio=0.5, cap=2.0)
    assert budget.try_spend() and budget.try_spend()
    assert not budget.try_spend()
    budget.on_success()
    assert budget.tokens == pytest.approx(0.5)
    assert not budget.try_spend()
    budget.on_success()
    assert budget.try_spend() and not budget.try_spend()
    for _ in range(10):
        budget.on_success()
    assert budget.tokens == pytest.approx(2.0)
    with pytest.raises(ValueError, match="cap"):
        pkg[1].RetryBudget(cap=0.0)


def test_resilience_config_timeout_and_backoff(pkg):
    cfg_cls = pkg[1].ResilienceConfig
    cfg = cfg_cls(timeout_mult=4.0, timeout_floor_s=0.1, timeout_ceil_s=2.0,
                  backoff_base_s=0.01, backoff_cap_s=0.04)
    assert cfg.attempt_timeout(None) == 2.0
    assert cfg.attempt_timeout(0.2) == pytest.approx(0.8)
    assert cfg.attempt_timeout(0.001) == pytest.approx(0.1)
    assert cfg.attempt_timeout(10.0) == pytest.approx(2.0)
    assert cfg.backoff(1, jitter=0.5) == pytest.approx(0.01)
    assert cfg.backoff(2, jitter=0.0) == pytest.approx(0.01)
    assert cfg.backoff(5, jitter=0.999) == pytest.approx(0.04 * 1.499)
    with pytest.raises(ValueError, match="timeout_floor_s"):
        cfg_cls(timeout_floor_s=1.0, timeout_ceil_s=0.5)
    with pytest.raises(ValueError, match="ewma_alpha"):
        cfg_cls(ewma_alpha=0.0)
    with pytest.raises(ValueError, match="max_retries"):
        cfg_cls(max_retries=-1)
    with pytest.raises(ValueError, match="degrade_highwater"):
        cfg_cls(degrade_highwater=0.0)


def test_replica_health_ewma_and_lag(pkg):
    h = pkg[1].ReplicaHealth(0, pkg[1].ResilienceConfig(ewma_alpha=0.5))
    assert h.ewma_latency_s is None and h.lag(now=5.0) == 0.0
    h.record_success(now=1.0, latency_s=0.1)
    h.record_success(now=2.0, latency_s=0.3)
    assert h.ewma_latency_s == pytest.approx(0.2)
    h.busy_since = 10.0
    assert h.lag(now=12.5) == pytest.approx(2.5)
    assert h.record_failure(now=3.0, timed_out=True) is False
    snap = h.snapshot(now=12.5)
    assert snap["dispatches"] == 3 and snap["timeouts"] == 1
    assert snap["state"] == "closed" and snap["ewma_ms"] == pytest.approx(200.0)


# -------------------------------------------------------- degradation ladder
def _ladder(ladder_cls, probes=(3, 6, 12)):
    return ladder_cls.from_dict({
        "probes": list(probes),
        "recall": [0.6 + 0.1 * i for i in range(len(probes))],
        "n_clusterings": 3,
        "k_clusters": 16,
    })


def test_degrade_rungs_are_cumulative_and_audited(pkg):
    core, serving, ladder_cls = pkg
    req = core.SearchRequest(like=0, probes=12, rescore=20)
    shape = core.ExecShape("reference", 12, 10, 20)
    r1, lab1 = serving.degrade_request(req, shape, rung=1)
    assert r1.rescore is None and r1.probes == 12
    assert lab1 == ("rescore:20->none",)
    r2, lab2 = serving.degrade_request(
        req, shape, rung=2, ladder=_ladder(ladder_cls), total_probes=12,
        n_clusterings=3)
    assert r2.rescore is None and r2.probes == 6
    assert lab2 == ("rescore:20->none", "probes:12->6")
    r3, lab3 = serving.degrade_request(
        core.SearchRequest(like=0, probes=4),
        core.ExecShape("reference", 4, 10, None), rung=2, n_clusterings=3)
    assert r3.probes == 3 and lab3 == ("probes:4->3",)
    r4, lab4 = serving.degrade_request(
        core.SearchRequest(like=0, probes=3),
        core.ExecShape("reference", 3, 10, None), rung=2,
        ladder=_ladder(ladder_cls), n_clusterings=3)
    assert r4 is not None and lab4 == ()


def test_degrade_refuses_guarantees(pkg):
    core, serving, _ = pkg
    shape = core.ExecShape("reference", 6, 10, None)
    with pytest.raises(ValueError, match="exact"):
        serving.degrade_request(
            core.SearchRequest(like=0, exact=True),
            core.ExecShape("reference", 0, 10, None, tier="exact"), rung=1)
    with pytest.raises(ValueError, match="min_recall"):
        serving.degrade_request(
            core.SearchRequest(like=0, probes=6, min_recall=0.9), shape,
            rung=1)
    r, lab = serving.degrade_request(
        core.SearchRequest(like=0, probes=6, min_recall=0.9), shape,
        rung=1, relax_floors=True)
    assert r.min_recall is None
    assert lab == ("floor:0.9->best-effort",)


def test_degrade_batch_serves_rest_fails_guaranteed(pkg):
    core, serving, _ = pkg
    reqs = [
        core.SearchRequest(like=0, probes=6, rescore=10),
        core.SearchRequest(like=1, probes=6, min_recall=0.9),
        core.SearchRequest(like=2, probes=6),
    ]
    shape = core.ExecShape("reference", 6, 10, 10)
    out, labels, refused = serving.degrade_batch(reqs, shape, rung=1)
    assert refused == [1]
    assert out[1] is reqs[1] and labels[1] == ()
    assert out[0].rescore is None and labels[0]
    assert len(out) == len(labels) == 3


def test_degrade_ladder_walk_equal_in_both_packages():
    """Every (rung, probes, rescore, floor) on one ladder: both packages
    take away the same things, with the same labels."""
    seen = {}
    for name, (core, serving, ladder_cls) in PKGS.items():
        out = []
        for rung in (0, 1, 2):
            for probes in range(1, 15):
                for rescore in (None, 12):
                    for floor in (None, 0.8):
                        req = core.SearchRequest(like=3, probes=probes,
                                                 rescore=rescore,
                                                 min_recall=floor)
                        shape = core.ExecShape("reference", probes, 10,
                                               rescore)
                        r, lab = serving.degrade_request(
                            req, shape, rung=rung,
                            ladder=_ladder(ladder_cls, (2, 5, 9, 13)),
                            total_probes=48, n_clusterings=3,
                            relax_floors=floor is not None)
                        out.append((r.probes, r.rescore, r.min_recall, lab))
        seen[name] = out
    assert seen["jax"] == seen["torch"]


# ------------------------------------------------------------ fault injector
def test_fault_profile_validation_and_describe(pkg):
    serving = pkg[1]
    with pytest.raises(ValueError, match="error_p"):
        serving.FaultProfile(error_p=1.5)
    with pytest.raises(ValueError, match="flap_run"):
        serving.FaultProfile(flap_run=-1)
    with pytest.raises(ValueError, match="durations"):
        serving.FaultProfile(hang_s=-1.0)
    assert serving.FaultProfile().benign
    assert serving.FaultProfile().describe() == "healthy"
    d = serving.FaultProfile(hang_p=0.5, flap_run=4).describe()
    assert "flap(run=4)" in d and "hang" in d
    with pytest.raises(ValueError, match="unknown fault profile"):
        serving.FaultPolicy.named("nope")
    policy = serving.FaultPolicy.named("hang_flap", seed=7)
    assert policy.profile(1).hang_p == 1.0 and policy.profile(2).flap_run == 4
    assert policy.profile(0).benign
    assert "r1=" in policy.describe()
    assert serving.FaultPolicy().describe() == "custom: all replicas healthy"


def test_fault_profiles_equal_in_both_packages():
    assert sorted(RS.FAULT_PROFILES) == sorted(PS.FAULT_PROFILES)
    for name, profiles in RS.FAULT_PROFILES.items():
        ported = PS.FAULT_PROFILES[name]
        assert sorted(profiles) == sorted(ported)
        for idx, p in profiles.items():
            assert (dataclasses_tuple(p) == dataclasses_tuple(ported[idx]))
        assert (RS.FaultPolicy.named(name, seed=3).describe()
                == PS.FaultPolicy.named(name, seed=3).describe())


def dataclasses_tuple(p):
    return (p.latency_p, p.latency_s, p.error_p, p.hang_p, p.hang_s,
            p.flap_run)


def _fault_trace(faults_mod, policy, idx: int, n: int, sleeps) -> list:
    """Outcome of n wrapped calls: ('ok', seconds slept) or the message."""
    wrapped = policy.wrap(idx, lambda: "ok")
    out = []
    for _ in range(n):
        sleeps.clear()
        try:
            wrapped()
            out.append(("ok", tuple(sleeps)))
        except faults_mod.InjectedFault as e:
            out.append(("fault", str(e)))
    return out


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("profile", sorted(RS.FAULT_PROFILES))
def test_fault_traces_equal_in_both_packages(profile, seed, monkeypatch):
    """``FaultPolicy.named(profile, seed).wrap(...)`` gives the same
    ok / error / spike / hang sequence, call for call, in both packages
    (the same numpy draws). Sleeps are recorded, not slept."""
    sleeps: list = []
    monkeypatch.setattr(RF.time, "sleep", sleeps.append)
    assert PF.time is RF.time
    traces = {}
    for name, mod, serving in (("jax", RF, RS), ("torch", PF, PS)):
        policy = serving.FaultPolicy.named(profile, seed=seed)
        traces[name] = {idx: _fault_trace(mod, policy, idx, 48, sleeps)
                        for idx in range(4)}
    assert traces["jax"] == traces["torch"]
    kinds = {o[0] if o[0] == "fault" else ("ok", o[1])
             for t in traces["torch"].values() for o in t}
    assert ("ok", ()) in kinds
    if profile != "slow":
        assert "fault" in kinds or profile in ("hang",)


def test_fault_injection_is_deterministic():
    sleeps: list = []
    a = _fault_trace(PF, PS.FaultPolicy({1: PS.FaultProfile(error_p=0.5)},
                                        seed=3), 1, 40, sleeps)
    b = _fault_trace(PF, PS.FaultPolicy({1: PS.FaultProfile(error_p=0.5)},
                                        seed=3), 1, 40, sleeps)
    c = _fault_trace(PF, PS.FaultPolicy({1: PS.FaultProfile(error_p=0.5)},
                                        seed=4), 1, 40, sleeps)
    assert a == b and a != c
    t = _fault_trace(PF, PS.FaultPolicy({1: PS.FaultProfile(flap_run=2)}),
                     1, 8, sleeps)
    assert [o[0] for o in t] == ["ok", "ok", "fault", "fault"] * 2
    policy = PS.FaultPolicy({1: PS.FaultProfile()})
    fn = lambda: "x"  # noqa: E731
    assert policy.wrap(1, fn) is fn


# --------------------------------------------------------------- live chaos
@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 512-doc, 128-wide index built by the JAX package and saved."""
    spec = R.FieldSpec(names=("title", "authors", "abstract"),
                       dims=(32, 32, 64))
    x = jax.random.normal(jax.random.PRNGKey(23), (N_DOCS, spec.total_dim))
    index = R.ClusterPruneIndex.build(
        R.normalize_fields(x, spec), spec, 16, n_clusterings=3,
        method="fpf", key=jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("faults") / "index.npz"
    index.save(path)
    return index, path


@pytest.fixture(scope="module")
def port_index(saved):
    return P.ClusterPruneIndex.load(saved[1], device="cpu")


def _requests(n, seed=0, core=P, **shape):
    rng = np.random.default_rng(seed)
    qids = rng.choice(N_DOCS, n, replace=False)
    return [core.SearchRequest(like=int(q), probes=6, k=5, **shape)
            for q in qids]


def _serve(retriever, requests, *, policy, cfg, replicas=2, max_batch=2,
           return_exceptions=False):
    async def go():
        async with PS.SearchServer(
            retriever, window_s=0.002, max_batch=max_batch,
            replicas=replicas, resilience=cfg, fault_policy=policy,
        ) as server:
            resps = await asyncio.gather(
                *(server.submit(r) for r in requests),
                return_exceptions=return_exceptions,
            )
            return resps, server.stats.snapshot(), server.pool.health_snapshot()

    return asyncio.run(go())


def test_pool_pick_skips_trials_when_budget_dry(pkg, saved, port_index):
    """A dry retry budget (probe_ok=False) steers the pick to a closed
    replica — unless none exists, when someone must probe anyway."""
    core, serving, _ = pkg
    index = saved[0] if core is R else port_index
    pool = serving.ReplicaPool(
        core.Retriever(index, backend="reference"), 2,
        config=serving.ResilienceConfig(breaker_cooldown_s=0.0,
                                        breaker_failures=3),
    )
    bad = pool.entries[0].health.breaker
    for _ in range(3):
        bad.record_failure(0.0)
    assert bad.state == "open"
    assert pool._pick(1.0, frozenset()) is pool.entries[0]
    assert pool._pick(1.0, frozenset(), probe_ok=False) is pool.entries[1]
    other = pool.entries[1].health.breaker
    for _ in range(3):
        other.record_failure(1.0)
    assert pool._pick(2.0, frozenset(), probe_ok=False) is not None
    # replicas share the index, each with its own facade; lazy calibration
    # is off on the replicas the pool adds
    assert pool.entries[1].retriever is not pool.entries[0].retriever
    assert pool.entries[1].retriever.index is index
    assert not pool.entries[1].retriever.calibrate


@pytest.mark.parametrize("backend", BACKENDS)
def test_transient_errors_retried_to_parity(port_index, backend):
    """Replica 1 fails EVERY dispatch; retries land on replica 0 and every
    response still matches the synchronous path id for id."""
    requests = _requests(10, seed=5)
    resps, snap, health = _serve(
        P.Retriever(port_index, backend=backend), requests,
        policy=PS.FaultPolicy({1: PS.FaultProfile(error_p=1.0)}, seed=0),
        cfg=PS.ResilienceConfig(seed=0, hedge=False,
                                breaker_cooldown_s=30.0,
                                timeout_floor_s=5.0),
    )
    solo = P.Retriever(port_index, backend=backend)
    for resp, req in zip(resps, requests):
        ref = solo.search(req)
        np.testing.assert_array_equal(resp.doc_ids, ref.doc_ids)
        np.testing.assert_allclose(resp.scores, ref.scores, atol=1e-6)
        assert not resp.degraded
    assert snap["completed"] == 10 and snap["failed"] == 0
    assert snap["retries"] >= 1
    h1 = health[1]
    assert h1["failures"] >= 1 and h1["successes"] == 0
    assert snap["breaker_trips"] >= 1 and h1["state"] == "open"


@pytest.mark.parametrize("backend", BACKENDS)
def test_wedged_replica_times_out_and_retries(port_index, backend):
    """A hung dispatch does not block its batch: the attempt times out
    (0.75 s), the batch retries elsewhere, and the answers are the sync
    ones. The hang is finite (3 s) so the server's shutdown ends."""
    requests = _requests(6, seed=6)
    resps, snap, health = _serve(
        P.Retriever(port_index, backend=backend), requests,
        policy=PS.FaultPolicy({1: PS.FaultProfile(hang_p=1.0, hang_s=3.0)},
                              seed=0),
        cfg=PS.ResilienceConfig(seed=0, hedge=False, timeout_floor_s=0.75,
                                timeout_ceil_s=0.75,
                                breaker_cooldown_s=30.0),
    )
    assert snap["completed"] == 6 and snap["failed"] == 0
    assert snap["timeouts"] >= 1 and snap["retries"] >= 1
    assert health[1]["timeouts"] >= 1
    solo = P.Retriever(port_index, backend=backend)
    for resp, req in zip(resps, requests):
        np.testing.assert_array_equal(resp.doc_ids, solo.search(req).doc_ids)


@pytest.mark.parametrize("backend", BACKENDS)
def test_breaker_trips_and_recovers_under_flap(port_index, backend):
    """Flapping replica: the breaker OPENS during a bad run and CLOSES
    again through a half-open probe during a good one. The reference's
    36-request burst is sent in waves, a pause longer than the cooldown
    between them, until both happened (at most 20): the port's dispatches
    can finish a whole burst inside one cooldown. Both outcomes follow
    the flap's call indices and those pauses alone: no attempt times out
    (a host that stalls a search past a timeout would send the request
    down the degradation ladder), and a request may retry through a
    whole bad run (its 4 calls, the half-open probe included)."""
    requests = _requests(36, seed=7)
    retriever = P.Retriever(port_index, backend=backend)
    cfg = PS.ResilienceConfig(seed=0, hedge=False, breaker_cooldown_s=0.05,
                              backoff_base_s=0.001, timeout_floor_s=600.0,
                              timeout_ceil_s=600.0, max_retries=4,
                              retry_budget_cap=64.0)

    async def go():
        async with PS.SearchServer(
            retriever, window_s=0.002, max_batch=1, replicas=2,
            resilience=cfg,
            fault_policy=PS.FaultPolicy({1: PS.FaultProfile(flap_run=4)},
                                        seed=0),
        ) as server:
            waves = []
            for _ in range(20):
                waves.append(await asyncio.gather(
                    *(server.submit(r) for r in requests)))
                snap = server.stats.snapshot()
                if snap["breaker_trips"] and snap["breaker_recoveries"]:
                    break
                await asyncio.sleep(0.1)
            return waves, snap, server.pool.health_snapshot()

    waves, snap, health = asyncio.run(go())
    assert snap["completed"] == 36 * len(waves) and snap["failed"] == 0
    assert snap["breaker_trips"] >= 1
    assert snap["breaker_recoveries"] >= 1
    assert health[1]["trips"] >= 1 and health[1]["recoveries"] >= 1
    solo = P.Retriever(port_index, backend=backend)
    want = [solo.search(req).doc_ids for req in requests]
    for resps in waves:
        for resp, ids in zip(resps, want):
            np.testing.assert_array_equal(resp.doc_ids, ids)


@pytest.mark.parametrize("backend", BACKENDS)
def test_guaranteed_requests_fail_typed_never_degraded(port_index, backend):
    """Every replica erroring: min_recall / exact requests surface the
    typed ReplicaUnavailable — never a silently degraded answer."""
    requests = [
        P.SearchRequest(like=1, probes=6, k=5, min_recall=0.9),
        P.SearchRequest(like=2, probes=6, k=5),
        P.SearchRequest(like=3, k=5, exact=True),
    ]
    resps, snap, _ = _serve(
        P.Retriever(port_index, backend=backend), requests,
        policy=PS.FaultPolicy({0: PS.FaultProfile(error_p=1.0),
                               1: PS.FaultProfile(error_p=1.0)}, seed=0),
        cfg=PS.ResilienceConfig(seed=0, hedge=False, max_retries=1,
                                breaker_cooldown_s=0.01,
                                backoff_base_s=0.001),
        return_exceptions=True,
    )
    for r in resps:
        assert isinstance(r, PS.ReplicaUnavailable)
    assert snap["failed"] == 3 and snap["degraded"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_exhausted_retries_degrade_with_labels(port_index, backend):
    """Replica 0 fails its dispatch and no retry is allowed: the batch
    walks down the ladder (rescore dropped, probes stepped down) onto
    replica 1 and every answer comes back degraded=True with its labels,
    equal to synchronous search of the degraded request."""
    requests = _requests(4, seed=9, rescore=10)
    resps, snap, health = _serve(
        P.Retriever(port_index, backend=backend), requests,
        policy=PS.FaultPolicy({0: PS.FaultProfile(error_p=1.0)}, seed=0),
        cfg=PS.ResilienceConfig(seed=0, hedge=False, max_retries=0),
        max_batch=4,
    )
    assert snap["degraded"] == 4 and snap["failed"] == 0
    assert health[0]["failures"] == 1 and health[1]["successes"] == 1
    solo = P.Retriever(port_index, backend=backend)
    for resp, req in zip(resps, requests):
        assert resp.degraded
        assert resp.degradation == ("rescore:10->none", "probes:6->3")
        want = solo.search(P.SearchRequest(like=req.like, probes=3, k=5))
        np.testing.assert_array_equal(resp.doc_ids, want.doc_ids)


# --------------------------------------- property: degraded answers stay honest
def _check_degraded_invariants(core, serving, retriever, rung, probes,
                               rescore, seed):
    """Whatever rung a request is walked down, the degraded answer is a
    well-formed one: live distinct ids, field scores summing to the score,
    an honest n_scored, and a plan only ever cheaper, always audibly."""
    rng = np.random.default_rng(seed)
    req = core.SearchRequest(like=int(rng.integers(N_DOCS)), probes=probes,
                             rescore=rescore, k=8)
    shape = core.ExecShape("reference", probes, 8, rescore)
    t, kk = retriever.index.counts.shape
    degraded, labels = serving.degrade_request(
        req, shape, rung=rung, ladder=retriever.index.ladder,
        total_probes=int(t) * int(kk), n_clusterings=int(t))
    resp = retriever.search(degraded)
    assert len(resp.doc_ids) == len(set(int(i) for i in resp.doc_ids))
    for hit in resp.hits:
        assert 0 <= hit.doc_id < retriever.index.docs.shape[0]
        assert hit.score == pytest.approx(sum(hit.field_scores.values()),
                                          abs=1e-4)
    assert 0 < resp.n_scored <= retriever.index.docs.shape[0]
    if labels:
        assert degraded.probes <= req.probes
        assert (degraded.rescore or 0) <= (req.rescore or 0)
    else:
        assert rung == 0 or rescore is None
        if rung >= 2:
            assert probes <= 3
    return (degraded.probes, degraded.rescore, labels,
            [int(i) for i in resp.doc_ids], int(resp.n_scored))


@pytest.mark.parametrize("case", range(25))
def test_degraded_responses_keep_api_invariants(saved, port_index, case):
    """The reference's seeded sweep (its 25 cases when hypothesis is
    absent), on both packages: each keeps the invariants, and both walk
    the same plan to the same ids and n_scored."""
    rng = np.random.default_rng(case)
    args = dict(rung=int(rng.integers(0, 3)),
                probes=int(rng.integers(3, 13)),
                rescore=(None if rng.random() < 0.5
                         else int(rng.integers(8, 21))),
                seed=int(rng.integers(2**16)))
    got = [
        _check_degraded_invariants(
            core, serving, core.Retriever(idx, backend="reference"), **args)
        for core, serving, idx in ((R, RS, saved[0]), (P, PS, port_index))
    ]
    assert got[0] == got[1]
