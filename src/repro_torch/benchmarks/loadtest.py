"""Serving-tier load test on the port: open/closed-loop generators, QPS +
p50/p99 (port of ``benchmarks/loadtest.py``)::

    PYTHONPATH=src python -m repro_torch.benchmarks.loadtest --scale ts2 \
        [--replicas 2] [--chaos] [--device cpu] [--out PATH]

The benchmark of the async micro-batching front
(:mod:`repro_torch.serving`). Three measurements over the SAME
heterogeneous request mix (per-request Dirichlet weights, mixed ``(k,
probes)`` execution shapes — the paper's dynamic per-user setting):

``sequential``
    The baseline without the serving tier: one-by-one ``Retriever.search``
    on a fresh facade — every request pays a full engine dispatch alone.
``closed``
    Closed loop: ``concurrency`` workers, each submitting its next request
    only after its previous one completes. The headline is achieved QPS
    against the sequential baseline.
``open``
    Open loop: requests arrive on a fixed-rate schedule whatever the
    completions (``--rate``, default 0.8x the closed-loop QPS), with the
    latency split plus expiry/rejection counts when a ``--deadline-ms``
    budget or the queue bound bites.

Latencies are the per-request server-stamped split (``queue_wait_s`` /
``compute_s``), so the p99 decomposes into "waited for the window/queue"
and "rode a batch through the engine". On the card the backend is
``fused`` (the CUDA ``bucket_score_tiled`` kernel), each replica on its own
CUDA stream; every entry carries the device's name (``cpu`` for a CPU run,
which measures PyTorch's CPU kernels, not the card). The JSON goes to
stdout's summary and to ``--out`` (default the git-ignored
``src/repro_torch/benchmarks/_results/loadtest[_chaos]_<scale>.json``),
never to the reference's ``BENCH_query.json``.

``--chaos`` swaps the throughput loops for the fault-injection acceptance
suite: the same closed-loop mix replayed against a fresh server per named
fault profile (:data:`repro_torch.serving.FAULT_PROFILES`), hard-checking
that every submit resolves, non-degraded answers are id-identical to the
synchronous path, ``exact``/``min_recall`` requests are never silently
degraded, the circuit breaker trips AND recovers under flapping, and the
wedged-replica profiles keep the p99 within 3x the fault-free run.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import sys
import time

import numpy as np
import torch

from ..core import Retriever, SearchRequest, split_probes
from ..kernels.common import resolve_device
from ..launch.serve import build_retriever
from ..serving import (
    FAULT_PROFILES,
    DeadlineExceeded,
    FaultPolicy,
    Overloaded,
    ReplicaUnavailable,
    ResilienceConfig,
    SearchServer,
)
from .common import card_line, write_json

__all__ = ["MIX_SHAPES", "LOADTEST_SIZES", "CHAOS_PROFILES", "make_mix",
           "chaos_mix", "clear_rows", "sequential_baseline", "closed_loop",
           "open_loop", "serve_loops", "chaos_suite", "run", "run_chaos",
           "main"]

# Heterogeneous execution-shape mix: most traffic at the default operating
# point, a minority shape (deeper k, tighter budget) riding alongside —
# enough to exercise per-shape queues without shattering every batch.
MIX_SHAPES = (
    {"k": 10, "probes": 12},
    {"k": 10, "probes": 12},
    {"k": 10, "probes": 12},
    {"k": 20, "probes": 8},
)

LOADTEST_SIZES = {
    "quick": {"n_docs": 4_000, "n_requests": 192},
    "ts1": {"n_docs": 20_000, "n_requests": 1_024},
    "ts2": {"n_docs": 50_000, "n_requests": 2_048},
}

CHAOS_PROFILES = ("transient", "slow", "flap", "storm", "hang_flap")


def device_name(dev: torch.device) -> str:
    """What every entry is labelled with: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def make_mix(n_docs: int, spec, n: int, seed: int = 0,
             backend: str | None = None) -> list[SearchRequest]:
    """n unique more-like-this requests cycling through MIX_SHAPES (the
    reference's draws: the same seed gives the same requests)."""
    rng = np.random.default_rng(seed)
    qids = rng.choice(n_docs, size=min(n, n_docs), replace=False)
    w = rng.dirichlet([1.0] * spec.s, size=n).astype(np.float32)
    return [
        SearchRequest(
            like=int(qids[i % len(qids)]),
            weights=dict(zip(spec.names, map(float, w[i]))),
            backend=backend,
            **MIX_SHAPES[i % len(MIX_SHAPES)],
        )
        for i in range(n)
    ]


def chaos_mix(n_docs: int, spec, n: int, seed: int = 0
              ) -> list[SearchRequest]:
    """The chaos suite's mix: :func:`make_mix` with every 16th request a
    guard — a recall floor the ladder can honour, which must be served at
    full fidelity or fail typed, NEVER silently degraded."""
    requests = make_mix(n_docs, spec, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(0, len(requests), 16):
        requests[i] = SearchRequest(like=int(rng.integers(n_docs)),
                                    k=MIX_SHAPES[0]["k"], probes=12,
                                    min_recall=0.85)
    return requests


def clear_rows(retriever: Retriever, requests, answers) -> np.ndarray:
    """Rows whose answer no fp32 summation order can change, as a bool
    mask: a synchronous top-(k+1) keeps gaps above 1e-5, and at the budget
    each answer was served at, every clustering's probe boundary keeps a
    leader-score gap above 1e-6 (in float64). A batch formed by the server
    holds other rows than a synchronous one, so its navigation matmul may
    round otherwise; elsewhere near-tied ids or probes may swap."""
    deep = retriever.search([dataclasses.replace(r, k=r.k + 1)
                             for r in requests])
    index = retriever.index
    t, kc = (int(x) for x in index.counts.shape)
    qw = retriever._resolve_qw(list(requests)).double()
    lead = torch.sort(torch.einsum("tkd,qd->qtk", index.leaders.double(), qw),
                      dim=-1, descending=True).values.cpu().numpy()
    out = np.zeros(len(requests), bool)
    for i, (d, a) in enumerate(zip(deep, answers)):
        s = d.scores[np.isfinite(d.scores)]
        ok = bool(np.all(-np.diff(s) > 1e-5))
        if a.probes < t * kc:
            for ti, p in enumerate(split_probes(a.probes, t)):
                ok &= not (0 < p < kc
                           and lead[i, ti, p - 1] - lead[i, ti, p] <= 1e-6)
        out[i] = ok
    return out


def _quantiles(xs) -> tuple[float, float]:
    """(p50, p99) in milliseconds."""
    if not len(xs):
        return 0.0, 0.0
    a = np.asarray(xs, np.float64) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


# ------------------------------------------------------------------ baselines
def sequential_baseline(retriever: Retriever,
                        requests: list[SearchRequest]) -> dict:
    """One-by-one synchronous search: the no-serving-tier reference (each
    search waits for its stream, so the host clock times device work)."""
    lat = []
    t_start = time.perf_counter()
    for req in requests:
        t0 = time.perf_counter()
        retriever.search(req)
        lat.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_start
    p50, p99 = _quantiles(lat)
    return {
        "mode": "sequential",
        "n_requests": len(requests),
        "qps": round(len(requests) / wall, 2),
        "p50_ms": round(p50, 3),
        "p99_ms": round(p99, 3),
    }


# ------------------------------------------------------------ loop generators
async def closed_loop(server: SearchServer, requests: list[SearchRequest],
                      concurrency: int,
                      deadline_s: float | None = None) -> dict:
    """Fixed-concurrency workers, next request only after the last answer."""
    results: list = []
    errors = {"expired": 0, "rejected": 0}
    cursor = iter(requests)
    t_start = time.perf_counter()

    async def worker():
        for req in cursor:
            try:
                resp = await server.submit(req, deadline_s=deadline_s)
                results.append(resp)
            except DeadlineExceeded:
                errors["expired"] += 1
            except Overloaded:
                errors["rejected"] += 1

    await asyncio.gather(
        *(worker() for _ in range(min(concurrency, len(requests))))
    )
    wall = time.perf_counter() - t_start
    return _loop_report("closed", results, errors, wall,
                        concurrency=concurrency)


async def open_loop(server: SearchServer, requests: list[SearchRequest],
                    rate_qps: float,
                    deadline_s: float | None = None) -> dict:
    """Fixed arrival rate: submit on schedule, completions be damned."""
    results: list = []
    errors = {"expired": 0, "rejected": 0}
    loop = asyncio.get_running_loop()

    async def one(req):
        try:
            results.append(await server.submit(req, deadline_s=deadline_s))
        except DeadlineExceeded:
            errors["expired"] += 1
        except Overloaded:
            errors["rejected"] += 1

    t_start = time.perf_counter()
    t0 = loop.time()
    tasks = []
    for i, req in enumerate(requests):
        delay = (t0 + i / rate_qps) - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(one(req)))
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t_start
    return _loop_report("open", results, errors, wall, rate_qps=rate_qps)


def _loop_report(mode: str, results, errors, wall, **extra) -> dict:
    lat = [r.latency_s for r in results]
    qwait = [r.queue_wait_s for r in results]
    comp = [r.compute_s for r in results]
    batch = [r.batch_size for r in results]
    p50, p99 = _quantiles(lat)
    qw50, qw99 = _quantiles(qwait)
    c50, c99 = _quantiles(comp)
    return {
        "mode": mode,
        "n_requests": len(results) + sum(errors.values()),
        "completed": len(results),
        "qps": round(len(results) / wall, 2) if wall > 0 else 0.0,
        "p50_ms": round(p50, 3),
        "p99_ms": round(p99, 3),
        "queue_wait_p50_ms": round(qw50, 3),
        "queue_wait_p99_ms": round(qw99, 3),
        "compute_p50_ms": round(c50, 3),
        "compute_p99_ms": round(c99, 3),
        "mean_batch": round(float(np.mean(batch)), 2) if batch else 0.0,
        "expired": errors["expired"],
        "rejected": errors["rejected"],
        **extra,
    }


# ------------------------------------------------------------ chaos harness
# The fault-injection acceptance run (``--chaos``): the SAME closed-loop mix
# per named fault profile, with hard checks — every submit resolves (answer
# or typed failure, nothing blocks), every completed non-degraded response
# is id-identical to the synchronous path, degraded answers are stamped and
# their recall cost measured, the breaker trips AND recovers under
# flapping, and the hang profiles keep the closed-loop p99 within 3x the
# fault-free run (with a one-cold-timeout absolute floor so a noisy
# fault-free p50 cannot flake the ratio).


def _chaos_knobs(comp_p99_s: float, seed: int):
    """Derive the chaos timeout/hang knobs from observed healthy compute
    (the reference's rule): the fault-free profile runs first, effectively
    timeout-free, and its CONTENDED compute p99 sizes everything else — the
    timeout floor at that p99 (honest-but-slow is never a fault), the
    ceiling at 3x it, the injected hang at 2x the ceiling (a wedged call
    always overshoots the timeout), and the p99 acceptance floor at one
    ceiling + retry."""
    floor_s = max(0.05, comp_p99_s)
    ceil_s = max(0.75, 3.0 * comp_p99_s)
    cfg = ResilienceConfig(
        timeout_floor_s=floor_s, timeout_ceil_s=ceil_s,
        breaker_cooldown_s=0.5, backoff_base_s=0.005, seed=seed,
    )
    return cfg, max(2.0, 2.0 * ceil_s)


def _chaos_policy(profile: str, seed: int, hang_s: float) -> FaultPolicy:
    """Named profile with its hang duration rescaled to the platform."""
    profiles = {
        idx: (dataclasses.replace(p, hang_s=hang_s) if p.hang_p else p)
        for idx, p in FAULT_PROFILES[profile].items()
    }
    return FaultPolicy(profiles, seed=seed, name=profile)


async def chaos_closed_loop(server: SearchServer,
                            requests: list[SearchRequest],
                            concurrency: int) -> tuple[dict, dict, float]:
    """Closed loop that keeps per-request identity and typed failures:
    ``(results, errors, wall)`` with ``results[i]`` the response for
    ``requests[i]`` (completed ones only) and ``errors`` counting typed
    failures — under chaos a typed failure is an ACCEPTABLE outcome,
    silence is not."""
    results: dict[int, object] = {}
    errors = {"expired": 0, "rejected": 0, "unavailable": 0}
    cursor = iter(enumerate(requests))
    t_start = time.perf_counter()

    async def worker():
        for i, req in cursor:
            try:
                results[i] = await server.submit(req)
            except DeadlineExceeded:
                errors["expired"] += 1
            except ReplicaUnavailable:
                errors["unavailable"] += 1
            except Overloaded:
                errors["rejected"] += 1

    await asyncio.gather(
        *(worker() for _ in range(min(concurrency, len(requests))))
    )
    return results, errors, time.perf_counter() - t_start


def _warm_shapes(retriever: Retriever, requests) -> list[SearchRequest]:
    """One request of each execution shape in the mix."""
    seen: dict = {}
    for req in requests:
        seen.setdefault(retriever.exec_shape(req), req)
    return list(seen.values())


async def _chaos_profile_run(retriever, requests, *, profile, cfg, policy,
                             concurrency, window_s, replicas,
                             max_queue_depth, max_batch=8) -> dict:
    """One profile through a fresh server: warmup, measure, snapshot.
    ``max_batch`` is capped low on purpose: fault handling is per
    DISPATCH, and a server that coalesces the whole closed loop into three
    giant batches gives the breaker/retry/hedge machinery almost nothing to
    act on."""
    async with SearchServer(
        retriever, window_s=window_s, replicas=replicas,
        max_batch=max_batch, max_queue_depth=max_queue_depth,
        resilience=cfg, fault_policy=policy,
    ) as server:
        # Warm each shape twice through the live (possibly faulty) pool:
        # seeds the per-shape compute p99 the timeout/hedge policy is
        # derived from.
        for req in _warm_shapes(retriever, requests):
            warm = [req] * min(server.max_batch, len(requests))
            for _ in range(2):
                await asyncio.gather(
                    *(server.submit(r) for r in warm),
                    return_exceptions=True,  # typed failures ok in warmup
                )
        for rep in server.pool.replicas:
            rep._flush_request_caches()
        results, errors, wall = await chaos_closed_loop(
            server, requests, concurrency
        )
        stats = server.stats.snapshot()
        health = server.pool.health_snapshot()
    lat = [r.latency_s for r in results.values()]
    p50, p99 = _quantiles(lat)
    return {
        "mode": "chaos",
        "profile": profile,
        "n_requests": len(requests),
        "completed": len(results),
        "qps": round(len(results) / wall, 2) if wall > 0 else 0.0,
        "p50_ms": round(p50, 3),
        "p99_ms": round(p99, 3),
        "wall_s": round(wall, 2),
        **errors,
        "retries": stats["retries"],
        "timeouts": stats["timeouts"],
        "hedges": stats["hedges"],
        "hedge_wins": stats["hedge_wins"],
        "degraded": stats["degraded"],
        "budget_exhausted": stats["budget_exhausted"],
        "breaker_trips": stats["breaker_trips"],
        "breaker_recoveries": stats["breaker_recoveries"],
        "_results": results,
        "_health": health,
    }


def _chaos_verify(entry: dict, requests, expected,
                  p99_free_ms: float | None, clear=None) -> dict:
    """Apply the hard acceptance checks (``SystemExit`` on a violation);
    fold parity/recall into ``entry``. ``clear`` (a :func:`clear_rows`
    mask) limits the parity check to rows free of near ties; None checks
    every row, as the reference does."""
    profile = entry["profile"]
    results = entry.pop("_results")
    health = entry.pop("_health")
    entry["breaker_states"] = {h["idx"]: h["state"] for h in health}
    entry["replica_dispatches"] = {
        h["idx"]: f"{h['successes']}ok/{h['failures']}fail[{h['state']}]"
        for h in health
    }
    n = len(requests)
    resolved = entry["completed"] + sum(
        entry[key] for key in ("expired", "rejected", "unavailable")
    )
    if resolved != n:
        raise SystemExit(
            f"[chaos:{profile}] {n - resolved} of {n} submits vanished — "
            f"every request must resolve to an answer or a typed failure"
        )
    parity_bad, guard_degraded = 0, 0
    deg_recall: list[float] = []
    labels: dict[str, int] = {}
    for i, resp in results.items():
        want = expected[i]
        if resp.degraded:
            if requests[i].min_recall is not None or requests[i].exact:
                guard_degraded += 1
            got = set(map(int, resp.doc_ids))
            truth = set(map(int, want.doc_ids))
            deg_recall.append(len(got & truth) / max(1, len(truth)))
            for lab in resp.degradation:
                key = lab.split(":", 1)[0]
                labels[key] = labels.get(key, 0) + 1
        elif (clear is None or clear[i]) and (
                list(resp.doc_ids) != list(want.doc_ids)
                or not np.allclose(resp.scores, want.scores,
                                   rtol=1e-5, atol=1e-6)):
            parity_bad += 1
    if parity_bad:
        raise SystemExit(
            f"[chaos:{profile}] {parity_bad} non-degraded responses differ "
            f"from the synchronous path — retries/hedging may change "
            f"latency, never answers"
        )
    if guard_degraded:
        raise SystemExit(
            f"[chaos:{profile}] {guard_degraded} exact/min_recall responses "
            f"came back degraded=True — guaranteed requests must fail "
            f"typed, never silently downgrade"
        )
    if profile in ("flap", "hang_flap"):
        if not (entry["breaker_trips"] >= 1
                and entry["breaker_recoveries"] >= 1):
            raise SystemExit(
                f"[chaos:{profile}] breaker did not trip AND recover under "
                f"flapping (trips={entry['breaker_trips']}, "
                f"recoveries={entry['breaker_recoveries']}); half-open "
                f"probing is broken"
            )
    if profile in ("hang", "hang_flap") and p99_free_ms:
        # 3x the fault-free p99, floored at one cold attempt-timeout +
        # retry (the bound a single wedged dispatch can cost a request)
        bound_ms = max(3.0 * p99_free_ms,
                       1e3 * entry["timeout_ceil_s"] + 250.0)
        if entry["p99_ms"] > bound_ms:
            raise SystemExit(
                f"[chaos:{profile}] closed-loop p99 {entry['p99_ms']:.0f} ms "
                f"exceeds the bound {bound_ms:.0f} ms "
                f"(fault-free p99 {p99_free_ms:.0f} ms)"
            )
        entry["p99_vs_fault_free"] = round(
            entry["p99_ms"] / p99_free_ms, 2
        )
    entry["parity_violations"] = 0
    entry["degraded_recall_mean"] = (
        round(float(np.mean(deg_recall)), 3) if deg_recall else None
    )
    entry["degradation_kinds"] = labels
    return entry


def chaos_suite(retriever: Retriever, requests: list[SearchRequest], *,
                seed: int = 0, concurrency: int = 32,
                window_s: float = 0.002, replicas: int = 4,
                max_queue_depth: int = 256,
                profiles=CHAOS_PROFILES) -> list[dict]:
    """The fault-free pass, then each named profile through a fresh
    fault-injected server over ``retriever``'s index, every entry held to
    :func:`_chaos_verify`'s checks against one synchronous batched pass on
    a fresh calibrated facade, on the rows :func:`clear_rows` keeps.
    Raises ``SystemExit`` listing every failed check."""
    base = Retriever(retriever.index, backend=retriever.backend,
                     default_probes=retriever.default_probes,
                     calibrate=True)
    expected = base.search(requests)
    clear = clear_rows(base, requests, expected)
    print(f"chaos parity on {int(clear.sum())}/{len(requests)} rows free "
          f"of near ties")
    retriever._flush_request_caches()

    async def _all():
        # Fault-free pass first, with an effectively-unbounded timeout (a
        # cold first dispatch must read as slow, not faulty): it is the
        # parity/latency reference, and its compute p99 sizes the chaos
        # timeout knobs for the fault runs.
        free = await _chaos_profile_run(
            retriever, requests, profile="none",
            cfg=ResilienceConfig(seed=seed, timeout_floor_s=60.0,
                                 timeout_ceil_s=60.0, hedge=False),
            policy=None,
            concurrency=concurrency, window_s=window_s, replicas=replicas,
            max_queue_depth=max_queue_depth,
        )
        comp = [r.compute_s for r in free["_results"].values()]
        comp_p99 = float(np.percentile(comp, 99)) if comp else 1.0
        cfg, hang_s = _chaos_knobs(comp_p99, seed)
        print(f"chaos knobs from fault-free compute p99 "
              f"{comp_p99 * 1e3:.1f} ms: timeout ceiling "
              f"{cfg.timeout_ceil_s:.2f} s, injected hang {hang_s:.1f} s")
        entries = [free]
        for profile in profiles:
            entries.append(await _chaos_profile_run(
                retriever, requests, profile=profile, cfg=cfg,
                policy=_chaos_policy(profile, seed, hang_s),
                concurrency=concurrency, window_s=window_s,
                replicas=replicas, max_queue_depth=max_queue_depth,
            ))
        for entry in entries:
            entry["timeout_ceil_s"] = (
                None if entry["profile"] == "none" else cfg.timeout_ceil_s
            )
        return entries

    entries = asyncio.run(_all())
    p99_free_ms = entries[0]["p99_ms"]
    failures = []
    for entry in entries:
        try:
            _chaos_verify(entry, requests, expected,
                          None if entry["profile"] == "none"
                          else p99_free_ms, clear)
        except SystemExit as e:
            failures.append(str(e))
        extra = ""
        if entry.get("degraded"):
            extra = (f", degraded={entry['degraded']} "
                     f"(recall {entry.get('degraded_recall_mean')})")
        print(f"chaos[{entry['profile']:>9}]: {entry['qps']:7.1f} QPS, "
              f"p50/p99 {entry['p50_ms']:6.1f}/{entry['p99_ms']:7.1f} ms, "
              f"retries={entry['retries']} timeouts={entry['timeouts']} "
              f"hedges={entry['hedges']}/{entry['hedge_wins']} "
              f"trips={entry['breaker_trips']}/"
              f"{entry['breaker_recoveries']} "
              f"unavailable={entry['unavailable']}{extra}")
        if "replica_dispatches" in entry:
            print(f"      replicas: {entry['replica_dispatches']}")
    if failures:
        raise SystemExit("\n".join(failures))
    print("chaos: all profiles passed parity, honesty, breaker and p99 "
          "checks")
    return entries


def run_chaos(scale: str = "quick", seed: int = 0, *, backend: str = "auto",
              device=None, concurrency: int = 32, window_s: float = 0.002,
              replicas: int = 4, max_queue_depth: int = 256, profiles=None,
              n_docs: int | None = None,
              n_requests: int | None = None) -> list[dict]:
    """Chaos acceptance run: build one calibrated index, then
    :func:`chaos_suite` over every named fault profile. A run that returns
    has shown no lost submits, no silent wrong answers, no silent
    downgrades of guaranteed requests, breaker trip + recovery under
    flapping, and a bounded p99 with a wedged replica in the pool."""
    sz = LOADTEST_SIZES[scale]
    n_docs = n_docs or sz["n_docs"]
    n_requests = n_requests or sz["n_requests"]
    dev = resolve_device(device)
    retriever, _, spec = build_retriever(
        n_docs, backend=backend, seed=seed, calibrate=True, device=dev,
    )
    requests = chaos_mix(n_docs, spec, n_requests, seed=seed)
    labels = {"backend": retriever.backend, "device": device_name(dev)}
    print(f"\n# Chaos loadtest — fault-injected serving acceptance "
          f"(n={n_docs}, {n_requests} requests, {replicas} replicas, "
          f"backend={labels['backend']}, device={labels['device']})")
    entries = chaos_suite(
        retriever, requests, seed=seed, concurrency=concurrency,
        window_s=window_s, replicas=replicas,
        max_queue_depth=max_queue_depth,
        profiles=tuple(profiles or CHAOS_PROFILES),
    )
    for e in entries:
        e.update(labels)
    return entries


# ----------------------------------------------------------------- the runner
async def serve_loops(retriever, requests, *, concurrency=64, rate_qps=None,
                      window_s=0.002, replicas=1, max_queue_depth=256,
                      deadline_s=None, modes=("closed", "open")
                      ) -> list[dict]:
    """The closed and/or open loop through one server over ``retriever``
    (each shape warmed at a full ``max_batch`` first, the request caches
    flushed before every mode), then the server's stats."""
    out = []
    async with SearchServer(
        retriever, window_s=window_s, replicas=replicas,
        max_queue_depth=max_queue_depth,
    ) as server:
        for req in _warm_shapes(retriever, requests):
            warm = [req] * min(server.max_batch, len(requests))
            await asyncio.gather(*(server.submit(r) for r in warm))

        def flush_caches():
            # the warmup (and each measured mode) answers requests FROM the
            # mix: flush the facade caches so the next mode's answers come
            # from the engine, not memoisation
            for replica in server.pool.replicas:
                replica._flush_request_caches()

        flush_caches()
        if "closed" in modes:
            entry = await closed_loop(server, requests, concurrency,
                                      deadline_s)
            entry.update(window_ms=window_s * 1e3,
                         max_batch=server.max_batch, replicas=replicas)
            out.append(entry)
        if "open" in modes:
            flush_caches()
            closed_qps = next(
                (e["qps"] for e in out if e["mode"] == "closed"), None
            )
            rate = rate_qps or (
                round(0.8 * closed_qps, 1) if closed_qps else 100.0
            )
            entry = await open_loop(server, requests, rate, deadline_s)
            entry.update(window_ms=window_s * 1e3,
                         max_batch=server.max_batch, replicas=replicas)
            out.append(entry)
        out_stats = server.stats.snapshot()
    out.append({"mode": "server_stats", "replicas": replicas, **out_stats})
    return out


def run(scale: str = "quick", seed: int = 0, *, backend: str = "auto",
        device=None, pack_dtype: str | None = None, concurrency: int = 64,
        rate_qps: float | None = None, window_s: float = 0.002,
        replicas: int = 1, max_queue_depth: int = 256,
        deadline_s: float | None = None, n_docs: int | None = None,
        n_requests: int | None = None,
        modes=("closed", "open")) -> list[dict]:
    """Build, load-test, return entries labelled with the backend, the
    device's name and the pack dtype."""
    sz = LOADTEST_SIZES[scale]
    n_docs = n_docs or sz["n_docs"]
    n_requests = n_requests or sz["n_requests"]
    dev = resolve_device(device)
    retriever, _, spec = build_retriever(
        n_docs, backend=backend, seed=seed, pack_dtype=pack_dtype,
        device=dev,
    )
    requests = make_mix(n_docs, spec, n_requests, seed=seed)
    labels = {"backend": retriever.backend, "device": device_name(dev),
              "pack_dtype": pack_dtype or "float32"}
    print(f"\n# Loadtest — async serving tier vs sequential baseline "
          f"(n={n_docs}, {n_requests} requests, backend={labels['backend']}, "
          f"pack_dtype={labels['pack_dtype']}, device={labels['device']})")

    # Sequential baseline on a FRESH facade: the served retriever's
    # request/response caches must not answer for the engine. Its warm-up
    # also makes a fused pack too large to make at build time.
    base = Retriever(retriever.index, backend=retriever.backend,
                     default_probes=retriever.default_probes)
    for req in _warm_shapes(base, requests):
        base.search(req)
    base._flush_request_caches()
    seq = sequential_baseline(base, requests)
    print(f"sequential: {seq['qps']:.1f} QPS, "
          f"p50/p99 {seq['p50_ms']:.1f}/{seq['p99_ms']:.1f} ms")

    entries = asyncio.run(serve_loops(
        retriever, requests, concurrency=concurrency, rate_qps=rate_qps,
        window_s=window_s, replicas=replicas,
        max_queue_depth=max_queue_depth, deadline_s=deadline_s,
        modes=modes,
    ))
    for e in entries:
        if e["mode"] == "closed":
            e["speedup_vs_sequential"] = round(e["qps"] / seq["qps"], 2)
        print(format_entry(e))
    entries.insert(0, seq)
    for e in entries:
        e.update(labels)
    return entries


def format_entry(e: dict) -> str:
    """One printed line for a closed- or open-loop entry."""
    if e["mode"] == "closed":
        speedup = e.get("speedup_vs_sequential")
        return (f"closed-loop (c={e['concurrency']}, {e['replicas']} "
                f"replica(s)): {e['qps']:.1f} QPS"
                + (f" ({speedup:.2f}x sequential)" if speedup else "")
                + f", p50/p99 {e['p50_ms']:.1f}/{e['p99_ms']:.1f} ms "
                f"(wait {e['queue_wait_p50_ms']:.1f}/"
                f"{e['queue_wait_p99_ms']:.1f}, compute "
                f"{e['compute_p50_ms']:.1f}/{e['compute_p99_ms']:.1f}), "
                f"mean batch {e['mean_batch']:.1f}")
    if e["mode"] == "open":
        return (f"open-loop ({e['rate_qps']:.1f} QPS offered, "
                f"{e['replicas']} replica(s)): {e['qps']:.1f} achieved, "
                f"p50/p99 {e['p50_ms']:.1f}/{e['p99_ms']:.1f} ms (wait "
                f"{e['queue_wait_p50_ms']:.1f}/{e['queue_wait_p99_ms']:.1f},"
                f" compute {e['compute_p50_ms']:.1f}/"
                f"{e['compute_p99_ms']:.1f}), mean batch "
                f"{e['mean_batch']:.1f}, expired={e['expired']} "
                f"rejected={e['rejected']}")
    return f"server stats ({e['replicas']} replica(s)): {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", default="quick", choices=list(LOADTEST_SIZES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="JSON path (default: benchmarks/_results/"
                         "loadtest[_chaos]_<scale>.json in the package)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--chaos", action="store_true",
                    help="run the fault-injection acceptance suite instead "
                         "of the throughput loops: every named fault "
                         "profile through a fresh fault-injected server, "
                         "checking parity, degradation honesty, breaker "
                         "trip+recovery and the hang-profile p99 bound "
                         "(exit 1 on any violation)")
    ap.add_argument("--profiles", default=",".join(CHAOS_PROFILES),
                    help="--chaos: comma-separated fault profile names")
    ap.add_argument("--pack-dtype", default=None,
                    choices=[None, "float32", "bfloat16", "int8"],
                    help="bucket-major storage precision the fused backend "
                         "serves from")
    ap.add_argument("--docs", type=int, default=None,
                    help="override the scale's corpus size")
    ap.add_argument("--requests", type=int, default=None,
                    help="override the scale's request count")
    ap.add_argument("--concurrency", type=int, default=64,
                    help="closed-loop worker count")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate in QPS (default: 0.8x the "
                         "measured closed-loop QPS)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="micro-batch window")
    ap.add_argument("--replicas", type=int, default=1,
                    help="dispatch replicas (one CUDA stream each)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (exercises expiry under "
                         "open-loop overload)")
    ap.add_argument("--mode", default="both",
                    choices=("closed", "open", "both"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.chaos:
        entries = run_chaos(
            args.scale, args.seed, backend=args.backend, device=dev,
            concurrency=min(args.concurrency, 32),
            window_s=args.window_ms / 1e3,
            replicas=max(args.replicas, 4),
            profiles=tuple(p for p in args.profiles.split(",") if p),
            n_docs=args.docs, n_requests=args.requests)
    else:
        modes = ("closed", "open") if args.mode == "both" else (args.mode,)
        entries = run(
            args.scale, args.seed, backend=args.backend, device=dev,
            pack_dtype=(None if args.pack_dtype in (None, "float32")
                        else args.pack_dtype),
            concurrency=args.concurrency, rate_qps=args.rate,
            window_s=args.window_ms / 1e3, replicas=args.replicas,
            deadline_s=(None if args.deadline_ms is None
                        else args.deadline_ms / 1e3),
            n_docs=args.docs, n_requests=args.requests, modes=modes)
    write_json({
        "experiment": "loadtest_chaos" if args.chaos else "loadtest",
        "scale": args.scale, "seed": args.seed, "device": str(dev),
        "card": card_line(dev), "torch": torch.__version__,
        "cuda": torch.version.cuda, "entries": entries,
    }, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
