"""repro_torch.serving — async micro-batching serving tier over the
Retriever (port of :mod:`repro.serving`, the same modules and names).

The engine's batched path (the query-tiled ``bucket_score_tiled`` CUDA
kernel, one HBM read per shared bucket per tile) is only fast when requests
reach it *in batches* —
but real traffic is concurrent single requests. This package is the
mechanism between the two: an asyncio front-end that accumulates incoming
:class:`~repro_torch.core.SearchRequest` objects in per-execution-shape queues
(:func:`~repro_torch.core.exec_shape` — the same ``(backend, probes, k,
rescore)`` grouping ``Retriever.search`` applies to a synchronous batch),
flushes each queue when its micro-batch window elapses or it reaches a
query-tile multiple, and dispatches one engine call per flush on a replica
thread, on that replica's own CUDA stream — with deadline scheduling, priority-aware load shedding under
bounded-queue backpressure, and an honest per-request latency split
(``queue_wait_s`` vs ``compute_s``) on every response.

Layout (policy/mechanism/loop kept separate, each independently testable):

    batcher.py    per-shape FIFOs; window-or-size flush readiness
    scheduler.py  typed failures + admission/expiry/ordering policy
    server.py     SearchServer event loop, ReplicaPool, executor dispatch
    stats.py      counters, batch-size histogram, p50/p99 wait/compute split
    health.py     circuit breaker, retry budget, EWMA health, degradation
    faults.py     deterministic fault injection (the chaos harness's seam)

The tier is fault-tolerant by default: per-shape dispatch timeouts derived
from observed p99 compute, retries on a different replica under capped
jittered backoff and a token-bucket retry budget, hedged dispatch for
batches stuck past the shape's p99, a per-replica circuit breaker, and a
degradation ladder (drop rescore, step probes down a calibrated rung)
that answers ``degraded=True`` instead of shedding — while ``exact=``/
``min_recall=`` requests fail typed (:class:`ReplicaUnavailable`) rather
than ever being silently downgraded. Tune it all through
:class:`ResilienceConfig`; chaos-test it with ``python -m
repro_torch.benchmarks.loadtest --chaos``.

Copy-paste usage::

    import asyncio
    from repro_torch.core import Retriever, SearchRequest
    from repro_torch.serving import SearchServer, DeadlineExceeded, Overloaded

    retriever = Retriever.build(docs, spec, k_clusters=64)   # on the card

    async def main():
        async with SearchServer(
            retriever,
            window_s=0.002,       # micro-batch window: 2 ms
            max_queue_depth=256,  # backpressure bound per shape queue
            replicas=2,           # parallel dispatch slots
        ) as server:
            try:
                resp = await server.submit(
                    SearchRequest(like=7, k=10),
                    deadline_s=0.05,  # fail fast if still queued at 50 ms
                    priority=1,       # outranks priority-0 under shedding
                )
                print(resp.ids, resp.queue_wait_s, resp.compute_s)
            except DeadlineExceeded:
                ...               # expired in queue — engine never ran
            except Overloaded:
                ...               # rejected or shed: back off and retry
            print(server.stats.format_line())

    asyncio.run(main())

Load-test the tier with ``python -m repro_torch.benchmarks.loadtest``
(open/closed loop, heterogeneous mixes, QPS + p50/p99 into the git-ignored
``src/repro_torch/benchmarks/_results/``) or drive it end to end with
``python -m repro_torch.launch.serve --serve``.
"""

from .batcher import Batcher, ShapeQueue
from .faults import FAULT_PROFILES, FaultPolicy, FaultProfile, InjectedFault
from .health import (
    CircuitBreaker,
    ReplicaHealth,
    ResilienceConfig,
    RetryBudget,
    degrade_batch,
    degrade_request,
)
from .scheduler import (
    DeadlineExceeded,
    Overloaded,
    ReplicaUnavailable,
    Scheduler,
    ServingError,
    Ticket,
)
from .server import Replica, ReplicaPool, SearchServer, default_max_batch
from .stats import ServerStats

__all__ = [
    "SearchServer",
    "ReplicaPool",
    "Replica",
    "default_max_batch",
    "Batcher",
    "ShapeQueue",
    "Scheduler",
    "Ticket",
    "ServingError",
    "DeadlineExceeded",
    "Overloaded",
    "ReplicaUnavailable",
    "ServerStats",
    "ResilienceConfig",
    "CircuitBreaker",
    "RetryBudget",
    "ReplicaHealth",
    "degrade_request",
    "degrade_batch",
    "FaultPolicy",
    "FaultProfile",
    "FAULT_PROFILES",
    "InjectedFault",
]
