"""The async serving front: SearchServer event loop + ReplicaPool dispatch
(port of :mod:`repro.serving.server`).

:class:`SearchServer` is the piece that finally lets concurrent traffic
reach the batched kernel at its efficient batch sizes. One asyncio task
(the serving loop) owns all scheduling state; device work never runs on
the event loop:

    submit() ── exec_shape ──► ShapeQueue (per shape)      [batcher]
                   │               │ window elapses OR batch hits the
                   │               │ query-tile multiple
            admission policy       ▼
            (bounded queue,   flush_order (earliest deadline first)
             priority shed)        │                      [scheduler]
                   │               ▼
              Overloaded      ReplicaPool.acquire ──► executor thread
              DeadlineExceeded     │ breaker-gated,   ONE Retriever.search
                                   │ lowest-EWMA      per attempt
                                   ▼
                        timeout ► retry on a DIFFERENT replica  [health]
                        stuck past p99 ► hedge onto a free one
                        budget dry ► degrade down the ladder
                                   │
                                   ▼
                       SearchResponse (queue_wait_s / compute_s stamped,
                                       degraded=True when downgraded)

:class:`ReplicaPool` fans dispatch over N read-only :class:`Retriever`
facades sharing ONE index (engines and the bucket-major pack are cached on
the index itself, so replicas cost a facade, not a copy). Each replica
owns a CUDA stream on the index's device and runs its searches on it (the
kernels launch on the calling thread's current stream), so two replicas'
batches overlap one's host work with the other's device work; on the CPU
the stream is None. The pool is health-aware: each replica carries a :class:`~repro_torch.serving.health.
ReplicaHealth` record (EWMA latency, circuit breaker, lag), selection
prefers the fastest closed-circuit free replica and skips open circuits
until their half-open probe window. Single-process today; the pool's
acquire/release + health surface is the seam a multi-host tier replaces
with remote replicas later.

Every blocking engine call runs through ``loop.run_in_executor`` on a
thread pool sized to the replica count — safe even under faults, because
any executor call (primary, retry, hedge) holds a replica lease, and a
timed-out call KEEPS its lease until the thread actually returns (an
executor future cannot be cancelled; releasing a wedged replica early
would hand its thread-less slot to a new dispatch). A
:class:`~repro_torch.serving.faults.FaultPolicy` installed on the server wraps
each replica's callable with deterministic fault injection — the chaos
harness (``python -m repro_torch.benchmarks.loadtest --chaos``) drives
exactly this seam.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import itertools
import random
import time

import torch

from ..core.api import ExecShape, Retriever, SearchRequest, SearchResponse
from .batcher import Batcher
from .health import ReplicaHealth, ResilienceConfig, RetryBudget, degrade_batch
from .scheduler import (
    DeadlineExceeded,
    Overloaded,
    ReplicaUnavailable,
    Scheduler,
    ServingError,
    Ticket,
)
from .stats import ServerStats

__all__ = ["SearchServer", "ReplicaPool", "Replica", "default_max_batch"]

# Deterministic caller errors (bad input surfaced inside the engine call):
# retrying these on another replica can only reproduce them, so the batch
# fails immediately with the original message instead of burning retries.
_NON_RETRYABLE = (ValueError, TypeError, KeyError, IndexError)


def _engine_query_tile(retriever: Retriever) -> int | None:
    """The fused kernel's query tile for this retriever, or None when the
    serving backend does not tile (reference). The CUDA kernel's tile is
    16 at every shape (:func:`~repro_torch.kernels.bucket_score.ops.
    pick_query_tile`), so there is no memory budget to size it from: the
    ``sharded`` backend runs the same kernel on each shard, and its
    shard-local block ``B_l``, from which the reference sizes its tile,
    changes nothing (16 again, so ``default_max_batch`` stays 64)."""
    if retriever.backend not in ("fused", "sharded"):
        return None
    opt = retriever.engine_opts.get("query_tile")
    if opt:
        return int(opt)
    from ..kernels.bucket_score.ops import pick_query_tile
    from ..kernels.common import pad_to

    index = retriever.index
    itemsize = {"bfloat16": 2, "int8": 1}.get(index.pack_dtype or "float32", 4)
    # k varies per request; size the tile for the default k=10 padded to
    # the sublane multiple — max_batch is a flush trigger, not a contract.
    return pick_query_tile(
        int(index.docs.shape[-1]), int(index.buckets.shape[-1]),
        k_pad=pad_to(10, 8), pack_itemsize=itemsize,
    )


def default_max_batch(retriever: Retriever, floor: int = 64) -> int:
    """Size-flush trigger: >= ``floor`` requests, rounded UP to a multiple
    of the fused engine's query tile so a size-triggered flush dispatches
    full query tiles (non-tiling backends just use the floor)."""
    qt = _engine_query_tile(retriever)
    if not qt:
        return floor
    return max(qt, -(-floor // qt) * qt)


class Replica:
    """One dispatch endpoint: a retriever facade, its CUDA stream and its
    health record.

    ``call`` is the dispatchable search callable — the facade's
    ``search`` by default, or the fault-injected wrapper when a
    :class:`~repro_torch.serving.faults.FaultPolicy` is installed (the
    chaos harness's seam); :meth:`run` calls it on ``stream``. ``busy``
    marks an outstanding lease.
    """

    __slots__ = ("idx", "retriever", "health", "call", "busy", "stream")

    def __init__(
        self, idx: int, retriever: Retriever,
        config: ResilienceConfig | None = None,
    ):
        self.idx = idx
        self.retriever = retriever
        self.health = ReplicaHealth(idx, config)
        self.call = retriever.search
        self.busy = False
        dev = retriever.index.docs.device
        self.stream = None
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(device=dev)
            # whatever the creating thread queued (the build, the pack)
            # comes before this replica's first search
            self.stream.wait_stream(torch.cuda.current_stream(dev))

    def run(self, requests):
        """``call(requests)`` on this replica's stream. The current stream
        is per thread, so this runs inside the executor thread."""
        with torch.cuda.stream(self.stream):
            return self.call(requests)


class ReplicaPool:
    """N read-only retriever facades over ONE index, leased per dispatch.

    Replicas share the index (and with it every cached engine and the
    bucket-major pack); each gets its own facade so per-facade state
    (request/response caches, plan cache) is never contended across
    threads. Lazy calibration is disabled on replicas — the index's ladder
    is fitted (or not) once, by the primary, not raced by N threads.

    Selection is health-aware: among free replicas, the fastest (lowest
    EWMA latency) whose circuit is CLOSED wins; when only tripped
    circuits are free, one whose cooldown has elapsed is admitted as the
    half-open probe. ``exclude`` lets a retry skip the replicas that
    already failed its batch; :meth:`acquire` softens the exclusion after
    one wait cycle so a 1-replica pool (or a fully-excluded one) still
    makes progress rather than deadlocking.
    """

    def __init__(
        self,
        retriever: Retriever,
        n_replicas: int = 1,
        *,
        config: ResilienceConfig | None = None,
        fault_policy=None,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.config = config or ResilienceConfig()
        self.primary = retriever
        facades = [retriever] + [
            Retriever(
                retriever.index,
                backend=retriever.backend,
                default_probes=retriever.default_probes,
                engine_opts=retriever.engine_opts,
            )
            for _ in range(n_replicas - 1)
        ]
        self.entries: list[Replica] = [
            Replica(i, r, self.config) for i, r in enumerate(facades)
        ]
        self.fault_policy = fault_policy
        if fault_policy is not None:
            for e in self.entries:
                e.call = fault_policy.wrap(e.idx, e.retriever.search)
        self._event: asyncio.Event | None = None
        self.on_release = None     # server hook: a lease returned

    @property
    def replicas(self) -> list[Retriever]:
        return [e.retriever for e in self.entries]

    def __len__(self) -> int:
        return len(self.entries)

    def idle_count(self) -> int:
        """Free leases (breaker state not considered — this is the serving
        loop's flush-capacity gate, not the selection policy)."""
        return sum(1 for e in self.entries if not e.busy)

    def health_snapshot(self, now: float | None = None) -> list[dict]:
        """Per-replica health view (EWMA/lag/breaker/counters). ``now``
        defaults to ``time.monotonic()`` — the same clock asyncio's
        default loop stamps ``busy_since`` with."""
        if now is None:
            now = time.monotonic()
        return [e.health.snapshot(now) for e in self.entries]

    # ------------------------------------------------------------- selection
    def _pick(
        self, now: float, exclude: frozenset, probe_ok: bool = True
    ) -> Replica | None:
        free = [
            e for e in self.entries if not e.busy and e.idx not in exclude
        ]
        if not free:
            return None
        # A half-open trial is a gamble: its failure costs the batch a
        # retry. With the retry budget dry (probe_ok=False) a failed
        # trial would strand the batch, so gamble only when a closed
        # replica exists nowhere in the pool (then somebody must probe
        # or the pool deadlocks).
        allow_trial = probe_ok or not any(
            e.health.breaker.state == "closed" for e in self.entries
        )
        if allow_trial:
            # A cooled-down open breaker gets the next dispatch as its
            # half-open trial even when healthy replicas are free —
            # waiting for the pool to be saturated would leave an open
            # breaker open forever under light load. One in-flight trial
            # at a time (``allow`` claims the slot); a failed trial
            # re-opens and the retry path re-runs the batch on a healthy
            # replica.
            for e in free:
                if (e.health.breaker.state != "closed"
                        and e.health.breaker.would_allow(now)):
                    return e
        closed = [e for e in free if e.health.breaker.state == "closed"]
        if closed:
            # Rank by recent consecutive failures FIRST, EWMA latency
            # second. Failures never update the EWMA, so a replica that
            # has only ever failed keeps ewma=None — ranking on EWMA
            # alone would keep a sub-threshold flapping replica
            # permanently preferred (None reads as "fast unknown").
            return min(
                closed,
                key=lambda e: (
                    e.health.breaker.consecutive,
                    e.health.ewma_latency_s
                    if e.health.ewma_latency_s is not None else 0.0,
                ),
            )
        return None

    def try_acquire(
        self, now: float, exclude: frozenset = frozenset(),
        probe_ok: bool = True,
    ) -> Replica | None:
        """Non-blocking lease (hedges use this: a hedge only fires onto a
        replica that is free RIGHT NOW — it never queues for one)."""
        e = self._pick(now, exclude, probe_ok)
        if e is None:
            return None
        e.health.breaker.allow(now)    # commit the half-open probe claim
        e.busy = True
        e.health.busy_since = now
        return e

    async def acquire(
        self,
        *,
        exclude: frozenset = frozenset(),
        timeout_s: float | None = None,
        probe_ok: bool = True,
    ) -> Replica | None:
        """Lease a replica, waiting for a release or a breaker cooldown.

        Returns None when ``timeout_s`` elapses first (the caller's
        tickets ran out of deadline). The exclusion softens after one
        wait cycle — retrying "on a different replica" yields to making
        progress when no different replica exists.
        """
        loop = asyncio.get_running_loop()
        deadline = None if timeout_s is None else loop.time() + timeout_s
        exclude = frozenset(exclude)
        soften = False
        while True:
            if self._event is None:
                self._event = asyncio.Event()
            self._event.clear()
            now = loop.time()
            e = self.try_acquire(now, exclude, probe_ok)
            if e is None and soften and exclude:
                e = self.try_acquire(now, frozenset(), probe_ok)
            if e is not None:
                return e
            # wait for a release; cap the nap so an elapsing breaker
            # cooldown (which fires no event) is noticed promptly
            wait = 0.05
            if deadline is not None:
                wait = min(wait, deadline - now)
                if wait <= 0:
                    return None
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._event.wait(), wait)
            soften = True

    def release(self, replica: Replica) -> None:
        replica.busy = False
        replica.health.busy_since = None
        if self._event is not None:
            self._event.set()
        if self.on_release is not None:
            self.on_release()


class SearchServer:
    """Asyncio micro-batching front over one :class:`Retriever`.

    ::

        async with SearchServer(retriever, window_s=0.002) as server:
            resp = await server.submit(
                SearchRequest(like=7, k=10), deadline_s=0.05, priority=1
            )

    Knobs (see ROADMAP "Architecture: serving tier" / "Architecture:
    fault tolerance" for the full tables):

    ``window_s``
        Micro-batch window: the hard bound on how long the oldest queued
        request of a shape waits before its queue must flush.
    ``max_batch``
        Size-flush trigger and drain cap per dispatch. Defaults to
        :func:`default_max_batch` — at least 64, rounded up to a multiple
        of the fused engine's query tile (16: 64 on every pack).
    ``max_queue_depth`` / ``shed_low_priority``
        Backpressure: each shape queue is bounded; a full queue rejects
        with :class:`Overloaded`, or (default) sheds its lowest-priority
        waiter when the newcomer outranks it.
    ``default_deadline_s``
        Deadline applied to submits that don't carry their own (None =
        requests without a deadline never expire).
    ``replicas``
        Dispatch parallelism (:class:`ReplicaPool` size).
    ``resilience``
        The :class:`~repro_torch.serving.health.ResilienceConfig` knob bag —
        per-shape dispatch timeouts, retry/backoff/budget, hedging,
        breaker thresholds and the degradation ladder. Defaults on.
    ``fault_policy``
        Optional :class:`~repro_torch.serving.faults.FaultPolicy` wrapping each
        replica with deterministic fault injection (chaos harness only).
    ``log_interval_s``
        When set, a background task prints one ``[serving]`` stats line
        (counters + wait/compute/latency p50/p99 + queue depths) at this
        period.
    """

    def __init__(
        self,
        retriever: Retriever,
        *,
        window_s: float = 0.002,
        max_batch: int | None = None,
        max_queue_depth: int = 256,
        shed_low_priority: bool = True,
        default_deadline_s: float | None = None,
        replicas: int = 1,
        resilience: ResilienceConfig | None = None,
        fault_policy=None,
        log_interval_s: float | None = None,
    ):
        self.retriever = retriever
        self.config = resilience or ResilienceConfig()
        self.pool = ReplicaPool(
            retriever, replicas, config=self.config, fault_policy=fault_policy
        )
        self.batcher = Batcher(
            window_s=window_s,
            max_batch=(
                default_max_batch(retriever) if max_batch is None
                else int(max_batch)
            ),
        )
        self.stats = ServerStats()
        self.scheduler = Scheduler(
            max_queue_depth=max_queue_depth,
            shed_low_priority=shed_low_priority,
            on_expired=lambda _t: self.stats.record_expired(),
        )
        self.retry_budget = RetryBudget(
            ratio=self.config.retry_budget_ratio,
            cap=self.config.retry_budget_cap,
        )
        self.default_deadline_s = default_deadline_s
        self.log_interval_s = log_interval_s
        self._rng = random.Random(self.config.seed)   # backoff jitter
        self._seq = itertools.count()
        self._wake: asyncio.Event | None = None
        self._loop_task: asyncio.Task | None = None
        self._log_task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        self._acquiring = 0     # dispatches created but not yet holding a lease
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._running = False
        self._draining = False
        t, k_clusters = retriever.index.counts.shape
        self._n_clusterings = int(t)
        self._total_probes = int(t) * int(k_clusters)

    @property
    def max_batch(self) -> int:
        return self.batcher.max_batch

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> "SearchServer":
        if self._running:
            raise RuntimeError("server already started")
        self._running = True
        self._draining = False
        self._wake = asyncio.Event()
        self.pool.on_release = self._on_release
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=len(self.pool), thread_name_prefix="repro-serve"
        )
        self._loop_task = asyncio.create_task(self._run())
        if self.log_interval_s is not None:
            self._log_task = asyncio.create_task(self._log_loop())
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop serving. ``drain=True`` (default) flushes every queued
        request through the engine first (windows are ignored — shutdown
        is the flush); ``drain=False`` fails queued requests with
        :class:`Overloaded`. In-flight dispatches always complete."""
        if not self._running:
            return
        if not drain:
            for q in self.batcher.nonempty():
                for t in q.drain(len(q)):
                    if t.fail(Overloaded("server stopped before dispatch")):
                        self.stats.record_rejected()
        self._draining = True
        self._running = False
        if self._wake is not None:
            self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        while self._inflight:
            pending = tuple(self._inflight)
            self._inflight.difference_update(pending)
            await asyncio.gather(*pending, return_exceptions=True)
        if self._log_task is not None:
            self._log_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._log_task
            self._log_task = None
        if self._executor is not None:
            # waits for wedged threads too: fault profiles keep hangs finite
            self._executor.shutdown(wait=True)
            self._executor = None

    async def __aenter__(self) -> "SearchServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=True)

    # ------------------------------------------------------------ submission
    async def submit(
        self,
        request: SearchRequest,
        *,
        deadline_s: float | None = None,
        priority: int = 0,
    ) -> SearchResponse:
        """Enqueue one request and await its response.

        Raises :class:`Overloaded` when the shape's bounded queue refuses
        admission, :class:`DeadlineExceeded` when the deadline passes
        before the request's batch is dispatched (deadlines bound queue
        time — a dispatched batch always completes and returns late
        rather than wasting the device work; deadlines also bound RETRY
        time, a faulted batch stops retrying for tickets past theirs),
        :class:`ReplicaUnavailable` when every replica failed within the
        retry budget and the request refused degradation.
        """
        if not self._running:
            raise RuntimeError(
                "server is not running (use `async with SearchServer(...)` "
                "or await server.start())"
            )
        loop = asyncio.get_running_loop()
        now = loop.time()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        deadline = None if deadline_s is None else now + deadline_s
        if deadline is not None and deadline <= now:
            self.stats.record_expired()
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} already expired at submission"
            )
        shape = self.retriever.exec_shape(request)
        ticket = Ticket(
            request=request,
            shape=shape,
            future=loop.create_future(),
            t_enqueue=now,
            deadline=deadline,
            priority=priority,
            seq=next(self._seq),
        )
        try:
            victim = self.scheduler.admit(self.batcher.queue(shape), ticket)
        except Overloaded:
            self.stats.record_rejected()
            raise
        if victim is not None:
            self.stats.record_shed()
        self.stats.record_submit()
        self._wake.set()
        return await ticket.future

    # ---------------------------------------------------------- serving loop
    async def _run(self) -> None:
        # One invariant keeps batching adaptive under load: a queue is only
        # DRAINED when a dispatch slot is free to take it. While every
        # replica is busy, due queues keep accumulating — so batch sizes
        # grow exactly when the system is saturated, instead of freezing at
        # whatever the window caught and parking small batches in a line.
        # Capacity counts FREE LEASES, not in-flight tasks: a retrying
        # dispatch can hold leases while a wedged replica holds one with no
        # task at all (late release) — the pool knows, the task set doesn't.
        loop = asyncio.get_running_loop()
        while True:
            now = loop.time()
            self.scheduler.expire(self.batcher.nonempty(), now)
            capacity = self.pool.idle_count() - self._acquiring
            if capacity > 0:
                ready = self.batcher.ready(now, flush_all=self._draining)
                for q in self.scheduler.flush_order(ready)[:capacity]:
                    tickets = q.drain(self.batcher.max_batch)
                    if tickets:
                        self._acquiring += 1
                        task = asyncio.create_task(self._dispatch(tickets))
                        self._inflight.add(task)
                        task.add_done_callback(self._dispatch_done)
            if self._draining and not self.batcher.pending():
                return
            if capacity <= 0:
                # no free lease: nothing to do until one returns (release
                # hook wakes us) or a submit lands
                timeout = None
            elif self._draining:
                timeout = 0.0      # shutdown ignores windows: keep flushing
            else:
                due = self.batcher.next_due()
                timeout = (
                    None if due is None else max(0.0, due - loop.time())
                )
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    def _dispatch_done(self, task: asyncio.Task) -> None:
        self._inflight.discard(task)
        if self._wake is not None:
            self._wake.set()

    def _on_release(self) -> None:
        if self._wake is not None:
            self._wake.set()       # a lease returned: flush-gate opens

    # -------------------------------------------------------------- dispatch
    def _prune_expired(self, live: list[Ticket], now: float) -> list[Ticket]:
        """Fail tickets whose deadline passed before/between attempts
        (deadlines bound queue AND retry time, never a running attempt)."""
        dead = [t for t in live if t.expired(now)]
        if not dead:
            return live
        for t in dead:
            if t.fail(
                DeadlineExceeded(
                    f"deadline passed before the batch reached a healthy "
                    f"replica (waited {now - t.t_enqueue:.4f}s)"
                )
            ):
                self.stats.record_expired()
        return [t for t in live if not t.expired(now)]

    def _degrade(
        self, requests: list[SearchRequest], shape: ExecShape, rung: int
    ):
        """health.degrade_batch with this server's index context plugged in."""
        return degrade_batch(
            requests,
            shape,
            rung=rung,
            ladder=self.retriever.index.ladder,
            total_probes=self._total_probes,
            n_clusterings=self._n_clusterings,
            relax_floors=self.config.relax_floors,
        )

    def _discard_late(self, fut, replica: Replica) -> None:
        """A timed-out (or outraced) executor call cannot be cancelled:
        keep the replica's lease until its thread actually returns, then
        release. The late result/exception is retrieved and discarded."""
        def _done(f, replica=replica):
            with contextlib.suppress(BaseException):
                f.exception()
            self.pool.release(replica)
        fut.add_done_callback(_done)

    async def _attempt(
        self,
        shape: ExecShape,
        requests: list[SearchRequest],
        replica: Replica,
        timeout: float,
        hedge_after: float | None,
        exclude: set,
    ):
        """One dispatch attempt, optionally hedged.

        Returns ``(status, payload, failed_idxs)``: ``("ok", (responses,
        compute_s), failed)`` on success (from whichever dispatch answered
        first), ``("error", last_exc, failed)`` when every launched call
        raised, ``("timeout", last_exc, failed)`` when the attempt timeout
        elapsed with calls still outstanding (their leases release late).
        Health/breaker recording for every launched replica happens here.
        """
        loop = asyncio.get_running_loop()
        procs: list[tuple] = []    # (future, replica, t0, order)

        def launch(rep: Replica) -> None:
            f = loop.run_in_executor(self._executor, rep.run, requests)
            procs.append((f, rep, loop.time(), len(procs)))

        launch(replica)
        deadline = loop.time() + timeout
        hedge_at = None if hedge_after is None else loop.time() + hedge_after
        failed: set[int] = set()
        last_exc: Exception | None = None
        while procs:
            now = loop.time()
            if now >= deadline:
                break
            step = deadline if hedge_at is None else min(deadline, hedge_at)
            done, _ = await asyncio.wait(
                {p[0] for p in procs},
                timeout=max(0.0, step - now),
                return_when=asyncio.FIRST_COMPLETED,
            )
            now = loop.time()
            if done:
                for f in done:
                    entry = next(p for p in procs if p[0] is f)
                    procs.remove(entry)
                    _, rep, t0, order = entry
                    exc = f.exception()
                    if exc is None:
                        dt = now - t0
                        if rep.health.record_success(now, dt):
                            self.stats.record_breaker_recovery()
                        self.retry_budget.on_success()
                        self.stats.record_shape_compute(shape, dt)
                        self.pool.release(rep)
                        if order > 0:
                            self.stats.record_hedge_win()
                        for lf, lrep, _lt0, _lo in procs:
                            self._discard_late(lf, lrep)
                        return ("ok", (f.result(), dt), failed)
                    last_exc = exc
                    if rep.health.record_failure(now):
                        self.stats.record_breaker_trip()
                    self.pool.release(rep)
                    failed.add(rep.idx)
                    if isinstance(exc, _NON_RETRYABLE):
                        for lf, lrep, _lt0, _lo in procs:
                            self._discard_late(lf, lrep)
                        return ("error", exc, failed)
                continue
            if hedge_at is not None and now >= hedge_at:
                hedge_at = None
                busy = {p[1].idx for p in procs}
                hrep = self.pool.try_acquire(
                    now, frozenset(exclude | failed | busy)
                )
                if hrep is not None and self.retry_budget.try_spend():
                    self.stats.record_hedge()
                    launch(hrep)
                elif hrep is not None:
                    self.pool.release(hrep)
                    self.stats.record_budget_exhausted()
        if procs:   # attempt timeout: every outstanding call is written off
            now = loop.time()
            for f, rep, _t0, _o in procs:
                self.stats.record_timeout()
                if rep.health.record_failure(now, timed_out=True):
                    self.stats.record_breaker_trip()
                failed.add(rep.idx)
                self._discard_late(f, rep)
            return ("timeout", last_exc, failed)
        return ("error", last_exc, failed)

    async def _dispatch(self, tickets: list[Ticket]) -> None:
        """One flushed batch through the resilient dispatch path."""
        loop = asyncio.get_running_loop()
        cfg = self.config
        leased_once = False
        try:
            live = self._prune_expired(list(tickets), loop.time())
            if not live:
                return
            shape = live[0].shape
            originals = [t.request for t in live]
            requests = list(originals)
            labels: list[tuple] = [() for _ in live]
            rung = 0

            # overload degradation: the shape's queue is STILL past the
            # high-water mark after this drain — walk degradable requests
            # one rung down so the backlog burns down faster; guaranteed
            # requests ride at full fidelity (overload alone never fails
            # them, that is what shedding/Overloaded is for)
            if cfg.degrade_highwater is not None:
                depth = len(self.batcher.queue(shape))
                if depth >= cfg.degrade_highwater * self.scheduler.max_queue_depth:
                    requests, labels, _refused = self._degrade(
                        originals, shape, 1
                    )
                    rung = 1

            attempt = 0
            tried: set[int] = set()
            last_exc: Exception | None = None
            result = None
            while True:
                now = loop.time()
                kept = self._prune_expired(live, now)
                if len(kept) < len(live):
                    keep_ids = {id(t) for t in kept}
                    rows = [
                        i for i, t in enumerate(live) if id(t) in keep_ids
                    ]
                    live = kept
                    originals = [originals[i] for i in rows]
                    requests = [requests[i] for i in rows]
                    labels = [labels[i] for i in rows]
                if not live:
                    return
                min_dl = min(
                    (t.deadline for t in live if t.deadline is not None),
                    default=None,
                )
                acq_timeout = (
                    None if min_dl is None else max(0.0, min_dl - now)
                )
                replica = await self.pool.acquire(
                    exclude=frozenset(tried), timeout_s=acq_timeout,
                    # dry budget: a failed half-open trial could not be
                    # retried, so don't volunteer this batch as one
                    probe_ok=self.retry_budget.tokens >= 1.0,
                )
                if not leased_once:
                    leased_once = True
                    self._acquiring -= 1
                if replica is None:
                    continue    # deadlines passed while waiting: prune above
                p99 = self.stats.shape_p99(shape)
                timeout = cfg.attempt_timeout(p99)
                hedge_after = None
                if (
                    cfg.hedge and attempt == 0 and p99 is not None
                    and len(self.pool) > 1
                ):
                    hedge_after = max(1e-4, cfg.hedge_mult * p99)
                    if hedge_after >= timeout:
                        hedge_after = None
                status, payload, failed = await self._attempt(
                    shape, requests, replica, timeout, hedge_after, tried
                )
                attempt += 1
                tried |= failed
                if status == "ok":
                    result = payload
                    break
                if payload is not None:
                    last_exc = payload
                if isinstance(last_exc, _NON_RETRYABLE):
                    # deterministic input error: retrying reproduces it
                    err = ServingError(
                        f"dispatch failed for shape {tuple(shape)}: "
                        f"{last_exc!r}"
                    )
                    for t in live:
                        t.fail(err)
                    self.stats.record_failed(len(live))
                    return
                if len(tried) >= len(self.pool):
                    tried = set()   # every replica seen: allow re-tries
                can_retry = (attempt - 1) < cfg.max_retries
                if can_retry:
                    if self.retry_budget.try_spend():
                        self.stats.record_retry()
                        delay = cfg.backoff(attempt, self._rng.random())
                        now = loop.time()
                        if min_dl is not None:
                            delay = min(delay, max(0.0, min_dl - now))
                        if delay > 0:
                            await asyncio.sleep(delay)
                        continue
                    self.stats.record_budget_exhausted()
                # retries (or budget) exhausted: degrade instead of another
                # round of duplicated device work
                if rung < cfg.max_degrade_rung:
                    rung = cfg.max_degrade_rung
                    requests, labels, refused = self._degrade(
                        originals, shape, rung
                    )
                    if refused:
                        err = ReplicaUnavailable(
                            f"no healthy replica served shape {tuple(shape)} "
                            f"within the retry budget, and exact=/min_recall= "
                            f"requests refuse degradation (last error: "
                            f"{last_exc!r})"
                        )
                        gone = set(refused)
                        for i in sorted(gone):
                            live[i].fail(err)
                        self.stats.record_failed(len(gone))
                        live = [t for i, t in enumerate(live) if i not in gone]
                        originals = [
                            r for i, r in enumerate(originals) if i not in gone
                        ]
                        requests = [
                            r for i, r in enumerate(requests) if i not in gone
                        ]
                        labels = [
                            l for i, l in enumerate(labels) if i not in gone
                        ]
                        if not live:
                            return
                    attempt = 0
                    tried = set()
                    continue
                err = ReplicaUnavailable(
                    f"dispatch for shape {tuple(shape)} failed on every "
                    f"replica within the retry budget, even degraded "
                    f"(last error: {last_exc!r})"
                )
                for t in live:
                    t.fail(err)
                self.stats.record_failed(len(live))
                return

            responses, compute = result
            t_done = loop.time()
            waits = []
            n_degraded = 0
            for t, resp, lab in zip(live, responses, labels):
                wait = max(0.0, (t_done - t.t_enqueue) - compute)
                waits.append(wait)
                if lab:
                    n_degraded += 1
                    resp = dataclasses.replace(
                        resp,
                        degraded=True,
                        degradation=tuple(lab),
                        queue_wait_s=wait,
                        compute_s=compute,
                        latency_s=wait + compute,
                    )
                else:
                    resp = dataclasses.replace(
                        resp,
                        queue_wait_s=wait,
                        compute_s=compute,
                        latency_s=wait + compute,
                    )
                t.resolve(resp)
            if n_degraded:
                self.stats.record_degraded(n_degraded)
            self.stats.record_batch(waits, compute)
        finally:
            if not leased_once:
                self._acquiring -= 1

    async def _log_loop(self) -> None:
        while True:
            await asyncio.sleep(self.log_interval_s)
            print("[serving] " + self.stats.format_line(
                self.batcher.depths()
            ))
