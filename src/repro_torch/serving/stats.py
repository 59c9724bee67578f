"""Serving-tier observability: counters, histograms, latency percentiles
(port of :mod:`repro.serving.stats`).

A serving p99 is only honest when it is split into its two components —
how long a request *waited* to be batched (queue pressure, window sizing)
vs how long its batch *computed* (engine speed, batch efficiency). The
:class:`SearchResponse` latency fields carry that split per request
(``queue_wait_s`` / ``compute_s``); this module aggregates them across the
server's lifetime:

- admission counters (submitted / completed / expired / rejected / shed),
- a batch-size histogram (IS micro-batching actually reaching the engine's
  efficient batch sizes, or are windows flushing singletons?),
- bounded latency reservoirs with p50/p99 for queue-wait, compute and
  end-to-end latency,
- per-shape queue depth (sampled at snapshot time from the live batcher).

Everything is exposed two ways: :meth:`ServerStats.snapshot` returns a
plain dict (responses/benchmarks persist it), and
:meth:`ServerStats.format_line` renders the one-line periodic log the
server emits when constructed with ``log_interval_s``.
"""

from __future__ import annotations

import collections
from typing import Mapping

import numpy as np

__all__ = ["ServerStats", "percentile_ms"]

# Reservoir cap: 4096 floats per series keeps worst-case stats memory at a
# few hundred KB while p50/p99 over the most recent window stay meaningful.
_RESERVOIR = 4096


def percentile_ms(xs, q: float) -> float:
    """q-th percentile of a seconds-series, in milliseconds (0.0 if empty)."""
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q) * 1e3)


class ServerStats:
    """Aggregate serving statistics (single event loop — no locking).

    All mutation happens on the server's event loop thread; readers
    (`snapshot`, the periodic log) run there too, so plain attributes are
    safe. The latency series are bounded deques: long-running servers keep
    a sliding window of the most recent ~4k requests per series.
    """

    def __init__(self, reservoir: int = _RESERVOIR):
        self.submitted = 0       # tickets admitted into a queue
        self.completed = 0       # responses delivered
        self.expired = 0         # failed fast with DeadlineExceeded
        self.rejected = 0        # refused admission with Overloaded
        self.shed = 0            # evicted from a full queue by priority
        self.failed = 0          # dispatch raised (engine/search error)
        self.batches = 0         # engine dispatches
        # fault-tolerance counters (repro_torch.serving.health wiring)
        self.retries = 0         # re-dispatches after a failed attempt
        self.timeouts = 0        # dispatch attempts that hit their timeout
        self.hedges = 0          # speculative duplicate dispatches fired
        self.hedge_wins = 0      # hedges that answered before the primary
        self.degraded = 0        # responses served down the ladder
        self.breaker_trips = 0   # circuits opened
        self.breaker_recoveries = 0  # circuits closed by a half-open probe
        self.budget_exhausted = 0    # retries refused by the token bucket
        self.batch_sizes: collections.Counter = collections.Counter()
        self._queue_wait: collections.deque = collections.deque(
            maxlen=reservoir
        )
        self._compute: collections.deque = collections.deque(maxlen=reservoir)
        self._latency: collections.deque = collections.deque(maxlen=reservoir)
        # per-exec-shape compute reservoirs: the observed-p99 source the
        # dispatcher derives per-shape timeouts and hedge delays from
        # (smaller cap — there is one deque per distinct shape)
        self._shape_compute: dict = {}
        self._shape_reservoir = min(512, reservoir)

    # ------------------------------------------------------------- recording
    def record_submit(self) -> None:
        self.submitted += 1

    def record_rejected(self) -> None:
        self.rejected += 1

    def record_shed(self, n: int = 1) -> None:
        self.shed += n

    def record_expired(self, n: int = 1) -> None:
        self.expired += n

    def record_failed(self, n: int = 1) -> None:
        self.failed += n

    def record_retry(self) -> None:
        self.retries += 1

    def record_timeout(self) -> None:
        self.timeouts += 1

    def record_hedge(self) -> None:
        self.hedges += 1

    def record_hedge_win(self) -> None:
        self.hedge_wins += 1

    def record_degraded(self, n: int = 1) -> None:
        self.degraded += n

    def record_breaker_trip(self) -> None:
        self.breaker_trips += 1

    def record_breaker_recovery(self) -> None:
        self.breaker_recoveries += 1

    def record_budget_exhausted(self) -> None:
        self.budget_exhausted += 1

    def record_batch(self, queue_waits, compute_s: float) -> None:
        """One dispatched batch: per-request waits + the shared compute."""
        n = len(queue_waits)
        self.batches += 1
        self.completed += n
        self.batch_sizes[n] += 1
        for w in queue_waits:
            self._queue_wait.append(w)
            self._latency.append(w + compute_s)
        self._compute.append(compute_s)

    def record_shape_compute(self, shape, compute_s: float) -> None:
        """One successful dispatch attempt's compute, keyed by exec shape."""
        series = self._shape_compute.get(shape)
        if series is None:
            series = self._shape_compute[shape] = collections.deque(
                maxlen=self._shape_reservoir
            )
        series.append(compute_s)

    def shape_p99(self, shape) -> float | None:
        """Observed p99 compute (seconds) for a shape, None before any
        dispatch of it completed — the timeout/hedge-delay input."""
        series = self._shape_compute.get(shape)
        if not series:
            return None
        return float(
            np.percentile(np.asarray(series, np.float64), 99)
        )

    # ------------------------------------------------------------- reporting
    @property
    def mean_batch_size(self) -> float:
        total = sum(n * c for n, c in self.batch_sizes.items())
        count = sum(self.batch_sizes.values())
        return total / count if count else 0.0

    def snapshot(
        self, queue_depths: Mapping | None = None
    ) -> dict:
        """Plain-dict view (benchmark persistence, response surfaces)."""
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "expired": self.expired,
            "rejected": self.rejected,
            "shed": self.shed,
            "failed": self.failed,
            "batches": self.batches,
            "retries": self.retries,
            "timeouts": self.timeouts,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "degraded": self.degraded,
            "breaker_trips": self.breaker_trips,
            "breaker_recoveries": self.breaker_recoveries,
            "budget_exhausted": self.budget_exhausted,
            "mean_batch_size": round(self.mean_batch_size, 2),
            "batch_size_hist": {
                int(n): int(c) for n, c in sorted(self.batch_sizes.items())
            },
            "queue_wait_ms": {
                "p50": round(percentile_ms(self._queue_wait, 50), 3),
                "p99": round(percentile_ms(self._queue_wait, 99), 3),
            },
            "compute_ms": {
                "p50": round(percentile_ms(self._compute, 50), 3),
                "p99": round(percentile_ms(self._compute, 99), 3),
            },
            "latency_ms": {
                "p50": round(percentile_ms(self._latency, 50), 3),
                "p99": round(percentile_ms(self._latency, 99), 3),
            },
            "queue_depth": {
                str(shape): int(depth)
                for shape, depth in (queue_depths or {}).items()
            },
        }

    def format_line(self, queue_depths: Mapping | None = None) -> str:
        """The periodic one-line log: counters + split percentiles + depths."""
        s = self.snapshot(queue_depths)
        depths = (
            " depth=" + ",".join(
                f"{k}:{v}" for k, v in s["queue_depth"].items()
            )
            if s["queue_depth"] else ""
        )
        faults = ""
        if (
            s["retries"] or s["timeouts"] or s["hedges"] or s["degraded"]
            or s["breaker_trips"]
        ):
            faults = (
                f"retries={s['retries']} timeouts={s['timeouts']} "
                f"hedges={s['hedges']}/{s['hedge_wins']} "
                f"degraded={s['degraded']} "
                f"trips={s['breaker_trips']}/{s['breaker_recoveries']} "
            )
        return (
            f"served={s['completed']}/{s['submitted']} "
            f"batches={s['batches']} (mean {s['mean_batch_size']:.1f}) "
            f"expired={s['expired']} rejected={s['rejected']} "
            f"shed={s['shed']} failed={s['failed']} {faults}| "
            f"wait p50/p99 {s['queue_wait_ms']['p50']:.2f}/"
            f"{s['queue_wait_ms']['p99']:.2f} ms, "
            f"compute {s['compute_ms']['p50']:.2f}/"
            f"{s['compute_ms']['p99']:.2f} ms, "
            f"latency {s['latency_ms']['p50']:.2f}/"
            f"{s['latency_ms']['p99']:.2f} ms{depths}"
        )
