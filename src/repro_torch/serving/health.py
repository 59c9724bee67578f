"""Replica health and resilience policy for the fault-tolerant serving tier
(port of :mod:`repro.serving.health`).

Pure policy, same discipline as :mod:`repro_torch.serving.scheduler`: no asyncio,
time is a float fed in by the caller, so every state machine here is
unit-testable with a frozen clock. The pieces, bottom up:

:class:`CircuitBreaker`
    The classic closed -> open -> half-open machine per replica. Closed
    counts consecutive failures; at the threshold it OPENS and the replica
    stops receiving dispatches for a cooldown. After the cooldown one
    half-open probe is allowed through; its success closes the circuit,
    its failure re-opens it for another cooldown.

:class:`RetryBudget`
    A token bucket that bounds the *global* retry rate: successes earn a
    fraction of a token (``ratio``), each retry or hedge spends one. Under
    a correlated failure (every replica erroring at once) the bucket
    drains and stays empty — retries stop amplifying the outage and the
    dispatcher degrades instead. This is the retry-storm brake.

:class:`ReplicaHealth`
    Per-replica record: EWMA dispatch latency (the pool's pick-the-
    fastest signal), consecutive-failure count, its breaker, and a
    ``busy_since`` stamp whose age is the replica's ``lag`` — how long its
    current lease has been outstanding (a wedged replica shows unbounded
    lag long before any counter moves).

:class:`ResilienceConfig`
    One frozen bag of knobs for all of the above plus the dispatcher's
    timeout/retry/hedge/degradation parameters (defaults in the ROADMAP
    "Architecture: fault tolerance" table).

:func:`degrade_batch` / :func:`degrade_request`
    The degradation ladder. Under overload or an exhausted retry budget a
    request walks DOWN the quality ladder instead of being shed: rung 1
    drops the exact-rescore tail, rung 2 additionally steps ``probes``
    down one calibrated ladder rung (:class:`~repro_torch.core.calibrate.
    ProbeLadder` when the index carries one, halving as the uncalibrated
    fallback). Every applied downgrade is returned as an audit label the
    server stamps onto the response (``degraded=True``). Requests whose
    answer is a *guarantee* — ``exact=True`` or ``min_recall=`` — are
    never silently downgraded: :func:`degrade_request` refuses them
    (:class:`ValueError`) and the dispatcher fails them with the typed
    :class:`~repro_torch.serving.scheduler.ReplicaUnavailable` instead, unless
    the operator opted into ``relax_floors=True`` best-effort mode (the
    relaxation is then stamped like any other rung, so it is still
    auditable, never silent).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:
    from ..core.api import ExecShape, SearchRequest

__all__ = [
    "CircuitBreaker",
    "RetryBudget",
    "ReplicaHealth",
    "ResilienceConfig",
    "degrade_request",
    "degrade_batch",
]


# ------------------------------------------------------------- configuration
@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Every fault-tolerance knob in one frozen bag (see ROADMAP table).

    Timeouts: a dispatch attempt times out after ``timeout_mult`` x the
    observed p99 compute for its execution shape, clamped to
    ``[timeout_floor_s, timeout_ceil_s]``; with no observations yet the
    ceiling applies (first dispatches of a shape are the slowest — they
    trace/compile).

    Retries: up to ``max_retries`` re-dispatches on a *different* replica,
    spaced by capped exponential backoff with +/-50% jitter
    (``backoff_base_s`` doubling up to ``backoff_cap_s``), bounded by the
    tickets' deadlines, each spending one :class:`RetryBudget` token.

    Hedging: when ``hedge`` is on and the shape has an observed p99, a
    first attempt still pending at ``hedge_mult`` x p99 fires one
    speculative duplicate on a different FREE replica (never queues for
    one); first result wins, the loser is discarded on completion. A hedge
    spends a retry token — it is a speculative retry.

    Degradation: when the shape's queue is still past
    ``degrade_highwater`` x ``max_queue_depth`` after a drain, or when
    retries/budget are exhausted, degradable requests walk down the ladder
    (see :func:`degrade_batch`). ``relax_floors`` opts ``min_recall=``
    requests into auditable best-effort relaxation instead of the default
    typed failure; ``exact=True`` requests always fail typed.
    """

    timeout_mult: float = 4.0
    timeout_floor_s: float = 0.05
    timeout_ceil_s: float = 5.0
    max_retries: int = 2
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.1
    retry_budget_ratio: float = 0.2
    retry_budget_cap: float = 16.0
    hedge: bool = True
    hedge_mult: float = 2.0
    breaker_failures: int = 3
    breaker_cooldown_s: float = 1.0
    ewma_alpha: float = 0.2
    degrade_highwater: float | None = 0.75
    max_degrade_rung: int = 2
    relax_floors: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.timeout_floor_s <= 0 or self.timeout_ceil_s < self.timeout_floor_s:
            raise ValueError(
                f"need 0 < timeout_floor_s <= timeout_ceil_s, got "
                f"{self.timeout_floor_s}/{self.timeout_ceil_s}"
            )
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.breaker_failures < 1:
            raise ValueError(
                f"breaker_failures must be >= 1, got {self.breaker_failures}"
            )
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}"
            )
        if self.degrade_highwater is not None and self.degrade_highwater <= 0:
            raise ValueError(
                f"degrade_highwater must be > 0 or None, got "
                f"{self.degrade_highwater}"
            )

    def attempt_timeout(self, p99_s: float | None) -> float:
        """Per-dispatch timeout for a shape with observed compute ``p99_s``
        (None = no observations yet -> the ceiling)."""
        if p99_s is None or p99_s <= 0.0:
            return self.timeout_ceil_s
        return min(
            self.timeout_ceil_s,
            max(self.timeout_floor_s, self.timeout_mult * p99_s),
        )

    def backoff(self, attempt: int, jitter: float) -> float:
        """Backoff before retry ``attempt`` (1-based); ``jitter`` in [0, 1)
        maps to a +/-50% spread around the capped exponential."""
        base = min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** (attempt - 1)))
        return base * (0.5 + jitter)


# ------------------------------------------------------------ circuit breaker
class CircuitBreaker:
    """Consecutive-failure breaker: closed -> open -> half-open -> closed.

    All transitions are driven by the caller's clock. ``allow(now)`` is
    the dispatch gate: closed always allows; open allows nothing until
    ``cooldown_s`` after the trip, then transitions to half-open and
    admits exactly ONE probe (further ``allow`` calls say no until that
    probe reports). The probe's ``record_success`` closes the circuit,
    its ``record_failure`` re-opens it for a fresh cooldown.
    """

    def __init__(self, failures: int = 3, cooldown_s: float = 1.0):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.consecutive = 0
        self.opened_at: float | None = None
        self.trips = 0          # lifetime count of closed/half-open -> open
        self.recoveries = 0     # lifetime count of half-open -> closed
        self._probe_inflight = False

    def would_allow(self, now: float) -> bool:
        """Pure form of :meth:`allow` — SELECTION uses this (no probe slot
        is claimed), the chosen replica's :meth:`allow` then commits."""
        if self.state == "closed":
            return True
        if self.state == "open":
            return now - self.opened_at >= self.cooldown_s
        return not self._probe_inflight

    def allow(self, now: float) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                self._probe_inflight = True
                return True
            return False
        # half-open: one probe at a time
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def record_success(self, now: float) -> bool:
        """Report a successful dispatch; True when this closed a non-closed
        circuit (a recovery — the stats counter the chaos harness asserts
        on)."""
        self.consecutive = 0
        self._probe_inflight = False
        if self.state != "closed":
            self.state = "closed"
            self.opened_at = None
            self.recoveries += 1
            return True
        return False

    def record_failure(self, now: float) -> bool:
        """Report a failed/timed-out dispatch; True when this TRIPPED the
        circuit open (closed past the threshold, or a failed half-open
        probe)."""
        self._probe_inflight = False
        self.consecutive += 1
        if self.state == "half_open" or (
            self.state == "closed" and self.consecutive >= self.failures
        ):
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            return True
        return False


# --------------------------------------------------------------- retry budget
class RetryBudget:
    """Token bucket bounding the global retry/hedge rate.

    Starts full (``cap`` tokens) so isolated early faults retry freely;
    every success deposits ``ratio`` tokens (capped), every retry or hedge
    withdraws one via ``try_spend``. Sustained failure with no successes
    drains the bucket, at which point the dispatcher stops retrying and
    degrades — the brake that keeps a correlated outage from turning into
    a retry storm of duplicated device work.
    """

    def __init__(self, ratio: float = 0.2, cap: float = 16.0):
        if cap <= 0:
            raise ValueError(f"cap must be > 0, got {cap}")
        if ratio < 0:
            raise ValueError(f"ratio must be >= 0, got {ratio}")
        self.ratio = float(ratio)
        self.cap = float(cap)
        self.tokens = float(cap)

    def on_success(self) -> None:
        self.tokens = min(self.cap, self.tokens + self.ratio)

    def try_spend(self, cost: float = 1.0) -> bool:
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


# -------------------------------------------------------------- replica state
class ReplicaHealth:
    """One replica's health record (owned by the pool, fed by dispatch).

    ``ewma_latency_s`` is the exponentially-weighted dispatch latency —
    the pool prefers the lowest among eligible free replicas, so traffic
    drifts away from a slow replica before its breaker ever trips.
    ``lag(now)`` is the age of the outstanding lease (0 when idle): a
    wedged replica shows unbounded lag while every counter stands still,
    which is the signal a multi-host health endpoint would export.
    """

    def __init__(self, idx: int, config: ResilienceConfig | None = None):
        cfg = config or ResilienceConfig()
        self.idx = idx
        self.breaker = CircuitBreaker(
            failures=cfg.breaker_failures, cooldown_s=cfg.breaker_cooldown_s
        )
        self._alpha = cfg.ewma_alpha
        self.ewma_latency_s: float | None = None
        self.busy_since: float | None = None
        self.dispatches = 0
        self.successes = 0
        self.failures = 0
        self.timeouts = 0

    def lag(self, now: float) -> float:
        return 0.0 if self.busy_since is None else max(0.0, now - self.busy_since)

    def record_success(self, now: float, latency_s: float) -> bool:
        """True when this success RECOVERED a tripped breaker."""
        self.dispatches += 1
        self.successes += 1
        if self.ewma_latency_s is None:
            self.ewma_latency_s = float(latency_s)
        else:
            a = self._alpha
            self.ewma_latency_s = a * float(latency_s) + (1 - a) * self.ewma_latency_s
        return self.breaker.record_success(now)

    def record_failure(self, now: float, *, timed_out: bool = False) -> bool:
        """True when this failure TRIPPED the breaker open."""
        self.dispatches += 1
        self.failures += 1
        if timed_out:
            self.timeouts += 1
        return self.breaker.record_failure(now)

    def snapshot(self, now: float) -> dict:
        return {
            "idx": self.idx,
            "state": self.breaker.state,
            "ewma_ms": (
                None if self.ewma_latency_s is None
                else round(self.ewma_latency_s * 1e3, 3)
            ),
            "lag_ms": round(self.lag(now) * 1e3, 3),
            "dispatches": self.dispatches,
            "successes": self.successes,
            "failures": self.failures,
            "timeouts": self.timeouts,
            "trips": self.breaker.trips,
            "recoveries": self.breaker.recoveries,
        }


# --------------------------------------------------------- degradation ladder
def _step_probes_down(
    probes: int, ladder, total_probes: int, n_clusterings: int
) -> int:
    """One rung down: the largest calibrated ladder rung STRICTLY below the
    current budget (the same rungs escalation climbs up, walked the other
    way), halving with a floor of one-probe-per-clustering when the index
    carries no ladder or already sits at the bottom rung."""
    if ladder is not None:
        below = [int(r) for r in ladder.probes if int(r) < probes]
        if below:
            return max(below)
    return max(min(n_clusterings, probes), probes // 2)


def degrade_request(
    req: "SearchRequest",
    shape: "ExecShape",
    *,
    rung: int,
    ladder=None,
    total_probes: int | None = None,
    n_clusterings: int = 1,
    relax_floors: bool = False,
) -> tuple["SearchRequest", tuple[str, ...]]:
    """Walk one request ``rung`` rungs down the ladder; returns the
    downgraded request plus the audit labels describing exactly what was
    taken away (empty labels = nothing could be, the request rides as-is).

    Rungs are cumulative: 1 drops the exact-rescore tail, 2 additionally
    steps ``probes`` down one calibrated rung. Guaranteed requests —
    ``exact=True`` always, ``min_recall=`` unless ``relax_floors`` —
    raise :class:`ValueError`: the dispatcher converts that into the typed
    :class:`~repro_torch.serving.scheduler.ReplicaUnavailable` failure the
    contract promises instead of a silently-worse answer.
    """
    import dataclasses as _dc

    if req.exact:
        raise ValueError(
            "exact=True requests guarantee the true top-k and are never "
            "degraded; under sustained faults they fail typed instead"
        )
    if req.min_recall is not None and not relax_floors:
        raise ValueError(
            f"min_recall={req.min_recall} requests guarantee a recall floor "
            "and are never silently degraded; enable "
            "ResilienceConfig(relax_floors=True) for auditable best-effort "
            "relaxation, or let them fail typed"
        )
    labels: list[str] = []
    fields: dict = {}
    if req.min_recall is not None:
        # relax_floors: the floor becomes best-effort — stamped, not silent
        fields["min_recall"] = None
        labels.append(f"floor:{req.min_recall}->best-effort")
    if rung >= 1 and shape.rescore is not None:
        fields["rescore"] = None
        labels.append(f"rescore:{shape.rescore}->none")
    if rung >= 2:
        p_new = _step_probes_down(
            int(shape.probes), ladder, int(total_probes or shape.probes),
            int(n_clusterings),
        )
        if p_new < int(shape.probes):
            # pin the realised (stepped) budget explicitly; recall_target
            # would re-plan the budget we just stepped away from
            fields["probes"] = int(p_new)
            fields["recall_target"] = None
            labels.append(f"probes:{int(shape.probes)}->{int(p_new)}")
    if not labels:
        return req, ()
    return _dc.replace(req, **fields), tuple(labels)


def degrade_batch(
    requests: Sequence["SearchRequest"],
    shape: "ExecShape",
    *,
    rung: int,
    ladder=None,
    total_probes: int | None = None,
    n_clusterings: int = 1,
    relax_floors: bool = False,
) -> tuple[list["SearchRequest"], list[tuple[str, ...]], list[int]]:
    """Apply :func:`degrade_request` across a flushed batch.

    Returns ``(new_requests, labels_per_request, refused)`` where
    ``refused`` indexes the guaranteed requests that cannot be degraded —
    the dispatcher fails those typed and serves the rest. ``new_requests``
    and ``labels`` keep the original positions (refused rows keep their
    original request and empty labels).
    """
    out: list["SearchRequest"] = []
    labels: list[tuple[str, ...]] = []
    refused: list[int] = []
    for i, req in enumerate(requests):
        try:
            r, lab = degrade_request(
                req, shape, rung=rung, ladder=ladder,
                total_probes=total_probes, n_clusterings=n_clusterings,
                relax_floors=relax_floors,
            )
        except ValueError:
            refused.append(i)
            out.append(req)
            labels.append(())
            continue
        out.append(r)
        labels.append(lab)
    return out, labels, refused
