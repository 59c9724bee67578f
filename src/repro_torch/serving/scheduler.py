"""Deadline/priority scheduling policy for the async serving tier (port of
:mod:`repro.serving.scheduler`).

Pure policy, deliberately free of event-loop machinery: a
:class:`Ticket` is one queued request (its future, enqueue time, absolute
deadline and priority), and :class:`Scheduler` decides three things —

admission
    :meth:`Scheduler.admit` enforces the bounded queue. A full queue
    rejects the newcomer with a typed :class:`Overloaded` — unless
    load-shedding is enabled and a strictly lower-priority request is
    already waiting, in which case THAT request is shed (failed with
    :class:`Overloaded`) and the newcomer takes its place: under overload
    the cheapest work to abandon is the least important work that has not
    started yet.

expiry
    :meth:`Scheduler.expire` fails every queued ticket whose deadline has
    passed with a typed :class:`DeadlineExceeded` — fast, before any
    device work is spent on an answer nobody is waiting for. Once a batch
    is dispatched it always completes (device work cannot be cancelled);
    deadlines bound *queue* time, the window bounds batch time.

ordering
    :meth:`Scheduler.flush_order` ranks flush-ready queues by urgency:
    earliest ticket deadline first, deadline-free queues last (FIFO by
    oldest enqueue among them). With fewer dispatch slots (replicas) than
    ready queues, the tightest deadlines reach the engine first.

The mechanics of accumulation (per-shape queues, window-or-size flush)
live in :mod:`repro_torch.serving.batcher`; the event loop that ties policy to
mechanism lives in :mod:`repro_torch.serving.server`. Keeping the policy pure
makes every decision unit-testable without asyncio.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:  # import cycle guard: batcher imports nothing from here
    from ..core.api import ExecShape, SearchRequest
    from .batcher import ShapeQueue

__all__ = [
    "ServingError",
    "DeadlineExceeded",
    "Overloaded",
    "ReplicaUnavailable",
    "Ticket",
    "Scheduler",
]


class ServingError(Exception):
    """Base of every typed serving-tier failure."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed while it was still queued."""


class Overloaded(ServingError):
    """The request was refused or shed because a bounded queue was full."""


class ReplicaUnavailable(ServingError):
    """Every eligible replica failed/timed out within the retry budget and
    the request could not be served degraded (``exact=True`` and
    ``min_recall=`` requests refuse degradation — they fail typed here
    rather than return a silently-worse answer)."""


@dataclasses.dataclass(eq=False)
class Ticket:
    """One queued request: payload + completion future + scheduling state.

    ``deadline`` is an *absolute* time on the server's clock (loop time),
    or None for no deadline. ``priority`` is higher-is-more-important;
    under overload the lowest-priority ticket is shed first. ``seq`` is
    the admission sequence number — the FIFO tiebreak everywhere order
    matters (drain order, shed victim among equal priorities: youngest
    goes first, it has waited least).
    """

    request: "SearchRequest"
    shape: "ExecShape"
    future: object                # asyncio.Future (duck-typed for tests)
    t_enqueue: float
    deadline: float | None = None
    priority: int = 0
    seq: int = 0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def fail(self, exc: Exception) -> bool:
        """Fail the caller's future (no-op if already done/cancelled)."""
        fut = self.future
        if fut is None:
            return False
        if getattr(fut, "done", lambda: False)():
            return False
        fut.set_exception(exc)
        return True

    def resolve(self, value) -> bool:
        fut = self.future
        if fut is None or fut.done():
            return False
        fut.set_result(value)
        return True


class Scheduler:
    """Admission, expiry and flush-ordering policy (see module docstring).

    Knobs:

    ``max_queue_depth``
        Bound on EACH shape queue. Beyond it, admission sheds or rejects.
    ``shed_low_priority``
        The load-shedding knob: when True (default), a full queue admits a
        higher-priority newcomer by shedding its lowest-priority waiter;
        when False a full queue rejects every newcomer outright.
    ``on_expired``
        Optional callback invoked with each ticket failed by deadline
        expiry — wherever the expiry happens (:meth:`expire` sweeps AND
        the admission-time purge). The server wires its stats counter
        here so expiry is counted exactly once.
    """

    def __init__(
        self, *, max_queue_depth: int = 256, shed_low_priority: bool = True,
        on_expired=None,
    ):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}"
            )
        self.max_queue_depth = max_queue_depth
        self.shed_low_priority = shed_low_priority
        self.on_expired = on_expired

    # ---------------------------------------------------------------- expiry
    def _fail_expired(self, queue: "ShapeQueue", now: float) -> list[Ticket]:
        """Remove + fail ``queue``'s expired waiters (shared by the sweep
        and the admission-time purge, so both report via ``on_expired``)."""
        dead = queue.take_expired(now)
        for t in dead:
            t.fail(
                DeadlineExceeded(
                    f"deadline passed after {now - t.t_enqueue:.4f}s in "
                    f"the queue for shape {tuple(t.shape)} (waited past "
                    f"its {t.deadline - t.t_enqueue:.4f}s budget)"
                )
            )
            if self.on_expired is not None:
                self.on_expired(t)
        return dead

    # ------------------------------------------------------------- admission
    def admit(self, queue: "ShapeQueue", ticket: Ticket) -> Ticket | None:
        """Admit ``ticket`` into ``queue``; returns the shed victim, if any.

        Raises :class:`Overloaded` when the queue is full and shedding is
        off (or cannot find a strictly lower-priority victim). A returned
        victim has already had its future failed with :class:`Overloaded`.

        A full queue first reclaims the slots of waiters whose deadline
        has already passed (failing them :class:`DeadlineExceeded`, the
        answer they were due anyway): an expired waiter holds no real
        capacity, so it must never push a live newcomer into
        :class:`Overloaded` — previously those slots were only reclaimed
        on the serving loop's next sweep, so a burst of expired waiters
        spuriously rejected live traffic.
        """
        victim = None
        if len(queue) >= self.max_queue_depth:
            self._fail_expired(queue, ticket.t_enqueue)
        if len(queue) >= self.max_queue_depth:
            if self.shed_low_priority:
                victim = queue.lowest_priority()
            if victim is None or victim.priority >= ticket.priority:
                raise Overloaded(
                    f"queue for shape {tuple(queue.shape)} is full "
                    f"({len(queue)} waiting, max {self.max_queue_depth}) and "
                    f"the incoming priority ({ticket.priority}) preempts "
                    f"nothing queued"
                )
            queue.remove(victim)
            victim.fail(
                Overloaded(
                    f"shed from the full queue for shape "
                    f"{tuple(queue.shape)} by a priority-"
                    f"{ticket.priority} request (own priority "
                    f"{victim.priority})"
                )
            )
        queue.append(ticket)
        return victim

    def expire(
        self, queues: Iterable["ShapeQueue"], now: float
    ) -> list[Ticket]:
        """Remove + fail every queued ticket whose deadline passed."""
        dead: list[Ticket] = []
        for q in queues:
            dead.extend(self._fail_expired(q, now))
        return dead

    # -------------------------------------------------------------- ordering
    @staticmethod
    def flush_order(ready: list["ShapeQueue"]) -> list["ShapeQueue"]:
        """Urgency order: earliest deadline first, deadline-free last
        (oldest-waiting first among them)."""
        def key(q: "ShapeQueue"):
            d = q.min_deadline()
            oldest = q.oldest_enqueue()
            return (d is None, d if d is not None else 0.0,
                    oldest if oldest is not None else 0.0)

        return sorted(ready, key=key)
