"""Micro-batch accumulation: per-execution-shape queues, window-or-size flush
(port of :mod:`repro.serving.batcher`).

The fused engine's batched path only pays off when requests sharing an
execution shape (:class:`~repro_torch.core.api.ExecShape` — backend, probes, k,
rescore) reach it *together*: one engine call per shape serves the whole
group (exactly the grouping :meth:`Retriever._search_batch` applies to a
synchronous batch). Concurrent traffic arrives one request at a time, so
the batcher holds each request briefly in the queue for its shape and
flushes a queue when either

- the **micro-batch window** elapses — measured from the *oldest* queued
  request, so the window is a hard bound on added latency, not a sliding
  timer a steady trickle could postpone forever — or
- the queue reaches **max_batch** requests — sized by the server to a
  multiple of the fused kernel's query tile, so a size-triggered flush
  dispatches full query tiles of the CUDA kernel with no padding waste.

:class:`ShapeQueue` is the per-shape FIFO (plus the priority/deadline
lookups the scheduler's policy needs); :class:`Batcher` is the keyed
collection with the readiness/next-due arithmetic the server's event loop
sleeps on. Neither knows about asyncio: time is a float fed in by the
caller, which keeps flush logic deterministic under test.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

from .scheduler import Ticket

if TYPE_CHECKING:
    from ..core.api import ExecShape

__all__ = ["ShapeQueue", "Batcher"]


class ShapeQueue:
    """FIFO of tickets sharing one execution shape."""

    def __init__(self, shape: "ExecShape"):
        self.shape = shape
        self._items: list[Ticket] = []

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[Ticket]:
        return iter(self._items)

    def append(self, ticket: Ticket) -> None:
        self._items.append(ticket)

    def remove(self, ticket: Ticket) -> None:
        self._items.remove(ticket)

    def drain(self, n: int) -> list[Ticket]:
        """Dequeue the oldest ``n`` tickets (admission order)."""
        out, self._items = self._items[:n], self._items[n:]
        return out

    def take_expired(self, now: float) -> list[Ticket]:
        """Remove and return every ticket whose deadline has passed."""
        dead = [t for t in self._items if t.expired(now)]
        if dead:
            self._items = [t for t in self._items if not t.expired(now)]
        return dead

    # ----------------------------------------------------- scheduler lookups
    def oldest_enqueue(self) -> float | None:
        return self._items[0].t_enqueue if self._items else None

    def min_deadline(self) -> float | None:
        ds = [t.deadline for t in self._items if t.deadline is not None]
        return min(ds) if ds else None

    def lowest_priority(self) -> Ticket | None:
        """Shed victim: lowest priority; youngest (max seq) among ties —
        it has waited the least, so abandoning it wastes the least."""
        if not self._items:
            return None
        return min(self._items, key=lambda t: (t.priority, -t.seq))


class Batcher:
    """Per-shape accumulation with window-or-size flush readiness.

    ``window_s`` is the micro-batch window (seconds a queue's oldest
    request may wait before the queue must flush); ``max_batch`` is the
    size trigger AND the drain cap — a queue longer than ``max_batch``
    stays ready and flushes again on the next loop pass, so bursts drain
    in full-tile slices instead of one oversized ragged call.
    """

    def __init__(self, *, window_s: float = 0.002, max_batch: int = 64):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self._queues: dict["ExecShape", ShapeQueue] = {}

    def queue(self, shape: "ExecShape") -> ShapeQueue:
        q = self._queues.get(shape)
        if q is None:
            q = self._queues[shape] = ShapeQueue(shape)
        return q

    def nonempty(self) -> list[ShapeQueue]:
        return [q for q in self._queues.values() if len(q)]

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depths(self) -> dict["ExecShape", int]:
        return {s: len(q) for s, q in self._queues.items() if len(q)}

    # ------------------------------------------------------------- readiness
    def due_at(self, q: ShapeQueue) -> float | None:
        """When this queue's window forces a flush (None when empty)."""
        oldest = q.oldest_enqueue()
        return None if oldest is None else oldest + self.window_s

    def ready(self, now: float, *, flush_all: bool = False) -> list[ShapeQueue]:
        """Queues that must flush now: window elapsed OR size reached
        (``flush_all`` drains everything — graceful shutdown)."""
        out = []
        for q in self._queues.values():
            if not len(q):
                continue
            if (
                flush_all
                or len(q) >= self.max_batch
                or now >= self.due_at(q)
            ):
                out.append(q)
        return out

    def next_due(self) -> float | None:
        """Earliest future window expiry — what the serving loop sleeps
        until (None when nothing is queued)."""
        dues = [
            self.due_at(q) for q in self._queues.values() if len(q)
        ]
        return min(dues) if dues else None
