"""Fault tolerance + straggler mitigation runtime (port of
:mod:`repro.runtime.fault`; pure Python, copied).

* **Checkpoint/restart**: the train driver
  (:mod:`repro_torch.launch.train`) installs a preemption hook (SIGTERM)
  that forces a checkpoint, and resumes from
  ``CheckpointManager.latest_step()`` on boot.
* **Heartbeats / failure detection**: ``FaultCoordinator`` tracks
  per-worker heartbeat timestamps; a worker silent for more than
  ``heartbeat_timeout`` seconds is declared dead, which on a cluster
  triggers a restart from the newest checkpoint on the survivors.
* **Straggler mitigation**: data batches are stateless in (seed, step,
  shard) (``repro_torch.data``), so a restarted worker regenerates exactly
  its batches; ``StragglerPolicy`` is the decision rule a launcher applies
  to evict persistent stragglers at checkpoint boundaries.

``signal.signal`` works only in the main thread, and it replaces any
earlier SIGTERM handler.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

__all__ = ["FaultCoordinator", "StragglerPolicy"]


@dataclasses.dataclass
class StragglerPolicy:
    """Decide eviction from per-step, per-worker timing statistics.

    A worker is a straggler when its step time exceeds ``threshold`` x the
    fleet median for ``patience`` consecutive steps. Eviction happens at a
    checkpoint boundary: the job restarts on the survivors (elastic restore).
    """

    threshold: float = 1.5
    patience: int = 5

    def update(self, history: dict[int, int], step_times: dict[int, float]):
        """history: worker -> consecutive-slow count (mutated); returns evict list."""
        if not step_times:
            return []
        med = sorted(step_times.values())[len(step_times) // 2]
        evict = []
        for w, t in step_times.items():
            if t > self.threshold * med:
                history[w] = history.get(w, 0) + 1
                if history[w] >= self.patience:
                    evict.append(w)
            else:
                history[w] = 0
        return evict


class FaultCoordinator:
    """Heartbeat registry + preemption-signal checkpoint hook."""

    def __init__(self, *, heartbeat_timeout: float = 60.0):
        self.heartbeat_timeout = heartbeat_timeout
        self._beats: dict[int, float] = {}
        self._preempted = False

    # -------------------------------------------------------------- beats
    def beat(self, worker: int, now: float | None = None):
        self._beats[worker] = time.monotonic() if now is None else now

    def dead_workers(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [
            w for w, t in self._beats.items()
            if now - t > self.heartbeat_timeout
        ]

    # --------------------------------------------------------- preemption
    def install_preemption_hook(self, on_preempt: Callable[[], None]):
        """SIGTERM (the cloud preemption signal) -> checkpoint-now flag."""

        def handler(signum, frame):
            self._preempted = True
            on_preempt()

        signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted
