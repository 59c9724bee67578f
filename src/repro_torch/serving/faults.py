"""Deterministic fault injection for the serving tier (the chaos harness;
port of :mod:`repro.serving.faults`, with the same numpy draws, so one seed
gives the same fault trace in both packages).

A fault-tolerance layer is only trustworthy if its failure paths run on
every CI pass, not just on the unlucky production day — so this module
makes replicas misbehave ON DEMAND, deterministically: a
:class:`FaultPolicy` assigns each replica index a :class:`FaultProfile`,
and :meth:`FaultPolicy.wrap` turns the replica's search callable into one
that injects the profile's faults from a seeded per-replica RNG. Same
seed, same per-replica call sequence -> same faults, so a chaos run is a
reproducible experiment, not a flake generator.

Fault vocabulary (all composable in one profile):

``latency_p`` / ``latency_s``
    Latency spike: with probability ``latency_p`` the call sleeps
    ``latency_s`` before computing (a slow-but-correct replica — what
    EWMA steering and hedging exist for).
``error_p``
    Transient failure: the call raises :class:`InjectedFault` after a
    tiny delay (a crashed RPC — what retries exist for).
``hang_p`` / ``hang_s``
    Hang: the call sleeps ``hang_s`` — chosen to dwarf any dispatch
    timeout — then completes uselessly late (a wedged replica: the
    dispatcher must time out, retry elsewhere, and NOT return the lease
    until the thread actually comes back). Finite so test/benchmark
    shutdown always terminates.
``flap_run``
    Flapping: calls alternate in runs of ``flap_run`` — ``flap_run``
    good calls, then ``flap_run`` that raise, repeating (deterministic by
    call index, no RNG). This is the breaker's nemesis: it must trip
    during the bad runs and RECOVER via half-open probes during the good
    ones.

The named profiles in :data:`FAULT_PROFILES` are the standard chaos
suite; ``hang_flap`` (one replica wedged + one flapping) is the
acceptance profile the loadtest's ``--chaos`` assertions run against.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Mapping

import numpy as np

__all__ = [
    "InjectedFault",
    "FaultProfile",
    "FaultPolicy",
    "FAULT_PROFILES",
]


class InjectedFault(RuntimeError):
    """A deliberately-injected transient replica failure (chaos harness)."""


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Per-replica fault mix (see module docstring for the vocabulary)."""

    latency_p: float = 0.0
    latency_s: float = 0.05
    error_p: float = 0.0
    hang_p: float = 0.0
    hang_s: float = 2.0
    flap_run: int = 0

    def __post_init__(self):
        for name in ("latency_p", "error_p", "hang_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.hang_s < 0 or self.latency_s < 0:
            raise ValueError("fault durations must be >= 0")
        if self.flap_run < 0:
            raise ValueError(f"flap_run must be >= 0, got {self.flap_run}")

    @property
    def benign(self) -> bool:
        return not (
            self.latency_p or self.error_p or self.hang_p or self.flap_run
        )

    def describe(self) -> str:
        parts = []
        if self.flap_run:
            parts.append(f"flap(run={self.flap_run})")
        if self.hang_p:
            parts.append(f"hang(p={self.hang_p}, {self.hang_s}s)")
        if self.error_p:
            parts.append(f"error(p={self.error_p})")
        if self.latency_p:
            parts.append(f"spike(p={self.latency_p}, {self.latency_s}s)")
        return "+".join(parts) if parts else "healthy"


class _Injector:
    """One replica's wrapped callable: seeded RNG + call counter.

    Runs INSIDE the executor thread (sleeps and raises happen where the
    real engine call would block). The counter is lock-guarded because a
    hedge can race a retry onto the same replica across threads.
    """

    def __init__(self, profile: FaultProfile, fn: Callable, seed: int, idx: int):
        self.profile = profile
        self.fn = fn
        self.idx = idx
        # distinct, reproducible stream per (policy seed, replica)
        self.rng = np.random.default_rng((int(seed), int(idx)))
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        p = self.profile
        with self._lock:
            i = self.calls
            self.calls += 1
            draws = self.rng.random(3)
        if p.flap_run and (i // p.flap_run) % 2 == 1:
            raise InjectedFault(
                f"replica {self.idx} flapping (call {i}, run {p.flap_run})"
            )
        if p.hang_p and draws[0] < p.hang_p:
            time.sleep(p.hang_s)        # wedged: completes uselessly late
            return self.fn(*args, **kwargs)
        if p.error_p and draws[1] < p.error_p:
            raise InjectedFault(f"replica {self.idx} transient error (call {i})")
        if p.latency_p and draws[2] < p.latency_p:
            time.sleep(p.latency_s)     # slow but correct
        return self.fn(*args, **kwargs)


class FaultPolicy:
    """Replica index -> :class:`FaultProfile` assignment, seeded.

    ``FaultPolicy.named("hang_flap", seed=0)`` builds a standard suite
    profile; ``FaultPolicy({1: FaultProfile(error_p=0.5)})`` builds a
    custom one. Unassigned replicas stay healthy. ``wrap(idx, fn)`` is
    the injection point the :class:`~repro_torch.serving.server.ReplicaPool`
    calls for every replica when a policy is installed.
    """

    def __init__(
        self,
        profiles: Mapping[int, FaultProfile] | None = None,
        *,
        seed: int = 0,
        name: str = "custom",
    ):
        self.profiles = dict(profiles or {})
        self.seed = int(seed)
        self.name = name
        self.injectors: dict[int, _Injector] = {}

    @classmethod
    def named(cls, name: str, *, seed: int = 0) -> "FaultPolicy":
        try:
            profiles = FAULT_PROFILES[name]
        except KeyError:
            raise ValueError(
                f"unknown fault profile {name!r}; known profiles: "
                f"{sorted(FAULT_PROFILES)}"
            ) from None
        return cls(profiles, seed=seed, name=name)

    def profile(self, idx: int) -> FaultProfile:
        return self.profiles.get(idx, FaultProfile())

    def wrap(self, idx: int, fn: Callable) -> Callable:
        profile = self.profile(idx)
        if profile.benign:
            return fn
        inj = _Injector(profile, fn, self.seed, idx)
        self.injectors[idx] = inj
        return inj

    def describe(self) -> str:
        if not self.profiles:
            return f"{self.name}: all replicas healthy"
        parts = ", ".join(
            f"r{idx}={p.describe()}" for idx, p in sorted(self.profiles.items())
        )
        return f"{self.name}: {parts}"


# The standard chaos suite. Replica 0 is the primary (it also serves the
# warmup and any sync parity checks), so faults target replicas >= 1; a
# pool of >= 4 exercises every profile fully, smaller pools just see the
# subset of indices they have.
FAULT_PROFILES: dict[str, dict[int, FaultProfile]] = {
    # isolated transient errors: the retry path, breaker stays mostly closed
    "transient": {
        1: FaultProfile(error_p=0.25),
        2: FaultProfile(error_p=0.25),
    },
    # one consistently slow replica: EWMA steering + hedging territory
    "slow": {
        1: FaultProfile(latency_p=0.6, latency_s=0.08),
    },
    # one replica wedged solid: timeout -> retry elsewhere -> breaker opens
    "hang": {
        1: FaultProfile(hang_p=1.0, hang_s=2.0),
    },
    # one replica alternating good/bad runs: breaker must trip AND recover
    "flap": {
        1: FaultProfile(flap_run=4),
    },
    # the acceptance profile: one wedged + one flapping (of >= 3 healthy
    # peers the dispatcher must keep the p99 within 3x fault-free)
    "hang_flap": {
        1: FaultProfile(hang_p=1.0, hang_s=2.0),
        2: FaultProfile(flap_run=4),
    },
    # failure storm: every non-primary replica mostly erroring — drains the
    # retry budget and forces the degradation ladder (degraded=True answers
    # instead of retry storms; exact/min_recall requests fail typed)
    "storm": {
        1: FaultProfile(error_p=0.6),
        2: FaultProfile(error_p=0.6),
        3: FaultProfile(error_p=0.6),
    },
}
