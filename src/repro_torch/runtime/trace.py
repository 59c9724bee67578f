"""Spans and counters at the layer boundaries of the port's search and
build paths, recorded only while a ``torch.profiler`` is open.

* :func:`span` names a phase ``repro_torch.<layer>.<phase>``, ``<layer>``
  one of :data:`LAYERS`. While a profiler is open it enters a profiler
  range, the fast record function: a host op event. (A user annotation,
  ``torch.profiler.record_function``, also tags every CUDA launch inside
  it for the device's timeline; on an H100 host that cost each launch
  about 1.6 µs more under the profiler.) The span lands in the trace on
  the profiler's clock beside the device's kernels, and it adds its host
  self time (its duration less its child spans', per thread) to
  :func:`span_self_ns`.
  Otherwise it returns one shared null context: no allocation and no call
  into the profiler.
* :func:`count` and :func:`count_device` add to named counters, again only
  while a profiler is open. A device count is kept as the device scalar it
  is handed, with no device op of its own, until :func:`counters` sums them
  and reads them all with one synchronisation.
* :func:`count_launch` is the kernels' launch counter
  (``.launches`` / ``.rounds`` / ``.tc_launches`` on each wrapper), which
  counts always.

:func:`reset` clears the spans' times and the counters, not the launch
counters. The benchmark's per-layer metrics read them after a traced
window (``perfbench/program_trace.py``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

__all__ = ["LAYERS", "PREFIX", "profiling", "span", "count", "count_device",
           "counters", "span_self_ns", "reset", "count_launch"]

PREFIX = "repro_torch."
# search entry and rank program, engine, the kernels' host wrappers, index
# build, the typed API and a model that makes the queries: the layers the
# benchmark's per-layer metrics name
LAYERS = ("entry", "engine", "kernels", "build", "api", "model")

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_self_ns: dict = collections.defaultdict(lambda: [0, 0])  # name -> [n, ns]
_host: collections.Counter = collections.Counter()
_device: dict = {}              # (name, scale, device) -> [device scalars]
_FOLD = 1024                    # scalars kept a key before they are summed


def profiling() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) is open: the
    flag the profiler sets for such fast checks."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "_rf", "_t0", "_child")

    def __init__(self, name: str):
        self.name = name
        self._rf = _RecordFunctionFast(name)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self._child = 0
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child += dt
        with _lock:
            entry = _self_ns[self.name]
            entry[0] += 1
            entry[1] += dt - self._child
        return False


def span(name: str):
    """A context that records the phase ``repro_torch.<name>`` while a
    profiler is open (the shared null context otherwise)."""
    if not profiling():
        return _NULL
    return _Span(PREFIX + name)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name`` while profiling."""
    if profiling():
        with _lock:
            _host[name] += int(n)


def count_device(name: str, value: torch.Tensor, scale: int = 1) -> None:
    """Add ``scale`` times the integer device scalar ``value`` to counter
    ``name`` while profiling, with no synchronisation and no device op (a
    key's scalars are summed on the device every :data:`_FOLD` counts)."""
    if not profiling():
        return
    key = (name, int(scale), value.device)
    with _lock:
        kept = _device.setdefault(key, [])
        kept.append(value)
        if len(kept) >= _FOLD:
            _device[key] = [_sum(kept)]


def _sum(values: list) -> torch.Tensor:
    return torch.stack(values).sum() if len(values) > 1 else values[0]


def counters() -> dict:
    """Every counter since the last :func:`reset`, host and device summed
    by name; the device scalars are read with one synchronisation a
    device."""
    with _lock:
        out = collections.Counter(_host)
        by_dev = collections.defaultdict(list)
        for (name, scale, dev), kept in _device.items():
            by_dev[dev].append((name, scale, _sum(kept)))
    for entries in by_dev.values():
        values = torch.stack([v for _, _, v in entries]).tolist()
        for (name, scale, _), v in zip(entries, values):
            out[name] += scale * v
    return dict(out)


def span_self_ns() -> dict:
    """``{span name: (entries, host self ns)}`` since the last
    :func:`reset`."""
    with _lock:
        return {name: (n, ns) for name, (n, ns) in _self_ns.items()}


def reset() -> None:
    """Clear the spans' times and the counters."""
    with _lock:
        _self_ns.clear()
        _host.clear()
        _device.clear()


_count_lock = threading.Lock()


def count_launch(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to ``wrapper.<attr>`` under a lock: replicas launch from
    several threads, and a bare ``+=`` is a read-modify-write that can lose
    an increment between them."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)
