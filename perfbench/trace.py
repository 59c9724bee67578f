"""What a ``--trace 1`` run reads from ``torch.profiler``.

The window runs under the profiler (CPU and CUDA activity) inside one
``record_function("bench.window")``; the harness labels its own calls
``bench.<what>``. From the trace:

* ``window_s``: the length of ``bench.window``;
* ``busy_s``: the union of the device's operation intervals inside it;
* ``device_s``: device seconds by operation name (kernels, copies, sets);
* ``idle``: the device's idle gaps, each put to the innermost harness label
  that covers the gap's middle on the host (``host: other`` where none
  does).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

WINDOW = "bench.window"
LABEL_PREFIX = "bench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s: dict            # operation name -> seconds in the window
    idle_s: dict              # host label -> idle seconds of the device

    def kernel_s(self, *patterns: str) -> float | None:
        """Device seconds of the operations whose name holds any of
        ``patterns``; None when none ran."""
        hits = [s for name, s in self.device_s.items()
                if any(p in name for p in patterns)]
        return sum(hits) if hits else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _events(prof):
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results")
    return results.events()


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(prof) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` to a
    :class:`TraceSummary` (see the module docstring)."""
    window = None
    device, labels = [], []
    for e in _events(prof):
        name = e.name()
        lo = e.start_ns()
        hi = lo + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(LABEL_PREFIX):
                continue
            device.append((lo, hi, name))
        elif name == WINDOW:
            window = (lo, hi)
        elif name.startswith(LABEL_PREFIX):
            labels.append((lo, hi, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window
    per_name = collections.defaultdict(float)
    clipped = []
    for lo, hi, name in device:
        lo, hi = max(lo, w0), min(hi, w1)
        if hi > lo:
            per_name[name] += (hi - lo) * 1e-9
            clipped.append((lo, hi))
    busy = _merge(clipped)
    busy_ns = sum(hi - lo for lo, hi in busy)
    labels.sort()
    starts = [lo for lo, _, _ in labels]
    idle = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) // 2
        name = "host: other"
        # the latest-starting label that covers the middle is the innermost
        # (the harness nests its labels at most a few deep)
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 4, -1), -1):
            if labels[j][1] >= mid:
                name = labels[j][2]
                break
        idle[name] += (hi - lo) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                        device_s=dict(per_name), idle_s=dict(idle))
