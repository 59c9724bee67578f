"""The device's idle time put down to the program's own spans.

``perfbench/trace.py`` puts each idle gap of the device under the
innermost harness label (``bench.*``) that covers the gap's middle. This
module does the same over the harness's labels and the program's spans
(``repro_torch.<layer>.<phase>``, recorded by
``repro_torch.runtime.trace`` while the profiler is open) together, with
exact nesting per host thread, and adds each label's host self time (its
duration less what its child labels on the same thread cover).

:func:`attribute` works on plain interval lists; :func:`events` reads them
from a finished ``torch.profiler.profile``. Run as a script, it runs one
cell as ``run.py --trace 1`` does and prints the result line with the
split added under ``spans``::

    python3 perfbench/spans.py --workload <name> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"
PREFIXES = ("bench.", "repro_torch.")
PROGRAM = "repro_torch."
OTHER = "host: other"


@dataclasses.dataclass
class Split:
    window_s: float
    busy_s: float
    idle_s: dict          # innermost label -> idle seconds of the device
    self_s: dict          # label -> host self seconds in the window
    # program spans on the device's timeline that are not annotations
    # (``perfbench/trace.py`` would count them as device busy)
    leaked: int = 0

    def layer_idle_pct(self) -> dict:
        """Idle share of the window by program layer (the ``<layer>`` of
        ``repro_torch.<layer>.<phase>``)."""
        out = collections.defaultdict(float)
        for name, s in self.idle_s.items():
            if name.startswith(PROGRAM):
                out[name.split(".")[1]] += 100.0 * s / self.window_s
        return dict(out)

    def coverage_pct(self) -> float | None:
        """Of the idle under the harness's call labels (``bench.search``,
        ``bench.build`` and the program spans inside them), the share the
        program's spans name."""
        prog = sum(s for n, s in self.idle_s.items() if n.startswith(PROGRAM))
        call = prog + sum(self.idle_s.get(n, 0.0)
                          for n in ("bench.search", "bench.build"))
        return 100.0 * prog / call if call > 0 else None


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(labels):
    """One thread's labels ``(lo, hi, name)`` -> ``(segments, self_ns)``:
    disjoint pieces ``(lo, hi, name, label's lo)``, sorted, each named by
    the innermost label there, and each label name's self time. A label
    that overlaps its parent's end is cut at it (labels of one thread
    nest)."""
    segs, self_ns = [], collections.defaultdict(int)
    stack = []                              # [hi, name, lo, child ns]
    cur = None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            hi, name, lo, child = stack.pop()
            if hi > cur:
                segs.append((cur, hi, name, lo))
                cur = hi
            self_ns[name] += (hi - lo) - child
            if stack:
                stack[-1][3] += hi - lo

    for lo, hi, name in sorted(labels, key=lambda x: (x[0], -x[1])):
        if cur is None:
            cur = lo
        close_until(lo)
        if stack:
            hi = min(hi, stack[-1][0])
            if lo > cur:
                segs.append((cur, lo, stack[-1][1], stack[-1][2]))
        cur = max(cur, lo)
        stack.append([hi, name, lo, 0])
    close_until(float("inf"))
    return segs, self_ns


def attribute(window, device, labels) -> Split:
    """``window`` ``(lo, hi)`` ns; ``device`` ``[(lo, hi)]`` the device's
    operation intervals; ``labels`` ``[(lo, hi, name, thread)]`` the host's
    labels. Each idle gap of the device inside the window goes to the
    innermost label covering its middle on some thread (of several threads,
    the one whose innermost label started last); ``host: other`` where
    none does."""
    w0, w1 = window
    busy = _merge([(max(lo, w0), min(hi, w1)) for lo, hi in device
                   if min(hi, w1) > max(lo, w0)])
    per_thread = collections.defaultdict(list)
    for lo, hi, name, tid in labels:
        per_thread[tid].append((lo, hi, name))
    threads, self_ns = [], collections.defaultdict(int)
    for tid, ls in per_thread.items():
        segs, own = _innermost(ls)
        threads.append(([s[0] for s in segs], segs))
        for name, ns in own.items():
            self_ns[name] += ns
    idle = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) // 2
        best = None
        for starts, segs in threads:
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and segs[j][1] > mid and (
                    best is None or segs[j][3] > best[3]):
                best = segs[j]
        idle[OTHER if best is None else best[2]] += (hi - lo) * 1e-9
    return Split(window_s=(w1 - w0) * 1e-9,
                 busy_s=sum(hi - lo for lo, hi in busy) * 1e-9,
                 idle_s=dict(idle),
                 self_s={n: ns * 1e-9 for n, ns in self_ns.items()})


def events(prof):
    """``(window, device, labels, leaked)`` of a finished profile:
    :func:`attribute`'s arguments (the device's operations without the
    annotations the host's labels leave on its timeline, as
    ``perfbench/trace.py`` reads them) and the count of program spans on
    the device's timeline that are not annotations."""
    import torch

    window, device, labels, leaked = None, [], [], 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        lo = e.start_ns()
        hi = lo + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(PREFIXES):
                leaked += (name.startswith(PROGRAM)
                           and not e.is_user_annotation())
                continue
            device.append((lo, hi))
        elif name == WINDOW:
            window = (lo, hi)
        elif name.startswith(PREFIXES):
            labels.append((lo, hi, name, e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return window, device, labels, leaked


def split(prof) -> Split:
    window, device, labels, leaked = events(prof)
    return dataclasses.replace(attribute(window, device, labels),
                               leaked=leaked)


def report(s: Split, n_steps: int) -> dict:
    return {"window_s": s.window_s, "busy_s": s.busy_s,
            "idle_s": dict(sorted(s.idle_s.items(), key=lambda kv: -kv[1])),
            "self_ms_a_step": {n: 1e3 * v / max(1, n_steps)
                               for n, v in sorted(s.self_s.items())},
            "layer_idle_pct": s.layer_idle_pct(),
            "coverage_pct": s.coverage_pct(), "leaked": s.leaked}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="One traced run of a cell, "
                                 "its idle split by program span.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, trace

    captured = {}
    summarize = trace.summarize

    def capture(prof):
        captured["split"] = split(prof)
        return summarize(prof)

    trace.summarize = capture
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line, _ = harness.run_cell(args.workload, args.seed, args.seconds, True,
                               dev=dev, t_start=t_start)
    traffic = harness.find_cell(harness.load_manifest(), args.workload)[3]
    steps = line["attempted"] // int(traffic.get("batch", 1))
    line["spans"] = report(captured["split"], steps)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, "perfbench_cache")
    # the environment run.py sets
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main())
