"""What a traced run reads from the program's own spans and counters
(``repro_torch.runtime.trace``, recorded only while the profiler is open,
so over the window alone).

:func:`read` takes them once a run, with one synchronisation, and clears
them for the next run in the same process; the metrics of one run share
what it took. A program without the module (one that records nothing) and
a run without a trace read None, never 0.
"""

from __future__ import annotations

LAYER_PREFIX = "repro_torch."


def read(ctx) -> dict | None:
    """``{"counters": {name: n}, "spans": {name: (entries, self ns)}}``
    of the run ``ctx`` describes, or None."""
    if "program_trace" not in ctx:
        ctx["program_trace"] = _take() if ctx.get("trace") else None
    return ctx["program_trace"]


def _take():
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    out = {"counters": trace.counters(), "spans": trace.span_self_ns()}
    trace.reset()
    return out


def span_host_ms(ctx, layer: str) -> float | None:
    """Host self ms a window step of the program's spans of ``layer``
    (``repro_torch.<layer>.*``); None when the run recorded none."""
    got = read(ctx)
    if not got or not ctx["n_steps"]:
        return None
    prefix = f"{LAYER_PREFIX}{layer}."
    hits = [ns for name, (_, ns) in got["spans"].items()
            if name.startswith(prefix)]
    if not hits:
        return None
    return sum(hits) * 1e-6 / ctx["n_steps"]


def ratio_pct(ctx, part: str, whole: str) -> float | None:
    """Counter ``part`` over counter ``whole``, in %; None when the run
    counted no ``whole``."""
    got = read(ctx)
    if not got:
        return None
    c = got["counters"]
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
