"""The idle split by program span (``perfbench/spans.py``) on synthetic
timelines, and the new per-layer metrics (``span_host_ms.*``,
``tile_fill_pct``, ``gather_distinct_pct``) in traced CPU runs of every
cell: each metric a cell lists reads a number there, and none reads
anything without the program's module."""

import sys
import time

import pytest
import torch

from perfbench import harness, program_trace, spans, trace
from perfbench.test_perfbench_run import CELLS, SEED

NEW = ("span_host_ms.", "tile_fill_pct", "gather_distinct_pct")
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, lo, hi, device=CPU, tid=1, annotation=False):
        self._v = (name, lo, hi, device, tid, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Prof:
    """What ``summarize`` and ``spans.events`` read of a profile."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _timeline(program: bool):
    """A window of 10,000 ns, one harness call 1,000-9,000 on thread 1,
    a second thread's label 5,000-9,500, device work at 0-500, 2,000-2,200
    and 8,500-9,800 (idle middles at 1,250, 5,350 and 9,900); with
    ``program``, spans nested 7 deep inside the call, 6 short siblings
    inside the deepest that end before the first middle (a look-back of a
    few labels would stop at them), and the spans' device-side
    annotations."""
    ev = [_Event("bench.window", 0, 10_000),
          _Event("bench.search", 1_000, 9_000),
          _Event("bench.to_host", 9_000, 9_950),
          _Event("bench.other_thread", 5_000, 9_500, tid=2)]
    for lo, hi, name in ((0, 500, "k0"), (2_000, 2_200, "k1"),
                         (8_500, 9_800, "k2")):
        ev.append(_Event(name, lo, hi, device=CUDA))
    if program:
        for depth in range(7):
            lo, hi = 1_100 + 10 * depth, 8_000 - 10 * depth
            name = f"repro_torch.engine.d{depth}"
            ev.append(_Event(name, lo, hi))
            ev.append(_Event(name, lo + 5, lo + 50, device=CUDA,
                             annotation=True))
        for j in range(6):
            ev.append(_Event(f"repro_torch.kernels.s{j}", 1_170 + 10 * j,
                             1_175 + 10 * j))
        ev.append(_Event("repro_torch.kernels.deep", 1_300, 7_900))
    return ev


def test_program_spans_change_no_number_of_the_harness_trace():
    plain = trace.summarize(_Prof(_timeline(False)))
    traced = trace.summarize(_Prof(_timeline(True)))
    assert traced.busy_s == plain.busy_s
    assert traced.device_s == plain.device_s
    assert traced.window_s == plain.window_s
    assert sum(traced.idle_s.values()) == pytest.approx(
        sum(plain.idle_s.values()), abs=1e-15)
    for with_program in (False, True):
        s = spans.attribute(*spans.events(
            _Prof(_timeline(with_program)))[:3])
        assert s.busy_s == plain.busy_s and s.window_s == plain.window_s
        assert sum(s.idle_s.values()) == pytest.approx(
            sum(plain.idle_s.values()), abs=1e-15)


def test_harness_labels_alone_split_as_the_harness_trace_does():
    plain = trace.summarize(_Prof(_timeline(False)))
    s = spans.split(_Prof(_timeline(False)))
    assert s.idle_s.keys() == plain.idle_s.keys()
    for name, v in plain.idle_s.items():
        assert s.idle_s[name] == pytest.approx(v, abs=1e-15)


def test_idle_goes_to_the_innermost_span_at_any_depth():
    s = spans.split(_Prof(_timeline(True)))
    assert s.leaked == 0
    # 500-2,000: past the siblings, inside all 7 spans: the deepest
    assert s.idle_s["repro_torch.engine.d6"] == pytest.approx(1_500e-9)
    # 2,200-8,500: thread 1's innermost (kernels.deep) started at 1,300,
    # the other thread's label at 5,000, the later
    assert s.idle_s["bench.other_thread"] == pytest.approx(6_300e-9)
    assert s.idle_s["bench.to_host"] == pytest.approx(200e-9)
    assert "host: other" not in s.idle_s
    assert s.self_s["repro_torch.kernels.deep"] == pytest.approx(6_600e-9)


def test_two_threads_and_self_time():
    labels = [(0, 1_000, "bench.search", 1),
              (100, 900, "repro_torch.engine.a", 1),
              (200, 300, "repro_torch.kernels.b", 1),
              (400, 600, "repro_torch.kernels.b", 1),
              (550, 950, "bench.serve", 2)]
    s = spans.attribute((0, 1_000), [(0, 150), (700, 800)], labels)
    # 150-700 (middle 425): kernels.b, thread 2 not yet in a label;
    # 800-1,000 (middle 900): thread 1's bench.search (from 0) against
    # thread 2's bench.serve (from 550)
    assert s.idle_s == pytest.approx({"repro_torch.kernels.b": 550e-9,
                                      "bench.serve": 200e-9})
    assert s.self_s["repro_torch.engine.a"] == pytest.approx(500e-9)
    assert s.self_s["repro_torch.kernels.b"] == pytest.approx(300e-9)
    assert s.self_s["bench.search"] == pytest.approx(200e-9)
    assert s.self_s["bench.serve"] == pytest.approx(400e-9)
    assert s.layer_idle_pct() == pytest.approx({"kernels": 55.0})
    assert s.coverage_pct() == pytest.approx(100.0)


def _run_traced(workload):
    got = {}
    summarize = trace.summarize

    def capture(prof):
        got["split"] = spans.split(prof)
        got["labels"] = spans.events(prof)[2]
        return summarize(prof)

    from repro_torch.runtime import trace as program

    program.reset()
    trace.summarize = capture
    try:
        line, checks = harness.run_cell(
            workload, SEED, 0.05, True, dev=torch.device("cpu"),
            t_start=time.perf_counter(), overrides=CELLS[workload])
    finally:
        trace.summarize = summarize
    return line, checks, got["split"], got["labels"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_run_reports_every_new_metric_it_lists(workload):
    line, checks, split, labels = _run_traced(workload)
    assert line["correct"], checks
    listed = [m["name"] for m in harness.cell_metrics(
        harness.load_manifest(), workload, True)
        if m["name"].startswith(NEW)]
    assert listed
    for name in listed:
        assert name in line["metrics"], name
        assert line["metrics"][name]["value"] > 0, name
    for name in ("tile_fill_pct", "gather_distinct_pct"):
        if name in line["metrics"]:
            assert line["metrics"][name]["value"] <= 100.0
    # every program span lies inside a harness label of its thread
    harness_labels = [lb for lb in labels if lb[2].startswith("bench.")]
    program = [lb for lb in labels if lb[2].startswith(spans.PROGRAM)]
    assert program
    for lo, hi, name, tid in program:
        assert any(plo <= lo and hi <= phi and ptid == tid
                   for plo, phi, _, ptid in harness_labels), name
        assert name in split.self_s


def test_new_metrics_read_nothing_without_the_programs_module(monkeypatch):
    import repro_torch.runtime

    # the import fails as it does in a program that has no such module
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(repro_torch.runtime, "trace")
    ctx = {"trace": object(), "n_steps": 3}
    assert program_trace.read(ctx) is None
    for name in ("span_host_ms.entry", "span_host_ms.build", "tile_fill_pct",
                 "gather_distinct_pct"):
        assert harness.metric_reader(name)(dict(ctx)) is None
    assert harness.metric_reader("tile_fill_pct")(
        {"trace": None, "n_steps": 3}) is None
