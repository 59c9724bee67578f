"""``fpf_compact_pct`` reads the program's ``fpf_iter.compact_rows`` over
``fpf_iter.rows`` counters of a traced run, and nothing where the program
counted no rows or has no trace module."""

import sys

import pytest
import torch

from perfbench import harness


@pytest.fixture()
def program_trace():
    from repro_torch.runtime import trace

    trace.reset()
    yield trace
    trace.reset()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("held", [0, 7_600, 10_000])
def test_fpf_compact_pct_is_the_share_of_rows_held_compacted(program_trace,
                                                             held):
    with _profile():
        for _ in range(3):
            program_trace.count("fpf_iter.rows", 10_000)
            program_trace.count_device("fpf_iter.compact_rows",
                                       torch.tensor(held, dtype=torch.int32))
    got = harness.metric_reader("fpf_compact_pct")(
        {"trace": object(), "n_steps": 1})
    assert got == pytest.approx(100.0 * held / 10_000)


def test_fpf_compact_pct_reads_nothing_without_rows_or_module(program_trace,
                                                              monkeypatch):
    read = harness.metric_reader("fpf_compact_pct")
    with _profile():
        program_trace.count("tile_fill.computed", 5)
    assert read({"trace": object(), "n_steps": 1}) is None
    assert read({"trace": None, "n_steps": 1}) is None
    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(repro_torch.runtime, "trace")
    assert read({"trace": object(), "n_steps": 1}) is None
