"""``resolve_sync_pct`` reads the program's ``api.resolve_syncs`` over
``api.raw_queries`` counters of a traced run: 100 when each raw request is
resolved alone, 100 / 512 when a batch of 512 is resolved at once, and
nothing where the program counted no raw query or has no trace module."""

import sys

import pytest
import torch

from perfbench import harness

N = 512


@pytest.fixture()
def program_trace():
    from repro_torch.runtime import trace

    trace.reset()
    yield trace
    trace.reset()


@pytest.fixture(scope="module")
def retriever():
    from repro_torch.core.api import Retriever
    from repro_torch.core.fields import FieldSpec
    from repro_torch.core.index import ClusterPruneIndex

    spec = FieldSpec(names=("i0", "i1", "i2", "i3"), dims=(4, 4, 4, 4))
    docs = torch.randn(200, 16, generator=torch.Generator().manual_seed(0))
    index = ClusterPruneIndex.build(docs, spec, 4, n_clusterings=2,
                                    method="fpf_fused", device="cpu")
    return Retriever(index, backend="fused")


def _requests():
    from repro_torch.core.api import SearchRequest

    g = torch.Generator().manual_seed(1)
    return [SearchRequest(query=list(torch.randn(4, 4, generator=g)))
            for _ in range(N)]


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _read():
    return harness.metric_reader("resolve_sync_pct")(
        {"trace": object(), "n_steps": 1})


def test_one_request_at_a_time_reads_100(program_trace, retriever):
    reqs = _requests()
    with _profile():
        for r in reqs:
            r.resolve_query(retriever.index)
    assert program_trace.counters() == {"api.raw_queries": N,
                                        "api.resolve_syncs": N}
    assert _read() == pytest.approx(100.0)


def test_one_batch_reads_one_sync_in_512(program_trace, retriever):
    reqs = _requests()
    with _profile():
        retriever._resolve_qw(reqs)
    assert _read() == pytest.approx(100.0 / N)


def test_resolve_sync_pct_reads_nothing_without_counters(program_trace,
                                                         monkeypatch):
    read = harness.metric_reader("resolve_sync_pct")
    with _profile():
        program_trace.count("api.scored", 5)
    assert read({"trace": object(), "n_steps": 1}) is None
    assert read({"trace": None, "n_steps": 1}) is None
    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    monkeypatch.delattr(repro_torch.runtime, "trace")
    assert read({"trace": object(), "n_steps": 1}) is None
