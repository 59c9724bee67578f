"""PyTorch port, the examples and the benchmark harness: each runs on the
CPU at a small size (``--device cpu``) and states its own end-of-run
facts; ``benchmarks.run`` writes its one JSON under the package's
``_results/`` and never the reference's ``BENCH_*.json`` at the root."""

import hashlib
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import mind as mind_config  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    quickstart, recsys_retrieval, serve_retrieval)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_on_cpu(capsys):
    assert quickstart.main(["--docs", "1500", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "search backend: reference" in out
    recall = float(out.split("recall@10 = ")[1].split("/")[0])
    assert 0.0 < recall <= 10.0
    add = [l for l in out.splitlines() if l.startswith("after add:")]
    gone = [l for l in out.splitlines() if l.startswith("after remove:")]
    assert add and add[0].endswith("is hit #1 -> True"), out
    assert gone and gone[0].endswith("-> True"), out


def test_serve_retrieval_on_cpu(capsys):
    assert serve_retrieval.main(["--docs", "1500", "--queries", "32",
                                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4/4 responses served from the request cache" in out
    assert "4/4 copies took over as hit #1" in out
    assert "none leaked back (1500 live)" in out
    achieved = float(out.split("achieved ")[1].split()[0])
    predicted = float(out.split("predicted recall ")[1].split(",")[0])
    assert 0.0 <= achieved <= 1.0 and 0.0 < predicted <= 1.0


def test_recsys_retrieval_at_mind_smoke_size():
    """The example's steps at MIND's smoke config (3,000 items, E = 32, 4
    interests): the pruned answer agrees with the brute force as the
    planner predicts, and every hit's per-interest scores sum to its
    score."""
    cfg = mind_config.make_smoke_config()
    out = recsys_retrieval.run(cfg, 55, device="cpu")
    assert out["docs"].shape == (cfg.n_items, 4 * cfg.embed_dim)
    assert out["retriever"].backend == "reference"
    assert out["recall"] >= out["predicted_recall"] - 0.05
    assert 0.0 < out["scanned"] <= 1.0
    for r in out["responses"]:
        assert len(r.hits) == 10 and r.probes == out["probes"]
        for h in r.hits:
            assert abs(sum(h.field_scores.values()) - h.score) < 1e-5
            assert set(h.field_scores) == {"i0", "i1", "i2", "i3"}


def test_recsys_retrieval_default_is_the_references_size():
    cfg = recsys_retrieval.DEFAULT_CONFIG
    assert (cfg.n_items, cfg.embed_dim, cfg.n_interests, cfg.hist_len) == (
        60_000, 32, 4, 20)
    full = mind_config.make_config()
    assert (full.n_items, full.embed_dim, full.hist_len) == (1_000_448, 64,
                                                             50)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_benchmarks_run_tiny_writes_results_not_bench_files(capsys):
    from repro_torch.benchmarks import run

    roots = [os.path.join(ROOT, n) for n in ("BENCH_preprocess.json",
                                             "BENCH_query.json")]
    before = {p: (_digest(p), os.stat(p).st_mtime_ns) for p in roots}
    t0 = time.time()
    assert run.main(["--scale", "tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # the dry-run's roofline table, or where to make it
    assert "# Roofline" in out or "# no dry-run artifacts under" in out
    path = os.path.join(ROOT, "src", "repro_torch", "benchmarks",
                        "_results", "run_tiny.json")
    assert f"# wrote {path}" in out
    assert os.stat(path).st_mtime >= t0 - 1
    data = json.loads(open(path).read())
    assert data["experiment"] == "run" and data["device"] == "cpu"
    assert data["card"] is None
    assert {"table1", "fig1", "table2", "throughput", "serving", "kernels",
            "engines", "roofline"} <= set(data)
    assert all(r["agrees"] for r in data["kernels"])
    assert len(data["kernels"]) >= 5
    assert not data["table2"]["failures"]
    assert [e["mode"] for e in data["serving"]] == [
        "sequential", "closed", "open", "server_stats"]
    assert {(p, _digest(p), os.stat(p).st_mtime_ns) for p in roots} == {
        (p, *v) for p, v in before.items()}
    assert np.isfinite(data["seconds"])
