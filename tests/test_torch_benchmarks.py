"""PyTorch port, the paper's experiments: each module runs at a tiny size
on the CPU as ``python -m repro_torch.benchmarks.<name>`` and exits 0 with
its JSON written; their sizes and weight sets are the reference's; without
a card and without ``--device cpu`` they refuse to run."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import common  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_common():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_common", os.path.join(ROOT, "benchmarks",
                                                "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", ["quick", "ts1", "ts2"])
def test_sizes_and_weight_sets_are_the_references(scale):
    ref = _reference_common()
    assert common.bench_sizes(scale) == ref.bench_sizes(scale)
    assert common.PAPER_WEIGHT_SETS == ref.PAPER_WEIGHT_SETS
    with pytest.raises(ValueError):
        common.bench_sizes("huge")


def _run(module, tmp_path, *extra):
    out = tmp_path / f"{module}.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.benchmarks.{module}",
         "--scale", "tiny", "--device", "cpu", "--out", str(out), *extra],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    return res, out


def test_table1_runs_at_tiny_size(tmp_path):
    res, out = _run("table1_preprocessing", tmp_path)
    assert res.returncode == 0, res.stderr
    data = json.loads(out.read_text())
    assert data["device"] == "cpu" and data["card"] is None
    assert set(data["clusterers"]) >= {"fpf", "fpf_fused", "kmeans",
                                       "random"}
    assert [r["algorithm"] for r in data["rows"]] == [
        "our-fpf", "celldec-kmeans", "pods07-random"]
    assert all(len(r["build_seconds_spread"]["samples"]) == data["repeats"]
               >= 3 for r in data["rows"])
    assert data["speedup_vs_celldec"] > 0


def test_fig1_runs_at_tiny_size(tmp_path):
    res, out = _run("fig1_querytime", tmp_path)
    assert res.returncode == 0, res.stderr
    data = json.loads(out.read_text())
    algos = {r["algo"] for r in data["rows"]}
    assert algos == {"our-reference", "our-fused", "our-reference-engine",
                     "our-fused-engine", "celldec"}
    assert data["fused_pack_bytes"] > 0
    assert all(r["fused_rows_equal_reference"] == data["n_queries"]
               and r["engine_rows_equal_api"] == 2 * data["n_queries"]
               and r["ms_per_query_min"] <= r["ms_per_query"]
               <= r["ms_per_query_max"] for r in data["rows"])


@pytest.mark.parametrize("extra", [(), ("--calibration",)])
def test_table2_runs_at_tiny_size(tmp_path, extra):
    res, out = _run("table2_quality", tmp_path, *extra)
    assert res.returncode == 0, res.stderr
    data = json.loads(out.read_text())
    if extra:
        assert len(data["rows"]) == 5 and data["ladder"]["probes"]
        return
    assert not data["failures"]
    exact = [c for c in data["cells"] if c["algorithm"] == "our-exact"]
    assert len(exact) == 7 and all(c["recall"] == [10.0] for c in exact)


def test_repro_paper_runs_all_three(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.repro_paper",
         "--scale", "tiny", "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(tmp_path)) == [
        "fig1_querytime_tiny.json", "table1_preprocessing_tiny.json",
        "table2_quality_tiny.json"]


def test_experiments_refuse_to_fall_back_to_cpu(monkeypatch):
    from repro_torch.benchmarks import (fig1_querytime, table1_preprocessing,
                                        table2_quality)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (table1_preprocessing, fig1_querytime, table2_quality):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--scale", "tiny"])


def test_throughput_runs_at_tiny_size_with_its_byte_ratio_gate(tmp_path,
                                                                capsys):
    """``throughput`` at its smallest size on the CPU: every backend and
    pack labelled, the sharded rows at 3 shards with their packed bytes
    per query, and the gate (bf16 exactly 1/2, int8 exactly 1/4 of fp32)
    checked on them; the gate raises on a wrong ratio."""
    from repro_torch.benchmarks import throughput

    out = tmp_path / "throughput.json"
    throughput.main(["--scale", "tiny", "--device", "cpu", "--shards", "3",
                     "--batches", "1,8", "--out", str(out)])
    assert "byte ratios verified (4 entries" in capsys.readouterr().out
    data = json.loads(out.read_text())
    assert data["device"] == "cpu" and data["card"] is None
    rows = data["entries"]
    assert [(r["backend"], r["pack_dtype"]) for r in rows[::2]] == [
        ("reference", "float32"), ("fused", "float32"),
        ("fused", "bfloat16"), ("fused", "int8"), ("sharded", "float32"),
        ("sharded", "bfloat16"), ("sharded", "int8")]
    assert [r["batch"] for r in rows] == [1, 8] * 7
    assert all(r["card"] is None and r["device"] == "cpu" and r["qps"] > 0
               for r in rows)
    sharded = [r for r in rows if r["backend"] == "sharded"]
    assert all(r["n_shards"] == 3 and r["query_tile"] == 8
               and r["packed_bytes_per_query"] > 0 for r in sharded)
    assert throughput._check_sharded_pack_ratio(rows) == 4
    bad = [dict(r) for r in sharded]
    bad[-1]["packed_bytes_per_query"] *= 1.5
    with pytest.raises(AssertionError, match="not 1/4"):
        throughput._check_sharded_pack_ratio(bad)
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            throughput.main(["--scale", "tiny"])
    finally:
        monkey.undo()
