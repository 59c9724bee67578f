"""The benchmark's manifest and its discovery by name (CPU, no card)."""

import json
import os
import re
import shutil

import pytest
import torch

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_names_units_and_lines(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in manifest["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in manifest["end_to_end"])
    for c in manifest["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in manifest["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] in (1, 4)
    lines = [w["why"] for w in manifest["workloads"]] + \
        [c["why"] for c in manifest["configs"]] + \
        [c["source"] for c in manifest["configs"]] + \
        [m["layer"] for m in manifest["per_layer"]]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_every_file_and_reader_is_found_by_name(manifest):
    for w in manifest["workloads"]:
        wl, cfg_entry, cfg, traffic = harness.find_cell(manifest, w["name"])
        assert cfg_entry["file"].startswith("perfbench/")
        # the driver's tables name the cell's entry and values
        assert harness.system_class(cfg)(cfg, traffic, 1,
                                         torch.device("cpu")) is not None
        reported = harness.cell_metrics(manifest, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.cell_metrics(manifest, w["name"], True)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    moved = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in moved
        for w in m.get("workloads", []):
            e2e = harness.cell_metrics(manifest, w, False)
            assert m["moves"] in {e["name"] for e in e2e}


def test_a_new_traffic_metric_and_cell_need_no_edit(tmp_path, manifest):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"),
                    root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((root / "perfbench/traffic/weighted-b256.json")
                         .read_text())
    traffic["batch"] = 8
    (root / "perfbench/traffic/weighted-b8.json").write_text(
        json.dumps(traffic))
    (root / "perfbench/metrics/steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx['n_steps'])\n")
    new = dict(manifest)
    new["workloads"] = manifest["workloads"] + [
        {"name": "ts2.weighted-b8", "config": "ts2",
         "traffic": "weighted-b8", "chips": 1, "why": "launch overhead"}]
    new["per_layer"] = manifest["per_layer"] + [
        {"name": "steps_done", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "search entry",
         "moves": "search_qps", "workloads": ["ts2.weighted-b8"]}]
    new["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["ts2.weighted-b8"])
        if "ts2.weighted-b256" in m.get("workloads", []) else m
        for m in manifest["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    got = harness.load_manifest(str(root))
    wl, _, _, tr = harness.find_cell(got, "ts2.weighted-b8", str(root))
    assert tr["batch"] == 8
    names = [m["name"] for m in harness.cell_metrics(got, "ts2.weighted-b8",
                                                     True)]
    assert "steps_done" in names
    assert harness.metric_reader("steps_done", str(root))(
        {"n_steps": 3}) == 3.0
    cfg = harness.find_cell(got, "ts2.weighted-b8", str(root))[2]
    assert harness.system_class(cfg)(cfg, tr, 1, torch.device("cpu"))


def test_a_suffixed_metric_shares_its_base_reader():
    shared = harness.metric_reader("device_idle_pct")
    for name in ("device_idle_pct.search", "device_idle_pct.build"):
        assert harness.metric_reader(name).__code__.co_code == \
            shared.__code__.co_code


# a data file that asks for a path no driver runs: refused at set-up, so a
# new cell never times another path under its own name
REFUSED = {
    "search-exact-entry": ("ts2.weighted-b256", "traffic",
                           {"entry": "ClusterPruneIndex.search_exact"}),
    "prefilter-entry": ("paper-retrieval-rank0.online-b256", "traffic",
                        {"entry": "serve_prefilter_rank"}),
    "int8-pack": ("ts2.weighted-b256", "config", {"pack_dtype": "int8"}),
    "fp8-shard": ("paper-retrieval-rank0.brute-b256", "config",
                  {"dtype": "float8_e4m3fn"}),
    "other-corpus": ("ts2.build", "config", {"corpus": "clustered_topics"}),
    "other-method": ("ts2.build", "config", {"method": "kmeans"}),
    "open-loop": ("ts2.weighted-b256", "traffic", {"loop": "open"}),
    "unread-traffic-key": ("paper-retrieval-rank0.online-b256", "traffic",
                           {"exact": True}),
    "unread-config-key": ("ts2.weighted-b256", "config", {"shards": 4}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_path_no_driver_runs_is_refused(case, manifest):
    workload, part, over = REFUSED[case]
    _, _, cfg, traffic = harness.find_cell(manifest, workload)
    data = {"config": dict(cfg), "traffic": dict(traffic)}
    data[part].update(over)
    with pytest.raises(ValueError, match=next(iter(over))):
        harness.system_class(data["config"])(
            data["config"], data["traffic"], 1, torch.device("cpu"))
