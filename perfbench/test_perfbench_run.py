"""Whole runs of every cell on the CPU at a tiny size: sound, with the
program's answer altered where it is produced (the check must fail), and
the control one precision below the configuration's (it must fail too);
and the command's refusal to measure without a card."""

import importlib
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness

TS2 = {"config": {"n_docs": 400, "field_dims": [32, 32, 64],
                  "vocab_sizes": [400, 600, 1500], "k_clusters": 10,
                  "n_topics": 20},
       "traffic": {"pool_batches": 16, "warmup_batches": 1, "batch": 8}}
TS2_BUILD = {"config": TS2["config"], "traffic": {"max_builds": 3}}
PAPER = {"config": {"n_rows": 1500, "n_docs": 1500,
                    "field_dims": [32, 32, 64], "n_topics": 48,
                    "k_clusters": 24, "bucket_pad": 16, "chunk_rows": 512},
         "traffic": {"pool_batches": 16, "warmup_batches": 1, "batch": 8,
                     "probes": 6}}
CELLS = {"ts2.weighted-b256": TS2, "ts2.build": TS2_BUILD,
         "paper-retrieval-rank0.online-b256": PAPER,
         "paper-retrieval-rank0.brute-b256": PAPER}
SEED = 2**33 + 17


def run(workload, *, trace=False, control=False, seed=SEED):
    line, checks = harness.run_cell(
        workload, seed, 0.05, trace, dev=torch.device("cpu"),
        t_start=time.perf_counter(), overrides=CELLS[workload],
        control=control)
    return line, checks


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct_and_reports_its_metrics(workload):
    line, checks = run(workload)
    assert line["correct"], checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"
    assert all(c["limit"] is not None for c in line["checks"].values())


def test_traced_run_reports_per_layer_metrics():
    line, _ = run("ts2.weighted-b256", trace=True)
    assert line["correct"]
    assert "step_roofline.search" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered_ids(fn):
    def altered(*args, **kwargs):
        s, i = fn(*args, **kwargs)
        i = i.clone()
        i[..., 0] = torch.where(i[..., 0] >= 0, (i[..., 0] + 1) % 400,
                                i[..., 0])
        return s, i
    return altered


def _shifted_assign(fn):
    def shifted(x, leaders, **kwargs):
        a, s = fn(x, leaders, **kwargs)
        a = a.clone()
        a[:, 0] = (a[:, 0] + 1) % leaders.shape[1]
        return a, s
    return shifted


FAULTS = {
    "ts2.weighted-b256": ("repro_torch.kernels.bucket_score",
                          "bucket_score_tiled", _altered_ids),
    "ts2.build": ("repro_torch.core.cluster", "assign_to_centers_multi",
                  _shifted_assign),
    "paper-retrieval-rank0.online-b256": (
        "repro_torch.configs.paper_retrieval", "local_topk", _altered_ids),
    "paper-retrieval-rank0.brute-b256": ("repro_torch.kernels.topk_score",
                                         "topk_score", _altered_ids),
}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_an_answer_altered_where_it_is_produced_fails(workload,
                                                      monkeypatch):
    module, name, wrap = FAULTS[workload]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    line, checks = run(workload)
    assert not line["correct"], checks


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_one_precision_below_fails(workload):
    line, checks = run(workload, control=True)
    assert not line["correct"], checks


def test_the_build_reaches_the_programs_fpf_hook():
    """The ``ts2`` check follows the FPF centres that the configuration's
    ``fpf_hook`` records; a program whose build stops calling that entry
    has to keep it or expose its centres some other way."""
    manifest = harness.load_manifest()
    _, _, cfg, traffic = harness.find_cell(manifest, "ts2.build")
    cfg = {**cfg, **TS2_BUILD["config"]}
    traffic = {**traffic, **TS2_BUILD["traffic"]}
    system = harness.system_class(cfg)(cfg, traffic, SEED,
                                       torch.device("cpu"))
    system.setup()
    assert len(system.centres) == cfg["n_clusterings"], (
        f"the program's build no longer calls {cfg['fpf_hook']}, which the "
        "index check reads the FPF centres from")


def test_a_build_past_the_fpf_hook_is_not_correct(monkeypatch, capsys):
    from repro_torch.core import cluster
    from repro_torch.kernels.fpf_iter import ops

    monkeypatch.setattr(cluster.FusedFPFClusterer, "_centers",
                        lambda self, xs, k, first:
                        ops.fpf_centers_fused(xs, k, first))
    line, checks = run("ts2.build")
    assert not line["correct"], checks
    assert "fpf_hook" in capsys.readouterr().err


def test_the_command_refuses_to_measure_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs none")
    p = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"),
         "--workload", "ts2.weighted-b256", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
