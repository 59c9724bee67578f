"""The ``mind-retrieval`` configuration on the CPU at the smoke config's
sizes: the plain MIND against the port's on seeded weights, whole runs of
``mind-retrieval.api-b512`` (sound; an answer altered where the program
produces it; the control one precision below), the API's and the model's
spans and counters in a traced run, a planner that serves fewer probes
than the recall asked for, the driver's refusals, and the yardstick's
history draw and the configuration's widths against the program's."""

import gc
import importlib
import time

import numpy as np
import pytest
import torch

from perfbench import harness, program_trace
from perfbench.reference import mind_ref
from perfbench.systems import mind_retrieval

CELL = "mind-retrieval.api-b512"
SMALL = {"config": {"n_items": 3000, "embed_dim": 32, "hist_len": 20,
                    "k_clusters": 10},
         "traffic": {"batch": 8, "pool_batches": 3, "warmup_batches": 1}}
SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def _one_process_of_a_run():
    """One intra-op thread: the API path runs many small ops a request,
    and a pool of threads on cores other test processes keep busy makes
    each of them wait (a whole run 1 s alone, 25-50 s beside five busy
    processes). The driver freezes the heap at the end of its set-up, as
    the one process of a run; the test process takes it back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    gc.unfreeze()


def run(*, trace=False, control=False):
    return harness.run_cell(CELL, SEED, 0.05, trace, dev=torch.device("cpu"),
                            t_start=time.perf_counter(), overrides=SMALL,
                            control=control)


def _cell():
    _, _, cfg, traffic = harness.find_cell(harness.load_manifest(), CELL)
    return cfg, traffic


def test_plain_mind_matches_the_port_on_seeded_weights():
    from repro_torch.configs.mind import make_smoke_config
    from repro_torch.models.recsys import MIND

    cfg = make_smoke_config()
    model = MIND(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    hist = torch.randint(0, cfg.n_items, (6, cfg.hist_len),
                         generator=torch.Generator().manual_seed(4))
    hist[0, 5:] = -1                       # padding, masked out of routing
    hist[1, ::3] = -1
    with torch.no_grad():
        got = model(hist)
    ref = mind_ref.mind_forward(model.p["item_emb"].detach(),
                                model.p["bilinear"].detach(),
                                model.routing_logits, hist,
                                cfg.capsule_iters)
    assert got.shape == (6, cfg.n_interests, cfg.embed_dim)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-6)


def test_sound_run_is_correct_and_reports_its_metrics():
    line, checks = run()
    assert line["correct"], checks
    assert {c[0] for c in checks} >= {"tower_err", "fpf_gap",
                                      "index_mismatch", "bad_answers",
                                      "recall_gap", "field_err"}
    assert {"search_qps", "search_p95_ms", "setup_s"} <= set(line["metrics"])


def _altered_ids(fn):
    def altered(*args, **kwargs):
        s, i = fn(*args, **kwargs)
        i = i.clone()
        i[..., 0] = torch.where(i[..., 0] >= 0, (i[..., 0] + 1) % 3000,
                                i[..., 0])
        return s, i
    return altered


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    mod = importlib.import_module("repro_torch.kernels.bucket_score")
    monkeypatch.setattr(mod, "bucket_score_tiled",
                        _altered_ids(mod.bucket_score_tiled))
    line, checks = run()
    assert not line["correct"], checks


def test_a_planner_short_of_the_recall_asked_for_fails(monkeypatch):
    from repro_torch.core.calibrate import ProbeLadder

    # the fewest probes the ladder allows, forecast at the target: every
    # answer is still sound at the probes it reports, only the recall the
    # request asked for is not met
    monkeypatch.setattr(ProbeLadder, "plan",
                        lambda self, target: self.n_clusterings)
    monkeypatch.setattr(ProbeLadder, "predicted_recall",
                        lambda self, probes: 0.91)
    line, checks = run()
    assert not line["correct"], checks
    failed = {name for name, _, _, ok in checks if not ok}
    assert failed == {"recall_gap"}, checks


def test_the_control_one_precision_below_fails():
    line, checks = run(control=True)
    assert not line["correct"], checks
    failed = {name for name, _, _, ok in checks if not ok}
    assert "tower_err" in failed and "index_mismatch" in failed, checks


def test_traced_run_reads_the_api_and_model_spans_and_counters(
        monkeypatch):
    from repro_torch.core.api import Retriever

    scored = []
    search = Retriever._search_batch

    def counting(self, reqs):
        out = search(self, reqs)
        if torch.autograd.profiler._is_profiler_enabled:
            scored.extend(r.n_scored for r in out)
        return out

    monkeypatch.setattr(Retriever, "_search_batch", counting)
    taken = {}
    read = program_trace.read

    def keep(ctx):
        taken["got"] = read(ctx)
        return taken["got"]

    monkeypatch.setattr(program_trace, "read", keep)
    line, checks = run(trace=True)
    assert line["correct"], checks
    # (the device's metrics read nothing on the CPU)
    for name in ("span_host_ms.api", "span_host_ms.model", "scanned_pct",
                 "span_host_ms.engine", "step_roofline.search",
                 "tile_fill_pct"):
        assert name in line["metrics"], name
    got = taken["got"]
    spans = {n[len("repro_torch."):] for n in got["spans"]}
    assert {"api.resolve", "api.plan", "api.respond", "model.mind"} <= spans
    assert got["counters"]["api.scored"] == sum(scored)
    assert got["counters"]["api.candidates"] == len(scored) * 3000


REFUSED = {
    "sharded-backend": ("config", {"backend": "sharded"}),
    "auto-backend": ("config", {"backend": "auto"}),
    "bf16-pack": ("config", {"pack_dtype": "bfloat16"}),
    "other-method": ("config", {"method": "kmeans"}),
    "unread-config-key": ("config", {"shards": 4}),
    "unread-calibrate-key": ("config", {"calibrate": {"n_queries": 32,
                                                      "seed": 1}}),
    "other-entry": ("traffic", {"entry": "ClusterPruneIndex.search_weighted"}),
    "open-loop": ("traffic", {"loop": "open"}),
    "other-users": ("traffic", {"users": "click_batch"}),
    "unread-traffic-key": ("traffic", {"probes": 240}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_path_the_driver_does_not_run_is_refused(case):
    cfg, traffic = _cell()
    part, over = REFUSED[case]
    data = {"config": dict(cfg), "traffic": dict(traffic)}
    data[part].update(over)
    match = "seed" if case == "unread-calibrate-key" else next(iter(over))
    with pytest.raises(ValueError, match=match):
        mind_retrieval.System(data["config"], data["traffic"], 1,
                              torch.device("cpu"))


def test_histories_are_the_programs_bit_for_bit():
    from repro_torch.data.recsys_data import history_batch

    for step, seed in ((0, 0), (3, SEED), (17, 2**31 + 5)):
        want = history_batch(1_000_448, 64, 50, step=step, seed=seed)[0]
        got = mind_retrieval.history_batch(1_000_448, 64, 50, step=step,
                                           seed=seed)
        assert got.dtype == np.int32 and np.array_equal(got, want)


def test_the_configuration_runs_the_published_widths():
    """The widths are the repo's published sizing of MIND (``make_config``),
    uncut; the configuration traces none of them to the paper, and says so
    among its assumptions."""
    from repro_torch.configs.mind import make_config

    cfg, _ = _cell()
    c = make_config()
    widths = {"n_items": c.n_items, "embed_dim": c.embed_dim,
              "n_interests": c.n_interests,
              "capsule_iters": c.capsule_iters, "hist_len": c.hist_len}
    assert {k: cfg[k] for k in widths} == widths
    assert cfg["reduced"] == [] and cfg["published"] == {}
    assumed = " ".join(cfg["assumed"])
    assert "make_config" in assumed
    for key in widths:
        assert key in assumed, key
