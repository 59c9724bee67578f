"""The port's dry-run (``repro_torch.launch.dryrun``): cells of each family
at their smoke configs on a (2, 2, 2) fake mesh, the CLI on the paper's
cells at the production meshes, and the roofline report on its JSONs. The
fake process group lives for one test and is destroyed after."""

from __future__ import annotations

import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.benchmarks import roofline_report  # noqa: E402
from repro_torch.configs import common as C  # noqa: E402
from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.configs import paper_retrieval as TP  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_host_mesh  # noqa: E402
from repro_torch.roofline import ring_bytes  # noqa: E402


def _smoke_cells():
    lm = get_arch("qwen3-8b").make_smoke_config()
    moe = get_arch("llama4-maverick-400b-a17b").make_smoke_config()
    gcn = get_arch("gcn-cora").make_smoke_config()
    return [
        C.lm_train_cell("qwen3-8b", lm, global_batch=8, seq_len=32,
                        n_micro=2),
        C.lm_decode_cell("llama4", moe, global_batch=8, seq_len=64,
                         shape_name="decode"),
        C.gnn_full_cell("gcn-cora", gcn, n_nodes=64, n_edges=256,
                        shape_name="full"),
        C.recsys_train_cell("dlrm", get_arch("dlrm-mlperf")
                            .make_smoke_config(), batch=16,
                            shape_name="train"),
        *TP.cells(TP.make_smoke_config()),
    ]


def test_smoke_cells_of_each_family_on_a_2x2x2_fake_mesh():
    """Every family runs once as rank 0 of 8: local flops and bytes are
    counted, the LM cells gather weights (FSDP) and reduce gradients,
    and the paper's serve steps issue exactly their two (nq, k)
    all-gathers."""
    reports = {}
    with fake_world(8):
        mesh = make_host_mesh((2, 2, 2))
        for cell in _smoke_cells():
            rep, arg_bytes, _ = dryrun.run_step(cell, mesh)
            reports[cell.name] = rep
            assert arg_bytes > 0 and rep["bytes"] > 0, cell.name
            assert rep["collective_bytes"] >= 0.0, cell.name
            # held to the reference's compile: no caveat
            assert not cell.collective_caveat, cell.name
    # every cell is held to the reference's compile: no caveat is left
    for cell in all_cells():
        for mesh in ("single", "multi"):
            assert not cell.caveat(mesh), (cell.name, mesh)
    train = reports["qwen3-8b/train_0k"]
    assert train["flops"] > 0
    assert train["collective_counts"]["all-gather"] > 0
    assert train["collective_counts"]["reduce-scatter"] > 0
    for shape, wire in (("serve_online", 4), ("serve_online_prefilter", 4),
                        ("serve_brute", 4)):
        rep = reports[f"paper-retrieval/{shape}"]
        assert rep["collective_counts"]["all-gather"] == 2, shape
        # (nq 256, k 10) fp32 scores (the reference's compiled steps send
        # f32 for the brute force too) and int32 ids from each of 8 ranks
        want = ring_bytes("all-gather", 8 * 256 * 10 * (wire + 4), 8)
        assert rep["collective_bytes"] == pytest.approx(want), shape
        assert rep["collective_detail"]["all-reduce"] == 0.0
    assert reports["paper-retrieval/build_assign"]["collective_bytes"] == 0.0
    # XLA:CPU's count: the (250 x 128) . (128 x 32) product, the argmax's
    # variadic reduce (9 a compared element) and the int32 convert
    assert reports["paper-retrieval/build_assign"]["flops"] == pytest.approx(
        2 * 250 * 32 * 128 + 9 * 250 * (32 - 1) + 250)


def test_extrapolation_is_exact_on_a_bilinear_count():
    def run(d, m):
        return {"flops": 10 + 3 * d + 5 * m + 2 * d * m, "peak_step_bytes":
                100 * d, "collective_detail": {"all-gather": 7.0 * d * m},
                "replicated_ops": ["x"] if d == 2 else []}

    runs = {(d, m): run(d, m) for d in (1, 2) for m in (1, 2)}
    out = dryrun._extrapolate(runs, 36, 4)
    assert out["flops"] == run(36, 4)["flops"]
    assert out["collective_detail"]["all-gather"] == 7.0 * 36 * 4
    assert out["peak_step_bytes"] == 3600
    assert out["replicated_ops"] == ["x"]


def test_cli_writes_reference_keys_and_report_reads_them(tmp_path):
    """The CLI on the paper's brute-force cell at both production meshes
    (the fake group brought up at 256, then 512): one JSON per mesh with
    the reference's keys, read back by the roofline report."""
    out = tmp_path / "dryrun"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = dryrun.main(["--arch", "paper-retrieval", "--shape",
                          "serve_brute", "--mesh", "both", "--out", str(out)])
    assert rc == 0 and "[dryrun] 2 ok, 0 failed" in buf.getvalue()
    files = sorted(os.listdir(out))
    assert files == ["paper-retrieval__serve_brute__multi.json",
                     "paper-retrieval__serve_brute__single.json"]
    keys = {"n_devices", "hlo_flops_per_chip", "hlo_bytes_per_chip",
            "collective_bytes_per_chip", "collective_detail",
            "collective_counts", "memory_analysis", "t_compute_s",
            "t_memory_s", "t_collective_s", "bottleneck", "roofline_fraction",
            "model_flops", "useful_flops_ratio", "arch", "shape", "kind",
            "mesh", "mesh_shape", "lower_s", "compile_s", "note",
            "collective_comparable", "collective_caveat"}
    by_mesh = {}
    for f in files:
        with open(out / f) as fh:
            r = json.load(fh)
        assert keys <= set(r)
        assert r["collective_comparable"] and not r["collective_caveat"]
        by_mesh[r["mesh"]] = r
    assert by_mesh["single"]["n_devices"] == 256
    assert by_mesh["multi"]["mesh_shape"] == {"pod": 2, "data": 16,
                                              "model": 16}
    # 390,624 (single) / 195,312 (multi) bf16 rows of 4096 per chip
    assert by_mesh["single"]["memory_analysis"]["argument_size_in_bytes"] == (
        390_624 * 4096 * 2 + 256 * 4096 * 2)
    # the products' flops (XLA:CPU's count adds the elementwise work,
    # the top-k merges and the masks)
    for mesh, rows in (("single", 390_624), ("multi", 195_312)):
        r = by_mesh[mesh]
        assert r["counted_flops_by_class"]["dot"] == pytest.approx(
            2 * 256 * rows * 4096)
        assert r["hlo_flops_per_chip"] == r["counted_flops_per_chip"] == (
            pytest.approx(sum(r["counted_flops_by_class"].values())))
        assert r["hlo_flops_per_chip"] > 2 * 256 * rows * 4096
    buf = io.StringIO()
    with redirect_stdout(buf):
        rows = roofline_report.run(str(out))
    text = buf.getvalue()
    assert len(rows) == 2
    assert "paper-retrieval,serve_brute,multi,retrieval," in text
    assert "# worst roofline fraction:" in text
    assert "# most collective-bound:" in text


def test_report_leaves_incomparable_collectives_out_of_its_summary(tmp_path):
    """A JSON marked ``collective_comparable: false`` (the LM cells) stays
    in the table but not in the most-collective-bound line; a reference
    JSON (no such key) counts as comparable."""
    base = {"kind": "serve", "t_compute_s": 1e-3, "t_memory_s": 1e-3,
            "bottleneck": "collective", "roofline_fraction": 0.1,
            "memory_analysis": {"temp_size_in_bytes": 0}}
    rows = [dict(base, arch="lm", shape="train_4k", mesh="single",
                 t_collective_s=100.0, collective_comparable=False,
                 collective_caveat="DTensor's placement"),
            dict(base, arch="rec", shape="serve_p99", mesh="single",
                 t_collective_s=1e-2)]
    for r in rows:
        with open(tmp_path / f"{r['arch']}.json", "w") as f:
            json.dump(r, f)
    buf = io.StringIO()
    with redirect_stdout(buf):
        roofline_report.run(str(tmp_path))
    text = buf.getvalue()
    assert "lm,train_4k,single,serve," in text
    assert "# t_collective not comparable (1 rows: DTensor's placement): lm" \
        in text
    assert "# most collective-bound: rec/serve_p99 [single]" in text


@pytest.mark.parametrize("rank", [0, 13])
def test_split_minor_cuts_the_data_ranks_into_major_and_minor(rank):
    """``spmd.split_minor`` on a (2, 4, 2) mesh: 2 minor ranks cut the
    ``data`` dim into a view (pod, data, data_minor, model) over the same
    ranks; 4 minor ranks are the whole ``data`` dim (the mesh itself)."""
    import torch

    from repro_torch.runtime import spmd

    with fake_world(16, rank):
        mesh = make_host_mesh((2, 4, 2))
        view, majd, mind = spmd.split_minor(mesh, [0, 1], 2)
        assert view.mesh_dim_names == ("pod", "data", "data_minor", "model")
        assert torch.equal(view.mesh.flatten(), mesh.mesh.flatten())
        assert (majd, mind) == ([0, 1], [2])
        pod, data, model = mesh.get_coordinate()
        assert (pod, data, model) == (rank // 8, rank // 2 % 4, rank % 2)
        assert list(view.get_coordinate()) == [pod, data // 2, data % 2,
                                              model]
        assert spmd.block_of(view, majd) * 2 + spmd.block_of(view, mind) \
            == spmd.block_of(mesh, [0, 1])
        assert spmd.split_minor(mesh, [0, 1], 2)[0] is view     # cached
        assert spmd.split_minor(mesh, [0, 1], 4) == (mesh, [0], [1])
        assert spmd.split_minor(mesh, [0, 1], 8) == (mesh, [], [0, 1])
        with pytest.raises(ValueError):
            spmd.split_minor(mesh, [0, 1], 3)
