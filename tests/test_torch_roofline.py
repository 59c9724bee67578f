"""The port's roofline terms and step counter (``repro_torch.roofline``)
against the reference's rules, on fake process groups (no devices)."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro.roofline import analysis as R  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_host_mesh  # noqa: E402
from repro_torch.roofline import (HW_H100, HW_V5E, Hardware,  # noqa: E402
                                  StepCounter, ring_bytes, roofline_terms)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e12, 1e9, 1e8), (3e9, 5e11, 0.0), (0.0, 1.0, 2e12), (0.0, 0.0, 0.0),
    (7.5e14, 2.5e10, 1.25e10)])
def test_roofline_terms_match_reference(flops, nbytes, coll):
    """With the reference's hardware numbers (and no cross-node bytes) the
    port's terms, bottleneck and fraction are the reference's."""
    hw_ref = R.Hardware(name="x", peak_flops=197e12, hbm_bw=819e9,
                        ici_bw=50e9)
    want = R.roofline_terms(flops=flops, bytes_accessed=nbytes,
                            collective_bytes=coll, n_devices=256, hw=hw_ref)
    got = roofline_terms(flops=flops, bytes_accessed=nbytes,
                         collective_bytes=coll, n_devices=256, hw=HW_V5E)
    assert got == want
    assert HW_V5E.peak_flops == R.HW_V5E.peak_flops
    assert HW_V5E.hbm_bw == R.HW_V5E.hbm_bw
    assert HW_V5E.ici_bw == R.HW_V5E.ici_bw


def test_cross_node_bytes_move_at_the_cross_node_rate():
    hw = Hardware(name="t", peak_flops=1.0, hbm_bw=1.0, ici_bw=100.0,
                  cross_node_bw=10.0, node_size=8)
    t = roofline_terms(flops=0.0, bytes_accessed=0.0, collective_bytes=300.0,
                       cross_node_bytes=100.0, n_devices=16, hw=hw)
    assert t["t_collective_s"] == pytest.approx(200 / 100 + 100 / 10)
    assert HW_H100.peak_flops == 989e12 and HW_H100.hbm_bw == 3.35e12
    assert HW_H100.ici_bw == 450e9 and HW_H100.cross_node_bw == 50e9
    assert HW_H100.node_size == 8


def _hlo_bytes(op: str, shape: str, g: int) -> float:
    """The reference's HLO parse of one collective over ``g`` ranks."""
    groups = ",".join(str(i) for i in range(g))
    hlo = (f"ENTRY %main () -> f32[1] {{\n"
           f"  %x = {shape} {op}(f32[1] %p), replica_groups={{{{{groups}}}}}\n"
           f"}}\n")
    return R.collective_bytes_from_hlo(hlo, g)[op]


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"])
@pytest.mark.parametrize("g", [1, 2, 8, 16])
def test_ring_bytes_match_reference_hlo_accounting(op, g):
    assert ring_bytes(op, 4096.0, g) == pytest.approx(
        _hlo_bytes(op, "f32[32,32]{1,0}", g))


def test_collective_counter_at_a_fake_world_of_8():
    """The four collectives with known ring bytes, issued through the c10d
    functional API on fake tensors: the counter charges the reference's
    accounting on the result bytes (fp32 (16, 4): 256 B a rank)."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_world(8):
        import torch.distributed as dist

        group = dist.group.WORLD
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            x = torch.empty(16, 4)
        counter = StepCounter(HW_H100, fake_mode=fake)
        with fake, counter:
            ag = funcol.all_gather_tensor(x, 0, group)
            ar = funcol.all_reduce(x, "sum", group)
            rs = funcol.reduce_scatter_tensor(x, "sum", 0, group)
            aa = funcol.all_to_all_single(x, None, None, group)
            for t in (ag, ar, rs, aa):
                funcol.wait_tensor(t)
        rep = counter.report()
    assert tuple(ag.shape) == (128, 4) and tuple(rs.shape) == (2, 4)
    d = rep["collective_detail"]
    assert d["all-gather"] == pytest.approx(2048 * 7 / 8)
    assert d["all-reduce"] == pytest.approx(2 * 256 * 7 / 8)
    assert d["reduce-scatter"] == pytest.approx(32 * 7)
    assert d["all-to-all"] == pytest.approx(256 * 7 / 8)
    assert rep["collective_counts"] == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "all-to-all": 1, "collective-permute": 0}
    assert rep["cross_node_bytes"] == 0.0          # one node of 8


def test_cross_node_group_and_sub_mesh_group():
    """A group over a mesh dim counts its own size; a group spanning two
    nodes of 8 is charged as cross-node bytes."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_world(16):
        mesh = make_host_mesh((2, 8), ("data", "model"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            x = torch.empty(8, 8)                  # 256 B
        counter = StepCounter(HW_H100, fake_mode=fake)
        with fake, counter:
            funcol.wait_tensor(funcol.all_gather_tensor(x, 0, (mesh, 0)))
            funcol.wait_tensor(funcol.all_gather_tensor(x, 0, (mesh, 1)))
        rep = counter.report()
    # data: ranks {0, 8}, two nodes; model: ranks 0..7, one node
    assert rep["collective_detail"]["all-gather"] == pytest.approx(
        512 * 1 / 2 + 2048 * 7 / 8)
    assert rep["cross_node_bytes"] == pytest.approx(512 * 1 / 2)


def test_sharded_matmul_counts_local_flops():
    """FlopCounterMode around a DTensor product counts the global op; the
    counter counts the rank's local product."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_world(16):
        mesh = make_host_mesh((16,), ("data",))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            a_loc = torch.empty(131072 // 16, 4096, dtype=torch.bfloat16)
            b_loc = torch.empty(4096, 12288, dtype=torch.bfloat16)
        a = DTensor.from_local(a_loc, mesh, [Shard(0)], run_check=False)
        b = DTensor.from_local(b_loc, mesh, [Replicate()], run_check=False)
        counter = StepCounter(HW_H100, fake_mode=fake)
        with fake, counter:
            c = a @ b
        rep = counter.report()
    assert tuple(c.shape) == (131072, 12288)
    assert rep["flops"] == 2 * (131072 // 16) * 4096 * 12288
    assert rep["collective_bytes"] == 0.0
    # bytes: the local operands read and the local product written, bf16
    assert rep["bytes"] == 2 * (8192 * 4096 + 4096 * 12288 + 8192 * 12288)
