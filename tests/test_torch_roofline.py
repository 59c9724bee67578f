"""The port's roofline terms and step counter (``repro_torch.roofline``)
against the reference's rules, on fake process groups (no devices), and
the counter's flops and bytes against XLA:CPU's ``cost_analysis()`` on
twin programs."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

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
    # XLA:CPU computes a bf16 product with a bf16 result in fp32: each
    # local operand converted (a flop an element), the fp32 product, the
    # result converted back
    m, k, n = 131072 // 16, 4096, 12288
    assert rep["flops"] == 2 * m * k * n + m * k + k * n + m * n
    assert rep["collective_bytes"] == 0.0
    # bytes: the converts read bf16 and write fp32, the product reads and
    # writes fp32, the last convert reads fp32 and writes bf16
    assert rep["bytes"] == 10 * (m * k + k * n) + 10 * m * n


# --------------------------------------------- the counter against XLA:CPU
# Twin programs: each ``jnp`` program (run through XLA:CPU's
# ``cost_analysis()`` in a subprocess on 8 forced host devices, so the
# flag never reaches this process) and its ``torch`` twin (run on fake
# tensors under the StepCounter) must agree within 1 % on flops and bytes.
# Shapes: x (256, 256), w (256, 64), a (20000, 64) table, 1024 ids.
_XLA_TWINS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    f32, bf16, i32 = jnp.float32, jnp.bfloat16, jnp.int32
    S = jax.ShapeDtypeStruct
    X, W = S((256, 256), f32), S((256, 64), f32)
    TAB, IDS, V = S((20000, 64), f32), S((1024,), i32), S((1024, 64), f32)
    TWINS = {
        "scale": (lambda x: x * 2, [X]),
        "chain": (lambda x: jnp.exp(x * 2 + 1), [X]),
        "reduce_after_chain": (lambda x: jnp.sum(jnp.exp(x * 2 + 1)), [X]),
        "dot_epilogue": (lambda x, w: jax.nn.relu(x @ w), [X, W]),
        "dot_producer": (lambda x, w: (x * 2) @ w, [X, W]),
        "transpose_dot": (lambda x, w: x.T @ w, [X, W]),
        "two_consumers": (lambda x: (x * 2 + 1, x * 2 - 3), [X]),
        "slice": (lambda x: x[:, :64] + 1, [X]),
        "concat": (lambda x: jnp.concatenate([x, x]), [X]),
        "convert": (lambda x: x.astype(bf16), [X]),
        "where": (lambda x: jnp.where(x > 0, x, 0), [X]),
        "argmax": (lambda x: jnp.argmax(x, -1), [X]),
        "softmax": (lambda x: jax.nn.softmax(x, -1), [X]),
        "short_softmax": (lambda x: jax.nn.softmax(x * 0.5, -1),
                          [S((4096, 21), f32)]),
        "gather": (lambda t, i: t[i], [TAB, IDS]),
        "scatter_add": (lambda t, i, v: t.at[i].add(v), [TAB, IDS, V]),
        "segment_sum": (lambda v, s: jax.ops.segment_sum(v, s, 1000),
                        [V, IDS]),
        "top_k": (lambda x, w: jax.lax.top_k((x @ w) * 2, 10), [X, W]),
        "sort": (lambda x: jnp.sort(x, -1), [X]),
        "bf16_dot": (lambda a, b: a @ b, [S((256, 128), bf16),
                                          S((128, 64), bf16)]),
        "bf16_dot_f32": (lambda a, b: jnp.einsum(
            "nd,kd->nk", a, b, preferred_element_type=f32),
            [S((256, 128), bf16), S((64, 128), bf16)]),
        "bf16_batched_matvec": (lambda a, b: jnp.einsum(
            "bmd,bd->bm", a, b, preferred_element_type=f32),
            [S((16, 64, 128), bf16), S((16, 128), bf16)]),
    }
    out = {}
    for name, (fn, args) in TWINS.items():
        out[name] = jax.jit(fn).lower(*args).compile().cost_analysis()
    mesh = jax.make_mesh((8,), ("k",))
    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    out["all_reduce_8"] = jax.jit(
        lambda x, w: x @ w, in_shardings=(sh(None, "k"), sh("k", None)),
        out_shardings=sh()).lower(X, W).compile().cost_analysis()
    out["all_gather_8"] = jax.jit(
        lambda x: x * 2, in_shardings=(sh("k", None),),
        out_shardings=sh()).lower(X).compile().cost_analysis()
    for k, ca in out.items():
        ca = ca[0] if isinstance(ca, list) else ca
        out[k] = (float(ca.get("flops", 0.0)),
                  float(ca.get("bytes accessed", 0.0)))
    print(json.dumps(out))
""")


def _torch_twins():
    t = torch
    x, w = ((256, 256), t.float32), ((256, 64), t.float32)
    tab, ids, v = ((20000, 64), t.float32), ((1024,), t.int32), \
        ((1024, 64), t.float32)
    bf = t.bfloat16

    def norm(i, n):              # jnp's negative-index wrap, made explicit
        return t.where(i < 0, i + n, i)

    return {
        "scale": (lambda x: x * 2, [x]),
        "chain": (lambda x: t.exp(x * 2 + 1), [x]),
        "reduce_after_chain": (lambda x: t.exp(x * 2 + 1).sum(), [x]),
        "dot_epilogue": (lambda x, w: t.relu(x @ w), [x, w]),
        "dot_producer": (lambda x, w: (x * 2) @ w, [x, w]),
        "transpose_dot": (lambda x, w: x.T @ w, [x, w]),
        "two_consumers": (lambda x: (x * 2 + 1, x * 2 - 3), [x]),
        "slice": (lambda x: x[:, :64] + 1, [x]),
        "concat": (lambda x: t.cat([x, x]), [x]),
        "convert": (lambda x: x.to(bf), [x]),
        "where": (lambda x: t.where(x > 0, x, 0.0), [x]),
        "argmax": (lambda x: t.argmax(x, -1), [x]),
        "softmax": (lambda x: t.softmax(x, -1), [x]),
        "short_softmax": (lambda x: t.softmax(x * 0.5, -1),
                          [((4096, 21), t.float32)]),
        "gather": (lambda tb, i: tb[norm(i, tb.shape[0])], [tab, ids]),
        "scatter_add": (lambda tb, i, u: tb.index_add(
            0, norm(i, tb.shape[0]), u), [tab, ids, v]),
        "segment_sum": (lambda u, s: t.zeros(1000, 64).index_add_(0, s, u),
                        [v, ids]),
        "top_k": (lambda x, w: t.topk((x @ w) * 2, 10), [x, w]),
        "sort": (lambda x: t.sort(x, -1).values, [x]),
        "bf16_dot": (lambda a, b: a @ b, [((256, 128), bf),
                                          ((128, 64), bf)]),
        "bf16_dot_f32": (lambda a, b: t.mm(a, b.T, out_dtype=t.float32),
                         [((256, 128), bf), ((64, 128), bf)]),
        "bf16_batched_matvec": (lambda a, b: t.bmm(
            a, b[:, :, None], out_dtype=t.float32)[..., 0],
            [((16, 64, 128), bf), ((16, 128), bf)]),
    }


@pytest.fixture(scope="module")
def xla_costs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _XLA_TWINS],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _count(fn, shapes, world: int = 0):
    """(flops, bytes) the counter charges ``fn`` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        xs = [torch.empty(s, dtype=d) for s, d in shapes]
    counter = StepCounter(HW_H100, fake_mode=fake)
    with fake, counter:
        counter.outputs(fn(*xs))
    rep = counter.report()
    return rep["flops"], rep["bytes"]


def _collective_twin(name):
    """The 8-rank twins: a K-sharded product all-reduced, and a row-sharded
    scale all-gathered (each rank's local program)."""
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    with fake_world(8):
        group = torch.distributed.group.WORLD
        if name == "all_reduce_8":
            return _count(lambda x, w: funcol.wait_tensor(
                funcol.all_reduce(x @ w, "sum", group)),
                [((256, 32), torch.float32), ((32, 64), torch.float32)])
        return _count(lambda x: funcol.wait_tensor(
            gather(x * 2, 0, group)),
            [((32, 256), torch.float32)])


@pytest.mark.parametrize("name", sorted(_torch_twins()) + [
    "all_gather_8", "all_reduce_8"])
def test_counter_matches_xla_cost_analysis(xla_costs, name):
    if name.endswith("_8"):
        got = _collective_twin(name)
    else:
        fn, shapes = _torch_twins()[name]
        got = _count(fn, shapes)
    want = xla_costs[name]
    assert got[0] == pytest.approx(want[0], rel=0.01), ("flops", got, want)
    assert got[1] == pytest.approx(want[1], rel=0.01), ("bytes", got, want)
