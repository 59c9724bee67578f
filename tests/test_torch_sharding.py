"""The port's sharding rules (``repro_torch.runtime.sharding``), its meshes
and ``restore_pytree(shardings=)`` against the reference."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.runtime import sharding as RS  # noqa: E402
from repro_torch.checkpoint.manager import (restore_pytree,  # noqa: E402
                                            save_pytree)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh as TMesh,  # noqa: E402
                                     fake_world, make_host_mesh,
                                     make_production_mesh,
                                     make_single_device_mesh)
from repro_torch.runtime import sharding as TS  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
AXES = ("pod", "data", "model")


def _norm(spec) -> tuple:
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


_axis_entry = st.one_of(
    st.none(), st.sampled_from(AXES),
    st.lists(st.sampled_from(AXES), min_size=1, max_size=3,
             unique=True).map(tuple))


@settings(max_examples=60, deadline=None)
@given(sizes=st.tuples(*[st.sampled_from([1, 2, 3, 4, 16])] * 3),
       dims=st.lists(st.sampled_from([1, 2, 3, 6, 8, 12, 16, 48, 96, 256,
                                      1000]), min_size=1, max_size=4),
       data=st.data())
def test_spec_for_matches_reference(sizes, dims, data):
    axes_per_dim = [data.draw(_axis_entry) for _ in dims]
    ref = RS.spec_for(AbstractMesh(sizes, AXES), dims, axes_per_dim)
    got = TS.spec_for(TMesh(sizes, AXES), dims, axes_per_dim)
    assert _norm(got) == _norm(ref)
    assert len(got) == len(tuple(ref))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-8b", "llama4-maverick-400b-a17b",
                                  "qwen2-moe-a2.7b"])
def test_lm_rules_match_reference(arch, multi):
    """Every rule set by leaf: the reference's trees flattened to the port's
    dotted names."""
    import jax
    from jax.sharding import PartitionSpec

    from repro import configs as R

    shape, axes = ((2, 16, 16), AXES) if multi else ((16, 16), AXES[1:])
    r_mesh, t_mesh = AbstractMesh(shape, axes), TMesh(shape, axes)
    r_cfg = R.get_arch(arch).make_config()
    t_cfg = get_arch(arch).make_config()

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
        return {".".join(str(k.key) for k in p): v for p, v in leaves}

    pairs = [
        (RS.lm_param_rules, TS.lm_param_rules, ""),
        (RS.lm_param_rules_zero3, TS.lm_param_rules_zero3, ""),
        (lambda c, m: RS.lm_use_rules(c, m), TS.lm_use_rules, ""),
        (lambda c, m: RS.lm_use_rules_zero3(c, m), TS.lm_use_rules_zero3, ""),
    ]
    for ref_fn, port_fn, _ in pairs:
        ref, got = flat(ref_fn(r_cfg, r_mesh)), port_fn(t_cfg, t_mesh)
        assert set(ref) == set(got)
        for name, spec in ref.items():
            assert _norm(got[name]) == _norm(spec), name
    rp, rb = RS.lm_train_shardings(r_cfg, r_mesh, global_batch=256,
                                   seq_len=4096)
    tp, tb = TS.lm_train_shardings(t_cfg, t_mesh, global_batch=256,
                                   seq_len=4096)
    assert tp == TS.lm_param_rules(t_cfg, t_mesh)
    assert {k: _norm(v) for k, v in tb.items()} == {
        k: _norm(v) for k, v in rb.items()}
    for batch in (1, 128):
        rp, rc, rt = RS.lm_decode_shardings(r_cfg, r_mesh, batch=batch)
        tp, tc, tt = TS.lm_decode_shardings(t_cfg, t_mesh, batch=batch)
        assert _norm(tt) == _norm(rt)
        for k in ("k", "v", "length"):
            assert _norm(tc[k]) == _norm(rc[k])


def test_meshes_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    m = make_production_mesh(multi_pod=True, abstract=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert make_production_mesh(abstract=True).shape == {"data": 16,
                                                         "model": 16}
    assert make_single_device_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError):
        make_production_mesh()                    # no process group
    with fake_world(8):
        mesh = make_host_mesh((2, 2, 2))
        assert TS.mesh_axes(mesh) == {"pod": 2, "data": 2, "model": 2}
        assert TS.to_placements(mesh, TS.P(("pod", "data"), "model")) == (
            Shard(0), Shard(0), Shard(1))
        assert TS.to_placements(mesh, TS.P(None, "data")) == (
            Replicate(), Shard(1), Replicate())
        assert TS.local_shape(mesh, (8, 8), TS.P(("model", "pod"), None)) \
            == (2, 8)
        # axes nested inside a later mesh axis: strided, split by its size
        assert TS.to_placements(mesh, TS.P(("model", "pod", "data"))) == (
            _StridedShard(0, split_factor=2), _StridedShard(0, split_factor=2),
            Shard(0))
        assert TS.to_placements(mesh, TS.P(("pod", "model", "data"))) == (
            Shard(0), _StridedShard(0, split_factor=2), Shard(0))


_JAX_ROWS = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for name, spec in json.loads(sys.argv[1]).items():
        sh = NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                     for e in spec]))
        idx = sh.devices_indices_map((8, 8))
        flat = list(mesh.devices.flat)
        out[name] = [[[s.start or 0, s.stop or n] for s, n in
                      zip(idx[d], (8, 8))] for d in flat]
    print(json.dumps(out))
""")


def test_restore_with_shardings_gives_each_rank_the_reference_rows(tmp_path):
    """Each rank of a (2, 2, 2) fake world restores the block of every leaf
    that the reference's ``NamedSharding`` gives that device (device ``r``
    at mesh position ``r``), axes read major to minor as written."""
    specs = {
        "rows_mesh_order": [["pod", "data"], None],
        "rows_reversed": [["model", "pod", "data"], None],
        "cols": [None, "data"],
        "both": ["model", ["pod", "data"]],
        "replicated": [None, None],
    }
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_ROWS, json.dumps(specs)],
                         capture_output=True, text=True, env=env, timeout=120,
                         check=True)
    want = json.loads(res.stdout)
    rng = np.random.default_rng(3)
    tree = {name: torch.tensor(rng.standard_normal((8, 8)), dtype=torch.float32)
            for name in specs}
    save_pytree(tree, str(tmp_path))
    like = {n: torch.empty((8, 8), device="meta") for n in specs}
    from torch.distributed.tensor import distribute_tensor
    for rank in range(8):
        with fake_world(8, rank=rank):
            mesh = make_host_mesh((2, 2, 2))
            shardings = {n: TS.named(mesh, TS.P(*[tuple(e) if isinstance(
                e, list) else e for e in spec])) for n, spec in specs.items()}
            got = restore_pytree(like, str(tmp_path), shardings=shardings)
            for name in specs:
                (r0, r1), (c0, c1) = want[name][rank]
                local = got[name].to_local()
                assert tuple(got[name].shape) == (8, 8)
                assert torch.equal(local, tree[name][r0:r1, c0:c1]), (
                    name, rank)
                # the placements describe those rows
                assert torch.equal(local, distribute_tensor(
                    tree[name], mesh, got[name].placements,
                    src_data_rank=None).to_local()), (name, rank)


# A world of 8 gloo processes on a (2, 2, 2) mesh, forked from one script;
# argv: store file, task, its argument. A failed check fails the process.
_GLOO_WORLD = textwrap.dedent("""
    import sys

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def work(rank, store, task, arg):
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=8)
        try:
            from repro_torch.launch.mesh import make_host_mesh

            TASKS[task](make_host_mesh((2, 2, 2)), arg)
        finally:
            dist.destroy_process_group()


    def restore(mesh, directory):
        from repro_torch.checkpoint.manager import restore_pytree
        from repro_torch.models.embedding import (
            EmbedTablesConfig, table_shardings, table_specs)
        from repro_torch.runtime.sharding import (
            data_axes, local_rows, mesh_axes, named)

        cfg = EmbedTablesConfig(vocab_sizes=(64, 16), embed_dim=4,
                                row_shard_threshold=32)
        # the recsys cells' table rows: ("model", "pod", "data")
        specs = table_shardings(cfg, model_axes=("model",) + data_axes(mesh))
        like = {n: torch.empty(s.shape, device="meta")
                for n, s in table_specs(cfg).items()}
        full = restore_pytree(like, directory)
        got = restore_pytree(like, directory, shardings={
            n: named(mesh, sp) for n, sp in specs.items()})
        coords = dict(zip(mesh_axes(mesh), mesh.get_coordinate()))
        for n, sp in specs.items():
            rows = local_rows(mesh, coords, like[n].shape[0], sp.axes(0))
            assert torch.equal(got[n].to_local(), full[n][rows]), n
            assert torch.equal(got[n].full_tensor(), full[n]), n


    def attention(mesh, _):
        from torch.distributed.tensor import (
            DTensor, Partial, Replicate, Shard, distribute_tensor)

        from repro_torch.models import transformer as T

        R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
        g = torch.Generator().manual_seed(0)

        def place(x, pls):
            if not any(p.is_partial() for p in pls):
                return distribute_tensor(x, mesh, pls, src_data_rank=None)
            # a partial sum: the rank at coordinate 0 of each partial dim
            # holds the whole value, the others zeros
            base = [R if p.is_partial() else p for p in pls]
            loc = distribute_tensor(x, mesh, base,
                                    src_data_rank=None).to_local()
            coord = mesh.get_coordinate()
            if any(p.is_partial() and coord[i] for i, p in enumerate(pls)):
                loc = torch.zeros_like(loc)
            return DTensor.from_local(loc, mesh, pls, run_check=False,
                                      shape=x.shape, stride=x.stride())

        def check(got, want, case):
            torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5,
                                       atol=1e-6, msg=lambda m: f"{case} {m}")

        b, s, hk, dh = 4, 24, 2, 8
        for hq in (8, 4):           # one kv head a rank's q heads, and two
            q = torch.randn((b, s, hq, dh), generator=g)
            k = torch.randn((b, s, hk, dh), generator=g)
            v = torch.randn((b, s, hk, dh), generator=g)
            want = T.blockwise_attention(q, k, v, q_chunk=8, kv_chunk=16)
            # (q, k / v) placements over (pod, data, model)
            for pq, pk in [((S0, S0, S2), (S0, S0, R)),
                           ((S0, S0, S2), (S0, S0, S2)),
                           ((R, S0, Partial()), (R, S0, Partial())),
                           ((Partial(), S2, R), (R, R, R))]:
                check(T.blockwise_attention(
                    place(q, pq), place(k, pk), place(v, pk), q_chunk=8,
                    kv_chunk=16), want, (hq, pq, pk))
            # decode: one token against a cache split over its positions
            q1, length = q[:, :1], torch.tensor(19)
            want = T.decode_attention(q1, k, v, length)
            for pq, pk in [((S0, S0, S2), (S0, S0, S1)),
                           ((R, Partial(), S2), (R, S0, S1)),
                           ((R, R, S2), (S1, S1, S1)),
                           ((S0, S0, R), (S0, S0, S2))]:
                check(T.decode_attention(place(q1, pq), place(k, pk),
                                         place(v, pk), length), want,
                      (hq, pq, pk))


    TASKS = {"restore": restore, "attention": attention}

    if __name__ == "__main__":
        mp.start_processes(work, args=tuple(sys.argv[1:4]), nprocs=8,
                           start_method="fork")
""")


def _gloo_world(tmp_path, task: str, arg: str = "") -> None:
    script = tmp_path / "world.py"
    script.write_text(_GLOO_WORLD)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store"), task, arg],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]


def test_restored_recsys_table_gathers_to_the_saved_one(tmp_path):
    """``restore_pytree(shardings=)`` on 8 gloo ranks: a recsys table
    row-sharded over ``("model", "pod", "data")`` (not mesh order) holds
    the reference's rows and its ``full_tensor()`` is the saved table."""
    g = torch.Generator().manual_seed(1)
    (tmp_path / "ckpt").mkdir()
    save_pytree({"table_0": torch.randn((64, 4), generator=g),
                 "table_1": torch.randn((16, 4), generator=g)},
                str(tmp_path / "ckpt"))
    _gloo_world(tmp_path, "restore", str(tmp_path / "ckpt"))


def test_attention_on_dtensors_keeps_heads_local(tmp_path):
    """Blockwise and decode attention on DTensor q / k / v, 8 gloo ranks:
    heads sharded with kv sharded or cut locally, partial projections
    reduce-scattered onto heads, a cache split over its positions (the
    partial softmaxes' all-reduces), a fallback gather; each gathers to
    the plain result."""
    _gloo_world(tmp_path, "attention")
