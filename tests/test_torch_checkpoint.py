"""PyTorch port, the checkpoint and fault substrate: the port's
counterparts of ``tests/test_substrate.py``'s checkpoint, straggler and
heartbeat tests (same calls, same outcomes), and the checkpoint directory
as the bridge between the packages: the port flattens a tree in
``jax.tree.flatten``'s order, restores what the reference wrote (fp32,
the 0-d int32 step, bf16 leaves) and writes what the reference writes,
byte for byte. The reference's own fault (a bf16 leaf restores as a void
array) is pinned here too."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as RManager  # noqa: E402
from repro.checkpoint import restore_pytree as r_restore  # noqa: E402
from repro.checkpoint import save_pytree as r_save  # noqa: E402
from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, restore_pytree, save_pytree)
from repro_torch.checkpoint.manager import flatten  # noqa: E402
from repro_torch.configs import get_arch as p_get_arch  # noqa: E402
from repro_torch.launch.train import checkpoint_tree  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.optim import adamw as p_adamw  # noqa: E402
from repro_torch.optim import from_reference_state  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.runtime import FaultCoordinator, StragglerPolicy  # noqa: E402


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits (bf16 through an int16 view)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


# ---------------------------------------- tests/test_substrate.py's, ported
def test_checkpoint_atomic_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(12.0).reshape(3, 4)}
    for s in (1, 2, 3, 4):
        cm.save(s, tree, extra={"s": s})
    assert cm.steps() == [3, 4]
    like = {"w": torch.empty((3, 4), device="meta")}
    restored, step, extra = cm.restore(like)
    assert step == 4 and extra == {"s": 4}
    assert bool(torch.all(restored["w"] == tree["w"]))


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(d)
    tree = {"w": torch.ones((4, 4))}
    save_pytree(tree, d)
    # corrupt the leaf on disk
    path = os.path.join(d, "leaf_00000.npy")
    arr = np.load(path)
    arr[0, 0] = 123.0
    np.save(path, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_pytree(tree, d)


def test_checkpoint_shape_mismatch(tmp_path):
    d = str(tmp_path / "c")
    os.makedirs(d)
    save_pytree({"w": torch.ones((4, 4))}, d)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({"w": torch.ones((2, 2))}, d)


def test_straggler_policy():
    pol = StragglerPolicy(threshold=1.5, patience=3)
    hist = {}
    for _ in range(2):
        evict = pol.update(hist, {0: 1.0, 1: 1.0, 2: 5.0})
        assert evict == []
    evict = pol.update(hist, {0: 1.0, 1: 1.0, 2: 5.0})
    assert evict == [2]
    # recovery resets the count
    pol.update(hist, {0: 1.0, 1: 1.0, 2: 1.0})
    assert hist[2] == 0


def test_fault_coordinator_heartbeats():
    fc = FaultCoordinator(heartbeat_timeout=10.0)
    fc.beat(0, now=100.0)
    fc.beat(1, now=105.0)
    assert fc.dead_workers(now=109.0) == []
    assert fc.dead_workers(now=112.0) == [0]


# ------------------------------------------------- the manager's own rules
def test_checkpoint_crc_is_checked_before_the_shape(tmp_path):
    """A corrupt leaf of the wrong shape raises the checksum error."""
    d = str(tmp_path / "c")
    os.makedirs(d)
    save_pytree({"w": torch.ones((4, 4))}, d)
    np.save(os.path.join(d, "leaf_00000.npy"), np.zeros((2, 2), np.float32))
    with pytest.raises(IOError, match="checksum"):
        restore_pytree({"w": torch.ones((2, 2))}, d)


def test_steps_skip_tmp_and_unfinished_dirs_and_gc_runs_after_a_write(
        tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, {"w": torch.ones(2)})
    cm.save(2, {"w": torch.ones(2)})
    os.makedirs(tmp_path / "step_0000000009.tmp")       # a preempted write
    os.makedirs(tmp_path / "step_0000000008")           # no manifest
    assert cm.steps() == [1, 2] and cm.latest_step() == 2
    with pytest.raises(TypeError, match="not a checkpoint leaf"):
        cm.save(3, {"w": torch.ones(2), "bad": "text"})
    assert cm.steps() == [1, 2]                          # nothing deleted
    assert not os.path.exists(cm._step_dir(3))
    cm.save(3, {"w": torch.ones(2)})
    assert cm.steps() == [2, 3]


def test_restore_onto_each_leafs_device_and_dtype(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "n": 7, "z": None}
    m = save_pytree(tree, d)
    assert m["n_leaves"] == 3
    assert [e["dtype"] for e in m["leaves"]] == ["float32", "bfloat16",
                                                 "int32"]
    assert m["treedef"] == "{'a': *, 'b': *, 'n': *, 'z': None}"
    like = {"a": torch.empty((2, 3), dtype=torch.float64, device="meta"),
            "b": torch.zeros(2, dtype=torch.bfloat16), "n": 0, "z": None}
    out = restore_pytree(like, d)
    assert out["a"].dtype == torch.float64 and out["a"].device.type == "cpu"
    assert out["a"].tolist() == tree["a"].tolist()
    assert out["b"].dtype == torch.bfloat16
    assert np.array_equal(_bits(out["b"]), _bits(tree["b"]))
    assert out["n"] == 7 and isinstance(out["n"], int) and out["z"] is None


# ----------------------------------------------------- the bridge: order
def test_leaf_order_matches_jax_tree_flatten_at_qwen2_moe_smoke():
    """``{"params", "opt_state"}`` flattens in ``jax.tree.flatten``'s
    order: the step, the first moments, the second moments, the
    parameters, each by sorted path (49 leaves at qwen2-moe's smoke
    config). Every reference leaf holds distinct random values, carried
    to the port, so a leaf in the wrong place shows."""
    rc = r_get_arch("qwen2-moe-a2.7b").make_smoke_config()
    pc = p_get_arch("qwen2-moe-a2.7b").make_smoke_config()
    params = RT.init_params(rc, jax.random.PRNGKey(0))
    state = r_adamw(1e-3).init(params)
    rng = np.random.default_rng(0)
    state = state._replace(
        step=jnp.asarray(5, jnp.int32),
        mu=jax.tree.map(lambda x: rng.normal(size=x.shape)
                        .astype(np.float32), state.mu),
        nu=jax.tree.map(lambda x: rng.random(x.shape)
                        .astype(np.float32), state.nu))
    want, _ = jax.tree.flatten({"params": params, "opt_state": state})
    model = PT.from_reference_params(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    p_params = dict(model.named_parameters())
    p_state = from_reference_state(
        AdamWState(step=state.step, mu=PT._flatten(state.mu),
                   nu=PT._flatten(state.nu)),
        p_adamw(1e-3).init(p_params))
    got = flatten(checkpoint_tree(p_params, p_state))
    assert len(got) == len(want) == 49
    assert got[0] == 5
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.detach().numpy(), np.asarray(w))


# ---------------------------------------------- the bridge: both directions
def _mixed_tree():
    """The same values as a reference tree and a port tree: an fp32
    matrix, a 0-d int32 step and a bf16 vector."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    ref = {"opt": {"step": jnp.asarray(12, jnp.int32)},
           "w": jnp.asarray(w), "b16": jnp.asarray(b, jnp.bfloat16)}
    port = {"opt": {"step": 12}, "w": torch.tensor(w),
            "b16": torch.tensor(b).to(torch.bfloat16)}
    return ref, port


def test_reference_directory_restores_in_the_port(tmp_path):
    ref, port = _mixed_tree()
    rm = RManager(str(tmp_path))
    rm.save(3, ref, extra={"losses_tail": [1.0]})
    like = {"opt": {"step": 0}, "w": torch.zeros(3, 5),
            "b16": torch.zeros(7, dtype=torch.bfloat16)}
    out, step, extra = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 3 and extra == {"losses_tail": [1.0]}
    assert out["opt"]["step"] == 12 and isinstance(out["opt"]["step"], int)
    assert np.array_equal(out["w"].numpy(), np.asarray(ref["w"]))
    assert out["b16"].dtype == torch.bfloat16
    assert np.array_equal(_bits(out["b16"]),
                          np.asarray(ref["b16"]).view(np.int16))
    assert np.array_equal(_bits(out["b16"]), _bits(port["b16"]))


def test_port_directory_restores_in_the_reference(tmp_path):
    """The port's files are the reference's, byte for byte (bf16 and the
    step included), with the same crc32s; the reference restores the
    fp32 and int32 leaves. (Its bf16 restore is its own fault, below.)"""
    ref, port = _mixed_tree()
    rd, pd = tmp_path / "r", tmp_path / "p"
    os.makedirs(rd)
    os.makedirs(pd)
    rman = r_save(ref, str(rd))
    pman = save_pytree(port, str(pd))
    assert pman["n_leaves"] == rman["n_leaves"] == 3
    assert pman["leaves"] == rman["leaves"]
    for e in rman["leaves"]:
        assert (rd / e["path"]).read_bytes() == (pd / e["path"]).read_bytes()
    with open(pd / "manifest.json") as f:
        assert json.load(f)["treedef"] == \
            "{'b16': *, 'opt': {'step': *}, 'w': *}"
    out = r_restore({"opt": {"step": ref["opt"]["step"]}, "w": ref["w"],
                     "b16": ref["b16"]}, str(pd))
    assert int(out["opt"]["step"]) == 12
    assert np.array_equal(np.asarray(out["w"]), np.asarray(ref["w"]))
    assert np.asarray(out["b16"]).tobytes() == \
        np.asarray(ref["b16"]).tobytes()


def test_reference_restore_of_bf16_leaf_is_void(tmp_path):
    """The reference's fault (ROADMAP Queue 3): ``np.save`` writes a bf16
    leaf under a ``<V2`` descr, ``np.load`` gives back a ``|V2`` void
    array, and ``restore_pytree`` (manager.py:95-105) returns it as the
    leaf, which ``jax.jit`` rejects. So the reference's ``train_lm``
    cannot resume a bf16 config; the port reads the same file as bf16."""
    d = str(tmp_path)
    tree = {"w": jnp.asarray([1.0, 2.0, 3.0], jnp.bfloat16)}
    r_save(tree, d)
    with open(os.path.join(d, "leaf_00000.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    out = r_restore(tree, d)
    assert out["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jax.jit(lambda x: x)(out["w"])
    port = restore_pytree({"w": torch.zeros(3, dtype=torch.bfloat16)}, d)
    assert port["w"].tolist() == [1.0, 2.0, 3.0]
