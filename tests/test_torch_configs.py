"""The port's arch registry and its 44 dry-run cells against the reference
(counterpart of tests/test_configs.py, plus the cell-by-cell comparison).

Both packages build every cell on both production meshes without devices:
the reference on ``jax.sharding.AbstractMesh``, the port on its own
``AbstractMesh``. Each cell must agree in name, kind, ``model_flops``, the
analytic per-chip cost, every argument leaf's shape and dtype, every
leaf's partition spec and the per-chip argument bytes. The port's
parameter names are the reference's tree paths joined by dots; its
optimizer ``step`` is a host int (the reference's 0-d int32 leaf has no
argument counterpart; its spec is ``P()`` in both).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as R  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.configs.common import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.runtime.sharding import P, local_shape  # noqa: E402

LM_SHAPES = {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
GNN_SHAPES = {"full_graph_sm", "minibatch_lg", "ogb_products", "molecule"}
RS_SHAPES = {"train_batch", "serve_p99", "serve_bulk", "retrieval_cand"}
MESHES = {"single": False, "multi": True}


def test_all_archs_registered():
    assert len(T.ASSIGNED_ARCH_IDS) == 10
    assert "paper-retrieval" in T.ARCH_IDS
    assert T.ARCH_IDS == R.ARCH_IDS
    assert T.ASSIGNED_ARCH_IDS == R.ASSIGNED_ARCH_IDS


def test_cell_matrix_complete():
    cells = T.all_cells(T.ASSIGNED_ARCH_IDS)
    assert len(cells) == 40
    assert len(T.all_cells()) == 44
    by_arch = {}
    for c in cells:
        by_arch.setdefault(c.arch, set()).add(c.shape)
    for arch, shapes in by_arch.items():
        if arch == "gcn-cora":
            assert shapes == GNN_SHAPES
        elif arch in ("bst", "dlrm-mlperf", "autoint", "mind"):
            assert shapes == RS_SHAPES
        else:
            assert shapes == LM_SHAPES, arch
    assert [c.shape for c in T.get_arch("paper-retrieval").cells()] == [
        "serve_online", "serve_online_prefilter", "serve_brute",
        "build_assign"]


@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_smoke_configs_exist(arch):
    mod = T.get_arch(arch)
    assert mod.make_config() is not None
    assert mod.make_smoke_config() is not None


def test_assigned_lm_configs_match_spec():
    """The brief's numbers, on the port's configs."""
    c = T.get_arch("llama4-maverick-400b-a17b").make_config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (48, 5120, 40, 8, 8192, 202_048)
    assert c.moe.n_experts == 128 and c.moe.top_k == 1
    c = T.get_arch("qwen2-moe-a2.7b").make_config()
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab) == (
        24, 2048, 16, 1408, 151_936)
    assert c.moe.top_k == 4 and c.moe.n_shared == 4
    c = T.get_arch("mistral-large-123b").make_config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (88, 12_288, 96, 8, 28_672, 32_768)
    c = T.get_arch("minitron-8b").make_config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (32, 4096, 32, 8, 16_384, 256_000)
    c = T.get_arch("qwen3-8b").make_config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (36, 4096, 32, 8, 12_288, 151_936)
    assert c.qk_norm
    g = T.get_arch("gcn-cora").make_config()
    assert (g.n_layers, g.d_hidden, g.d_in) == (2, 16, 1433)
    d = T.get_arch("dlrm-mlperf").make_config()
    assert d.n_dense == 13 and d.n_sparse == 26 and d.embed_dim == 128
    assert d.bot_mlp == (13, 512, 256, 128)
    a = T.get_arch("autoint").make_config()
    assert a.n_fields == 39 and a.embed_dim == 16 and a.n_attn_layers == 3
    b = T.get_arch("bst").make_config()
    assert b.embed_dim == 32 and b.seq_len == 20 and b.n_heads == 8
    m = T.get_arch("mind").make_config()
    assert m.embed_dim == 64 and m.n_interests == 4 and m.capsule_iters == 3


def test_paper_retrieval_config_matches_reference():
    for make in ("make_config", "make_smoke_config"):
        r = getattr(R.get_arch("paper-retrieval"), make)()
        t = getattr(T.get_arch("paper-retrieval"), make)()
        for f in ("name", "n_docs", "field_dims", "n_clusterings",
                  "k_clusters", "bucket_pad", "k", "probes"):
            assert getattr(r, f) == getattr(t, f), f
        assert r.d == t.d and t.dtype == torch.bfloat16
        assert r.spec.names == t.spec.names


# ------------------------------------------------------- cell by cell
def _ref_path(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _ref_leaves(tree, is_spec=False):
    kw = {"is_leaf": lambda x: isinstance(x, PartitionSpec)} if is_spec else {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, **kw)
    return {_ref_path(p): v for p, v in flat}


def _port_leaves(tree):
    return {p.replace(".", "/"): v for p, v in tree_leaves(tree)}


def _norm(spec) -> tuple:
    """A spec as a tuple of axis tuples, trailing replicated dims dropped."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _chip_bytes(shape, itemsize, spec, mesh) -> int:
    return int(np.prod(local_shape(mesh, shape, P(*spec)), dtype=np.int64)
               ) * itemsize


_BUILT: dict = {}


def _built(mesh_name):
    """Both packages' 44 cells built on one production mesh (cached per
    worker: the build is pure)."""
    if mesh_name not in _BUILT:
        multi = MESHES[mesh_name]
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        r_mesh = AbstractMesh(shape, axes)
        t_mesh = make_production_mesh(multi_pod=multi, abstract=True)
        pairs = []
        for rc, tc in zip(R.all_cells(), T.all_cells()):
            pairs.append((rc, tc, rc.build(r_mesh), tc.build(t_mesh)))
        _BUILT[mesh_name] = (r_mesh, t_mesh, pairs)
    return _BUILT[mesh_name]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cells_match_reference(mesh_name):
    r_mesh, t_mesh, pairs = _built(mesh_name)
    assert len(pairs) == 44
    n_leaves = 0
    for rc, tc, (r_fn, r_args, r_in, r_out), (t_fn, t_args, t_in, t_out) \
            in pairs:
        name = rc.name
        assert (tc.arch, tc.shape, tc.kind, tc.note) == (
            rc.arch, rc.shape, rc.kind, rc.note), name
        assert tc.model_flops == pytest.approx(rc.model_flops, rel=1e-12), name
        assert (tc.analytic is None) == (rc.analytic is None), name
        if rc.analytic is not None:
            ra, ta = rc.analytic(r_mesh), tc.analytic(t_mesh)
            for key in ("flops", "bytes"):
                assert ta[key] == pytest.approx(ra[key], rel=1e-12), (name, key)
        assert callable(t_fn) and len(t_args) == len(r_args) == len(t_in)
        ra_l, ta_l = _ref_leaves(r_args), _port_leaves(t_args)
        rs_l, ts_l = _ref_leaves(r_in, True), _port_leaves(t_in)
        assert set(ts_l) == set(rs_l), name
        r_bytes = t_bytes = 0
        for path, r_spec in rs_l.items():
            assert _norm(ts_l[path]) == _norm(r_spec), (name, path)
            r_leaf, t_leaf = ra_l[path], ta_l[path]
            itemsize = np.dtype(r_leaf.dtype).itemsize
            r_bytes += _chip_bytes(r_leaf.shape, itemsize, r_spec, t_mesh)
            if path.endswith("step"):               # the host int
                assert t_leaf == 0 and r_leaf.shape == (), (name, path)
                continue
            assert tuple(t_leaf.shape) == tuple(r_leaf.shape), (name, path)
            assert str(t_leaf.dtype) == f"torch.{np.dtype(r_leaf.dtype).name}"\
                , (name, path)
            assert t_leaf.device.type == "meta"
            t_bytes += _chip_bytes(tuple(t_leaf.shape), t_leaf.element_size(),
                                   ts_l[path], t_mesh)
            n_leaves += 1
        n_steps = sum(p.endswith("step") for p in rs_l)
        assert t_bytes == r_bytes - 4 * n_steps, name
        ro, to = _ref_leaves(r_out, True), _port_leaves(t_out)
        assert set(ro) == set(to), name
        for path, r_spec in ro.items():
            assert _norm(to[path]) == _norm(r_spec), (name, path)
    assert n_leaves > 1000


def test_param_counts_in_band():
    from repro_torch.models.transformer import active_params, count_params

    expect = {
        "llama4-maverick-400b-a17b": (3.5e11, 4.5e11),
        "qwen2-moe-a2.7b": (1.2e10, 1.7e10),
        "mistral-large-123b": (1.1e11, 1.35e11),
        "minitron-8b": (7e9, 1.05e10),
        "qwen3-8b": (7e9, 9.5e9),
    }
    for arch, (lo, hi) in expect.items():
        n = count_params(T.get_arch(arch).make_config())
        assert lo <= n <= hi, f"{arch}: {n:.3e}"
    a = active_params(T.get_arch("llama4-maverick-400b-a17b").make_config())
    assert 1.2e10 <= a <= 2.2e10
