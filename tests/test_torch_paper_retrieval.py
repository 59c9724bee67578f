"""``paper-retrieval``'s four per-rank steps (group of one) against the
reference's ``distributed_index_search`` / ``distributed_brute_topk`` and its
assignment step on a 1-device mesh, at the smoke config (n = 2,000, D =
128, T = 3, K = 32, probes 6, k = 10, bf16). Both packages get the same
bf16 values, made from one numpy seed.

Tolerances: serve_online's candidate scores and the assignment's
similarities are fp32 sums of exact bf16 products taken in another order
(1e-6 absolute at |score| <= 1.5); serve_brute's scores are those sums
rounded to bf16, so a sum that lands within the summation-order error of a
rounding boundary may round one bf16 ulp apart (2^-8 relative); ids must
be equal (the data has no near ties at the cut, which the tests check).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import paper_retrieval as RP  # noqa: E402
from repro.core import distributed as RD  # noqa: E402
from repro.kernels import topk_score as r_topk_score  # noqa: E402
from repro_torch.configs import paper_retrieval as TP  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.kernels import topk_score  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402

NQ = 16
BF16_ULP = 2.0 ** -8          # relative spacing of bf16 values


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32).to(torch.bfloat16)


def _jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, dtype=jnp.float32)) if getattr(
        x, "dtype", None) == jnp.bfloat16 else np.array(x)


@pytest.fixture(scope="module")
def data():
    cfg = TP.make_smoke_config()
    rng = np.random.default_rng(23)
    fields = []
    for d in cfg.field_dims:
        f = rng.standard_normal((cfg.n_docs, d))
        fields.append(f / np.linalg.norm(f, axis=1, keepdims=True))
    docs = np.concatenate(fields, axis=1) / np.sqrt(len(fields))
    q = rng.standard_normal((NQ, cfg.d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    lead = rng.choice(cfg.n_docs, (cfg.n_clusterings, cfg.k_clusters),
                      replace=False)
    proj = rng.standard_normal((cfg.d, 256)) * 256 ** -0.5
    t = {"docs": _bf16(docs), "qw": _bf16(q)}
    t["leaders"] = t["docs"][torch.as_tensor(lead)]
    t["docs_proj"] = _bf16(t["docs"].float().numpy() @ proj)
    t["qw_proj"] = _bf16(t["qw"].float().numpy() @ proj)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return cfg, t, mesh


def _assign_ref(cfg, t, mesh):
    """The reference's build_assign cell on the 1-device mesh, once per
    clustering (the cell assigns to ``leaders[0]``)."""
    r_cfg = RP.make_smoke_config()
    fn, _, _, _ = RP._build_assign_cell(r_cfg).build(mesh)
    step = jax.jit(fn)
    docs, leaders = _jax(t["docs"]), _jax(t["leaders"])
    return np.stack([np.asarray(step(docs, jnp.roll(leaders, -i, axis=0)))
                     for i in range(cfg.n_clusterings)])


@pytest.fixture(scope="module")
def assigned(data):
    cfg, t, mesh = data
    a_ref = _assign_ref(cfg, t, mesh)
    buckets = RD.build_local_buckets(a_ref, cfg.n_docs, 1, cfg.k_clusters)
    return a_ref, buckets


def test_build_assign_matches_reference(data, assigned):
    cfg, t, _ = data
    a_ref, _ = assigned
    sims = t["docs"].float().numpy() @ t["leaders"].float().numpy().transpose(
        0, 2, 1)                                          # (T, n, K)
    top2 = -np.sort(-sims, axis=-1)[..., :2]
    clear = top2[..., 0] - top2[..., 1] > 1e-5
    assert clear.mean() > 0.99
    fn, _, _, _ = TP._build_assign_cell(cfg).build(AbstractMesh((1, 1), (
        "data", "model")))
    for i in range(cfg.n_clusterings):
        got = TP.build_assign_rank(t["docs"], t["leaders"][i], chunk=300)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy()[clear[i]],
                                      a_ref[i][clear[i]])
    whole = fn(t["docs"], torch.roll(t["leaders"], -1, dims=0))
    np.testing.assert_array_equal(whole.numpy()[clear[1]], a_ref[1][clear[1]])


def test_local_buckets_and_pad(data, assigned):
    cfg, _, _ = data
    a_ref, buckets = assigned
    np.testing.assert_array_equal(
        TD.build_local_buckets(a_ref, cfg.n_docs, 1, cfg.k_clusters), buckets)
    b = buckets.shape[-1]
    padded, overflow = TP.pad_buckets(torch.as_tensor(buckets), b + 8,
                                      cfg.n_docs)
    assert padded.shape[-1] == b + 8 and overflow == 0
    assert (padded[..., b:] == cfg.n_docs).all()
    cut, overflow = TP.pad_buckets(torch.as_tensor(buckets), 8, cfg.n_docs)
    sizes = (buckets < cfg.n_docs).sum(-1)
    assert overflow == int(np.maximum(sizes - 8, 0).sum()) > 0
    assert torch.equal(cut, torch.as_tensor(buckets[..., :8]))


def test_navigation_matches_reference(data):
    cfg, t, _ = data
    probes_t = TP.split_probes(cfg.probes, cfg.n_clusterings)
    assert probes_t == tuple(cfg.probes // 3 for _ in range(3))
    from repro_torch.core.engine import navigate

    ref = np.asarray(RD._navigate(_jax(t["leaders"]), _jax(t["qw"]),
                                  probes_t))
    got = navigate(t["leaders"], t["qw"], probes_t).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("prefilter", [False, True], ids=["online",
                                                          "prefilter"])
def test_serve_online_matches_reference(data, assigned, prefilter):
    cfg, t, mesh = data
    _, buckets = assigned
    probes_t = TP.split_probes(cfg.probes, cfg.n_clusterings)
    kw = {}
    if prefilter:
        kw = dict(docs_proj=_jax(t["docs_proj"]), qw_proj=_jax(t["qw_proj"]),
                  shortlist=64)
    r_s, r_i = RD.distributed_index_search(
        mesh, _jax(t["docs"]), _jax(t["leaders"]), jnp.asarray(buckets),
        _jax(t["qw"]), probes_t=probes_t, k=cfg.k,
        shard_axes=("data", "model"), **kw)
    amesh = AbstractMesh((1, 1), ("data", "model"))
    bkt = torch.as_tensor(buckets)
    if prefilter:
        fn, _, _, _ = TP._serve_pruned_prefilter_cell(cfg, NQ).build(amesh)
        s, i = fn(t["docs"], t["docs_proj"], t["leaders"], bkt, t["qw"],
                  t["qw_proj"])
    else:
        fn, _, _, _ = TP._serve_pruned_cell(cfg, NQ).build(amesh)
        s, i = fn(t["docs"], t["leaders"], bkt, t["qw"])
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    r_s = np.asarray(r_s)
    gaps = r_s[:, :-1] - r_s[:, 1:]
    assert gaps[np.isfinite(gaps)].min() > 1e-6   # no ties within the order error
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(s.numpy(), r_s, atol=1e-6, rtol=0)


def _check_bf16(got_s, got_i, ref_s, ref_i):
    ref_s = _np(ref_s)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), ref_s, rtol=BF16_ULP, atol=0)
    # every score is a bf16 value
    assert torch.equal(got_s, got_s.to(torch.bfloat16).float())


def test_serve_brute_matches_reference(data):
    cfg, t, mesh = data
    r_s, r_i = RD.distributed_brute_topk(
        mesh, _jax(t["docs"]), _jax(t["qw"]), k=cfg.k,
        shard_axes=("data", "model"))
    assert r_s.dtype == jnp.bfloat16
    fn, _, _, _ = TP._serve_brute_cell(cfg, NQ).build(AbstractMesh(
        (1, 1), ("data", "model")))
    before = topk_score.launches
    s, i = fn(t["docs"], t["qw"])
    assert topk_score.launches == before            # the plain version
    _check_bf16(s, i, r_s, r_i)
    # the port's sharded brute force on bf16 shards: the same answer
    for n_shards in (1, 3):
        shards = TD.shard_docs(t["docs"], n_shards)
        s2, i2 = TD.distributed_brute_topk(shards, t["qw"], k=cfg.k,
                                           n_valid=cfg.n_docs)
        _check_bf16(s2, i2, r_s, r_i)


@pytest.mark.parametrize("nq,n,k", [(16, 2000, 10), (5, 777, 33)])
def test_topk_score_bf16_plain_matches_reference_interpret(data, nq, n, k):
    """bf16 inputs, fp32 accumulation: the plain version against the Pallas
    kernel in interpret mode; with ``round_bf16`` against the reference's
    bf16 brute force (its scores rounded before the top-k)."""
    cfg, t, mesh = data
    q, d = t["qw"][:nq], t["docs"][:n]
    r_s, r_i = r_topk_score(_jax(q), _jax(d), k=k, interpret=True)
    s, i = topk_score(q, d, k=k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s), atol=1e-6, rtol=0)
    rb_s, rb_i = RD.distributed_brute_topk(mesh, _jax(d), _jax(q), k=k,
                                           shard_axes=("data", "model"))
    s2, i2 = topk_score(q, d, k=k, round_bf16=True)
    _check_bf16(s2, i2, rb_s, rb_i)
    with pytest.raises(ValueError):
        topk_score(q, d.float(), k=k)               # mixed dtypes


def test_cells_gather_merge_and_group_of_one(data):
    """``gather_merge`` on a group of one is the local list; the cells'
    specs are the reference's (the full comparison is in
    test_torch_configs.py)."""
    s = torch.tensor([[3.0, 1.0, -float("inf")]])
    i = torch.tensor([[7, 2, -1]], dtype=torch.int32)
    gs, gi = TP.gather_merge(s, i, 3)
    assert torch.equal(gs, s) and torch.equal(gi, i)
    assert TP.shard_rank(s) == (0, None)
    assert [c.shape for c in TP.cells()] == [c.shape for c in RP.cells()]
