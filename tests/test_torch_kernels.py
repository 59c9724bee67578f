"""PyTorch port, kernels: the plain versions of ``fpf_iter`` and
``bucket_score_tiled`` against the JAX kernels (Pallas in interpret mode,
as the reference's own tests run them on the CPU), the merge's tie rule,
the probe schedules and the int8 quantisation. The hand-written kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels as RK  # noqa: E402
from repro.core import fpf_centers as r_fpf_centers  # noqa: E402
from repro_torch import kernels as PK  # noqa: E402
from repro_torch.kernels.bucket_score.ref import merge_topk_ref  # noqa: E402

QT = 8


# ------------------------------------------------------------------ fpf_iter
def _grid_points(rng, m, d):
    """Points on a 1/8 grid: every dot product is exact in fp32, so equal
    rows give exactly equal similarities in both packages."""
    return (rng.integers(-4, 5, size=(m, d)) / 8.0).astype(np.float32)


@pytest.mark.parametrize("m", [1, 7, 100, 1033])
@pytest.mark.parametrize("tie", [False, True])
def test_fpf_iter_plain_matches_jax(m, tie):
    rng = np.random.default_rng(m)
    d = 48
    x = _grid_points(rng, m, d)
    cur = int(rng.integers(0, m))
    maxsim = (rng.integers(-8, 8, size=m) / 16.0).astype(np.float32)
    if tie and m > 2:
        # duplicate the argmin row (and its maxsim) at a LOWER index: the
        # first index must win in both packages
        new = np.maximum(maxsim, x.astype(np.float64) @ x[cur])
        j = int(np.argmin(new))
        i = 0 if j != 0 else 1
        if i > j:
            i, j = j, i
        x[i], maxsim[i] = x[j], maxsim[j]
        cur = cur if cur not in (i, j) else (j + 1) % m
    r_new, r_idx, r_val = RK.fpf_iter(
        jnp.asarray(x), jnp.asarray(x[cur]), jnp.asarray(maxsim)
    )
    p_new, p_idx, p_val = PK.fpf_iter(
        torch.as_tensor(x), torch.tensor(cur, dtype=torch.int32),
        torch.as_tensor(maxsim),
    )
    np.testing.assert_allclose(p_new.numpy(), np.asarray(r_new), atol=1e-6)
    assert int(p_idx) == int(r_idx)
    assert float(p_val) == pytest.approx(float(r_val), abs=1e-6)
    if tie and m > 2:
        assert int(p_idx) == min(i, j)


def test_fpf_centers_fused_plain_matches_jax_fpf_centers():
    x = jax.random.normal(jax.random.PRNGKey(3), (400, 96))
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(5)
    want = np.asarray(r_fpf_centers(x, 12, key))
    first = int(jax.random.randint(key, (), 0, 400, dtype=jnp.int32))
    xt = torch.as_tensor(np.asarray(x))
    got = PK.fpf_centers_fused(xt, 12, first)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    from repro_torch.core import fpf_centers

    assert fpf_centers(xt, 12, first).tolist() == want.tolist()


# ------------------------------------------------------- bucket_score_tiled
def _pack(seed, *, n=96, t=3, k_per=4, b=32, d=64):
    """A bucket-major pack shaped like a real index: T clusterings, each a
    partition of the n docs into K buckets (-1 padding), so every doc sits
    in up to T buckets and duplicates across clusterings are real."""
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    ids = np.full((t * k_per, b), -1, np.int32)
    for ti in range(t):
        perm = rng.permutation(n)
        keep = perm[: int(0.9 * n)]
        parts = np.array_split(keep, k_per)
        for c, part in enumerate(parts):
            ids[ti * k_per + c, : len(part)] = part
    data = docs[np.where(ids >= 0, ids, 0)]
    return docs, data, ids


def _jax_pack(data, dtype):
    if dtype == "float32":
        return jnp.asarray(data), None
    if dtype == "bfloat16":
        return jnp.asarray(data).astype(jnp.bfloat16), None
    q, s = RK.quantize_bucket_major(jnp.asarray(data))
    return q, s


def _torch_pack(data, dtype):
    if dtype == "float32":
        return torch.as_tensor(data), None
    if dtype == "bfloat16":
        return torch.as_tensor(data).to(torch.bfloat16), None
    return PK.quantize_bucket_major(torch.as_tensor(data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nq", [1, QT - 1, QT + 1, 3 * QT + 5])
def test_bucket_score_tiled_plain_matches_jax(nq, dtype):
    """Ragged batches, per-query exclude, tiles whose queries share
    buckets, duplicates across clusterings: fp32 ids equal and scores
    within 1e-5; bf16/int8 scores within 1e-2."""
    docs, data, ids = _pack(nq)
    rng = np.random.default_rng(100 + nq)
    n_buckets, k = ids.shape[0], 10
    probes = rng.integers(0, n_buckets, size=(nq, 3)).astype(np.int32)
    q = rng.normal(size=(nq, docs.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    exclude = np.where(np.arange(nq) % 2 == 0, ids[probes[:, 0], 0], -1)
    exclude = exclude.astype(np.int32)
    sched, member = RK.build_probe_schedule(probes, QT)
    assert any(member[t].any(-1).sum() < member[t].sum() for t in
               range(member.shape[0])) or nq == 1   # shared buckets in a tile
    jd, js = _jax_pack(data, dtype)
    r_s, r_i = RK.bucket_score_tiled(
        jnp.asarray(q), jd, jnp.asarray(ids), jnp.asarray(sched),
        jnp.asarray(member), k=k, exclude=jnp.asarray(exclude), scales=js,
    )
    td, ts = _torch_pack(data, dtype)
    if dtype == "int8":
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    p_s, p_i = PK.bucket_score_tiled(
        torch.as_tensor(q), td, torch.as_tensor(ids), torch.as_tensor(sched),
        torch.as_tensor(member), k=k, exclude=torch.as_tensor(exclude),
        scales=ts,
    )
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    assert p_s.shape == r_s.shape == (nq, k)
    if dtype == "float32":
        # exact-id parity is meaningful only without a near tie at the k-th
        # boundary: check the data has none
        fin = np.isfinite(r_s)
        gaps = np.abs(np.diff(r_s, axis=1))[fin[:, 1:]]
        assert gaps.size == 0 or gaps.min() > 1e-5
        np.testing.assert_array_equal(p_i.numpy(), r_i)
        np.testing.assert_allclose(p_s.numpy(), r_s, atol=1e-5)
    else:
        np.testing.assert_allclose(p_s.numpy(), r_s, atol=1e-2)
    # the engine's -1 for empty slots, and excluded ids never come back
    for row, ex in zip(p_i.numpy(), exclude):
        assert ex < 0 or ex not in row.tolist()


def test_merge_tie_rule_matches_lax_top_k():
    """Ties go to the accumulator, then to the lower candidate position;
    -inf slots keep id -1 — exactly lax.top_k over [acc, candidates]."""
    ninf = float("-inf")
    acc_s = np.asarray([[0.9, 0.5, 0.5, ninf], [0.3, ninf, ninf, ninf]],
                       np.float32)
    acc_i = np.asarray([[4, 7, 2, -1], [9, -1, -1, -1]], np.int32)
    cand_s = np.asarray([[0.5, 0.7, 0.5, 0.9, ninf],
                         [0.3, 0.3, ninf, 0.3, 0.3]], np.float32)
    cand_i = np.asarray([[11, 12, 13, 14, 15], [21, 22, 23, 24, 25]],
                        np.int32)
    cat_s = np.concatenate([acc_s, cand_s], axis=1)
    cat_i = np.concatenate([acc_i, cand_i], axis=1)
    top_s, pos = jax.lax.top_k(jnp.asarray(cat_s), 4)
    want_i = np.take_along_axis(cat_i, np.asarray(pos), axis=1)
    got_s, got_i = merge_topk_ref(
        torch.as_tensor(acc_s), torch.as_tensor(acc_i),
        torch.as_tensor(cand_s), torch.as_tensor(cand_i), 4,
    )
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(top_s))
    assert got_i.numpy().tolist() == [[4, 14, 12, 7], [9, 21, 22, 24]]


def test_bucket_score_tiled_equal_scores_follow_reference_order():
    """Different docs with EXACTLY equal scores (duplicate vectors on a
    1/8 grid): the returned order equals the JAX kernel's — first arrival
    (slot order, then row order) wins."""
    rng = np.random.default_rng(7)
    base = _grid_points(rng, 6, 32)
    docs = base[rng.integers(0, 6, size=40)]          # many exact ties
    ids = np.full((5, 8), -1, np.int32)
    perm = rng.permutation(40)
    ids.reshape(-1)[:40] = perm
    data = docs[np.where(ids >= 0, ids, 0)]
    q = _grid_points(rng, 9, 32)
    probes = rng.integers(0, 5, size=(9, 2)).astype(np.int32)
    sched, member = RK.build_probe_schedule(probes, QT)
    r_s, r_i = RK.bucket_score_tiled(
        jnp.asarray(q), jnp.asarray(data), jnp.asarray(ids),
        jnp.asarray(sched), jnp.asarray(member), k=12,
    )
    p_s, p_i = PK.bucket_score_tiled(
        torch.as_tensor(q), torch.as_tensor(data), torch.as_tensor(ids),
        torch.as_tensor(sched), torch.as_tensor(member), k=12,
    )
    np.testing.assert_array_equal(p_s.numpy(), np.asarray(r_s))
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))


def test_bucket_score_tiled_validates_inputs():
    _, data, ids = _pack(0)
    q = torch.zeros((3, data.shape[2]))
    sched, member = RK.build_probe_schedule(np.zeros((3, 2), np.int32), QT)
    args = (q, torch.as_tensor(data), torch.as_tensor(ids),
            torch.as_tensor(sched), torch.as_tensor(member))
    vals, _ = PK.quantize_bucket_major(torch.as_tensor(data))
    with pytest.raises(ValueError, match="scales"):
        PK.bucket_score_tiled(q, vals, *args[2:], k=4)
    with pytest.raises(ValueError, match="exclude"):
        PK.bucket_score_tiled(*args, k=4, exclude=torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="covers"):
        PK.bucket_score_tiled(torch.zeros((20, data.shape[2])), *args[1:], k=4)


# ------------------------------------------------ schedules, quantisation
@pytest.mark.parametrize("nq", [1, 7, 8, 9, 29])
@pytest.mark.parametrize("qt,p,nb", [(8, 3, 20), (8, 6, 12), (4, 5, 40)])
def test_build_probe_schedule_device_matches_reference(nq, qt, p, nb):
    rng = np.random.default_rng(nq * 31 + qt + p)
    probes = rng.integers(0, nb, size=(nq, p)).astype(np.int32)
    probes[0, 0] = -1                     # invalid entries are ignored
    s_len = PK.schedule_length(qt, p, nb)
    assert s_len == RK.schedule_length(qt, p, nb)
    r_sched, r_mem = RK.build_probe_schedule_device(
        jnp.asarray(probes), query_tile=qt, s_len=s_len)
    p_sched, p_mem = PK.build_probe_schedule_device(
        torch.as_tensor(probes), query_tile=qt, s_len=s_len)
    np.testing.assert_array_equal(p_sched.numpy(), np.asarray(r_sched))
    np.testing.assert_array_equal(p_mem.numpy(), np.asarray(r_mem))
    h_sched, h_mem = PK.build_probe_schedule(probes, qt)
    rh_sched, rh_mem = RK.build_probe_schedule(probes, qt)
    np.testing.assert_array_equal(h_sched, rh_sched)
    np.testing.assert_array_equal(h_mem, rh_mem)
    for t in range(h_sched.shape[0]):       # device == host on live slots
        live_d = p_mem[t].any(-1).numpy()
        live_h = h_mem[t].any(-1)
        np.testing.assert_array_equal(p_sched[t].numpy()[live_d],
                                      h_sched[t][live_h])
        np.testing.assert_array_equal(p_mem[t].numpy()[live_d],
                                      h_mem[t][live_h])
    assert PK.schedule_block_reads(p_mem) == int(h_mem.any(-1).sum())


def test_quantize_and_pack_bit_identical():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2, 5, 16, 32)).astype(np.float32)
    data[1, 3] = 0.0                                  # all-zero bucket
    data[0, 1, 0, :4] = [0.5, -0.5, 1.5, 2.5]         # .5 cases at scale 1
    r_q, r_s = RK.quantize_bucket_major(jnp.asarray(data))
    p_q, p_s = PK.quantize_bucket_major(torch.as_tensor(data), chunk=3)
    np.testing.assert_array_equal(p_q.numpy(), np.asarray(r_q))
    np.testing.assert_array_equal(p_s.numpy(), np.asarray(r_s))
    np.testing.assert_allclose(
        PK.dequantize_bucket_major(p_q, p_s).numpy(),
        np.asarray(RK.dequantize_bucket_major(r_q, r_s)), atol=0)
    docs, _, ids = _pack(1)
    for tdt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16),
                     (torch.int8, jnp.int8)):
        pd, pi, ps = PK.pack_bucket_major(torch.as_tensor(docs),
                                          torch.as_tensor(ids), dtype=tdt,
                                          chunk=5)
        rd, ri, rs = RK.pack_bucket_major(jnp.asarray(docs), jnp.asarray(ids),
                                          dtype=jdt)
        np.testing.assert_array_equal(pd.float().numpy(),
                                      np.asarray(rd).astype(np.float32))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        assert (ps is None) == (rs is None)
        if ps is not None:
            np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def test_pick_query_tile_fits_shared_memory():
    from repro_torch.kernels.bucket_score.ops import (
        SMEM_BYTES_PER_BLOCK, smem_bytes)

    assert PK.pick_query_tile(2048, 800, k_pad=16) == 16
    assert PK.pick_query_tile(2048, 5000, k_pad=40, pack_itemsize=1) == 16
    assert PK.pick_query_tile(4096, 800, k_pad=16) == 8
    assert smem_bytes(16, 2048, 16, 4) <= SMEM_BYTES_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        PK.pick_query_tile(8192, 800, k_pad=16)


# ---------------------------------------------------------------- topk_score
@pytest.mark.parametrize("nq,n,k", [(5, 300, 10), (9, 130, 128), (3, 40, 50)])
def test_topk_score_plain_matches_jax(nq, n, k):
    """Against the JAX kernel (interpret mode) and its oracle: per-query
    exclude, k above the eligible rows (-inf with id -1; the JAX kernel's
    k_pad stops at its doc block), ids equal and scores within 1e-5."""
    rng = np.random.default_rng(n + k)
    q = rng.normal(size=(nq, 48)).astype(np.float32)
    docs = rng.normal(size=(n, 48)).astype(np.float32)
    ex = rng.integers(-1, n, size=nq).astype(np.int32)
    p_s, p_i = PK.topk_score(torch.as_tensor(q), torch.as_tensor(docs), k=k,
                             exclude=torch.as_tensor(ex), chunk=64)
    assert p_s.shape == p_i.shape == (nq, k)
    r_s, r_i = RK.topk_score(jnp.asarray(q), jnp.asarray(docs), k=k,
                             exclude=jnp.asarray(ex), block_n=128)
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    kk = r_s.shape[1]                     # min(k, JAX's k_pad)
    np.testing.assert_array_equal(p_i.numpy()[:, :kk], r_i)
    np.testing.assert_allclose(p_s.numpy()[:, :kk], r_s, atol=1e-5)
    o_s, o_i = RK.topk_score_ref(jnp.asarray(q), jnp.asarray(docs),
                                 min(k, n), exclude=jnp.asarray(ex))
    fin = np.isfinite(np.asarray(o_s))
    np.testing.assert_array_equal(p_i.numpy()[:, :min(k, n)][fin],
                                  np.asarray(o_i)[fin])
    valid = n - np.sum(ex >= 0, keepdims=True).clip(0, 1) * (ex >= 0)[:, None]
    for row, v in zip(p_i.numpy(), valid.reshape(-1)):
        assert np.all(row[v:] == -1) and np.all(row[:min(v, k)] >= 0)
    assert not np.any(p_i.numpy() == ex[:, None])


def test_topk_score_plain_ties_and_mask_follow_reference():
    """Exactly equal scores (duplicate vectors on a 1/8 grid): the lower id
    first, across chunks, as the reference's brute force; masked rows never
    return."""
    rng = np.random.default_rng(2)
    base = _grid_points(rng, 5, 32)
    docs = base[rng.integers(0, 5, size=500)]
    q = _grid_points(rng, 4, 32)
    mask = rng.random(500) > 0.2
    import repro.core as R

    r_s, r_i = R.brute_force_topk(jnp.asarray(docs), jnp.asarray(q), 60,
                                  mask=jnp.asarray(mask), chunk=128)
    p_s, p_i = PK.topk_score(torch.as_tensor(q), torch.as_tensor(docs), k=60,
                             mask=torch.as_tensor(mask), chunk=100)
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(r_i))
    np.testing.assert_array_equal(p_s.numpy(), np.asarray(r_s))
    assert mask[p_i.numpy()].all()


def test_topk_score_validates_inputs():
    q, docs = torch.zeros((2, 8)), torch.zeros((5, 8))
    with pytest.raises(ValueError, match="docs"):
        PK.topk_score(q, torch.zeros((5, 7)), k=2)
    with pytest.raises(ValueError, match="k must be"):
        PK.topk_score(q, docs, k=0)
    with pytest.raises(ValueError, match="mask"):
        PK.topk_score(q, docs, k=2, mask=torch.ones(5))
    with pytest.raises(ValueError, match="exclude"):
        PK.topk_score(q, docs, k=2, exclude=torch.zeros(3, dtype=torch.int32))


# ------------------------------------------------------- bucket_score (v1)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [10, 40])
def test_bucket_score_v1_plain_matches_jax(dtype, k):
    """The v1 kernel (interpret mode) on fp32 and bf16 packs: duplicates
    across clusterings, a bucket probed twice, per-query exclude; fp32 ids
    equal and scores within 1e-5 (bf16: the pack is widened against the fp32
    query on both sides, so the same 1e-5)."""
    docs, data, ids = _pack(k)
    rng = np.random.default_rng(k)
    nq = 7
    probes = rng.integers(0, ids.shape[0], size=(nq, 5)).astype(np.int32)
    probes[:, 4] = probes[:, 0]
    q = rng.normal(size=(nq, docs.shape[1])).astype(np.float32)
    ex = ids[probes[:, 1], 0].astype(np.int32)
    jd, _ = _jax_pack(data, dtype)
    td, _ = _torch_pack(data, dtype)
    r_s, r_i = RK.bucket_score(jnp.asarray(q), jd, jnp.asarray(ids),
                               jnp.asarray(probes), k=k,
                               exclude=jnp.asarray(ex))
    p_s, p_i = PK.bucket_score(torch.as_tensor(q), td, torch.as_tensor(ids),
                               torch.as_tensor(probes), k=k,
                               exclude=torch.as_tensor(ex))
    r_s, r_i = np.asarray(r_s), np.asarray(r_i)
    assert p_s.shape == r_s.shape
    np.testing.assert_allclose(p_s.numpy(), r_s, atol=1e-5)
    np.testing.assert_array_equal(p_i.numpy(), r_i)
    ids_p = p_i.numpy()
    for row in ids_p:                     # each doc once despite T buckets
        live = row[row >= 0]
        assert live.size == np.unique(live).size
    assert not np.any(ids_p == ex[:, None])


def test_bucket_score_v1_refuses_int8():
    _, data, ids = _pack(0)
    vals, _ = PK.quantize_bucket_major(torch.as_tensor(data))
    with pytest.raises(ValueError, match="int8"):
        PK.bucket_score(torch.zeros((2, data.shape[2])), vals,
                        torch.as_tensor(ids),
                        torch.zeros((2, 3), dtype=torch.int32), k=4)


def test_split_query_tiles_keeps_the_answers():
    """A tile cut into sub-tiles (what the CUDA path launches for a tile
    wider than the kernel takes) gives the same plain-version answers."""
    from repro_torch.kernels.bucket_score.ops import split_query_tiles

    docs, data, ids = _pack(3, d=40)
    rng = np.random.default_rng(3)
    nq = 45
    probes = rng.integers(0, ids.shape[0], size=(nq, 4)).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=(nq, 40)).astype(np.float32))
    ex = torch.as_tensor(ids[probes[:, 0], 1])
    args = (torch.as_tensor(data), torch.as_tensor(ids))
    for qt, cap in ((32, 16), (20, 8), (7, 8)):
        sched, member = (torch.as_tensor(x) for x in
                         PK.build_probe_schedule(probes, qt))
        want = PK.bucket_score_tiled_ref(q, *args, sched, member, k=10,
                                         exclude=ex)
        q2, s2, m2, e2, unsplit = split_query_tiles(q, sched, member, ex, cap)
        assert m2.shape[-1] <= cap and s2.shape[0] == m2.shape[0]
        got = PK.bucket_score_tiled_ref(q2, *args, s2, m2, k=10, exclude=e2)
        assert torch.equal(unsplit(got[0]), want[0])
        assert torch.equal(unsplit(got[1]), want[1])


# ----------------------------------------------------------------- embed_bag
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_bag_plain_matches_jax(combiner, weighted, dtype):
    """Against the JAX kernel (interpret mode): -1 padding, an all-padding
    bag (zeros), per-sample weights. fp32 within 1e-5; bf16 within 5e-2
    (the JAX kernel adds in bf16, the port in fp32 with one rounding). The
    JAX kernel cannot divide a bf16 bag by its fp32 count in interpret
    mode, so a bf16 mean is held against the JAX oracle (``embed_bag_ref``,
    bf16 throughout) instead."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(60, 16)).astype(np.float32)
    idx = rng.integers(-1, 60, size=(9, 5)).astype(np.int32)
    idx[2] = -1
    w = rng.random((9, 5)).astype(np.float32) if weighted else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jax_fn = (RK.embed_bag_ref if dtype == "bfloat16" and combiner == "mean"
              else RK.embed_bag)
    r = jax_fn(jnp.asarray(table).astype(jdt), jnp.asarray(idx),
               None if w is None else jnp.asarray(w), combiner=combiner)
    p = PK.embed_bag(torch.as_tensor(table).to(tdt), torch.as_tensor(idx),
                     None if w is None else torch.as_tensor(w),
                     combiner=combiner)
    assert p.dtype == tdt and p.shape == (9, 16)
    atol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(r).astype(np.float32), atol=atol)
    assert torch.all(p[2] == 0)
    ro = RK.embed_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                          None if w is None else jnp.asarray(w),
                          combiner=combiner)
    np.testing.assert_allclose(
        PK.embed_bag_ref(torch.as_tensor(table), torch.as_tensor(idx),
                         None if w is None else torch.as_tensor(w),
                         combiner=combiner).numpy(), np.asarray(ro),
        atol=1e-5)


def test_embed_bag_rejects_bad_combiner():
    with pytest.raises(ValueError, match="combiner"):
        PK.embed_bag(torch.zeros((4, 2)), torch.zeros((1, 1),
                                                      dtype=torch.int32),
                     combiner="max")
    with pytest.raises(ValueError, match="combiner"):
        RK.embed_bag(jnp.zeros((4, 2)), jnp.zeros((1, 1), jnp.int32),
                     combiner="max")
