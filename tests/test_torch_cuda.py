"""PyTorch port on the card: the hand-written CUDA kernels
(``bucket_score_tiled``, ``bucket_score`` v1, ``topk_score``, ``embed_bag``,
``fpf_iter``) against their plain PyTorch versions, the fused engine
against the reference engine, a build repeated on the card, and the
sharded backend (one shard's kernel call, the engine against the CPU), the
LM family, the training driver's checkpoints and the GCN.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as P  # noqa: E402
from repro_torch import kernels as PK  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    return PK.resolve_device("cuda")


def _pack(seed, *, n=400, t=3, k_per=8, b=64, d=256):
    """T clusterings, each a partition of n docs into buckets (-1 padding):
    duplicates across clusterings, padded tails."""
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    ids = np.full((t * k_per, b), -1, np.int32)
    for ti in range(t):
        keep = rng.permutation(n)[: int(0.9 * n)]
        for c, part in enumerate(np.array_split(keep, k_per)):
            ids[ti * k_per + c, : len(part)] = part
    return docs, ids


@pytest.mark.parametrize("m", [1, 33, 5622])
def test_fpf_iter_kernel_matches_plain(cuda_device, m):
    g = torch.Generator().manual_seed(m)
    x = torch.nn.functional.normalize(torch.randn(m, 256, generator=g), dim=1)
    x = x.to(cuda_device)
    ms = torch.full((m,), float("-inf"), device=cuda_device)
    cur = torch.tensor(m // 2, dtype=torch.int32, device=cuda_device)
    before = PK.fpf_iter.launches
    for _ in range(3):
        got = PK.fpf_iter(x, cur, ms)
        want = PK.fpf_iter_ref(x, cur, ms)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
        assert int(got[1]) == int(want[1])
        ms, cur = want[0], want[1]
    assert PK.fpf_iter.launches == before + 3
    k = min(m, 20)
    assert (PK.fpf_centers_fused(x, k, 0).tolist()
            == PK.fpf_centers_fused(x.cpu(), k, 0).tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nq,qt", [(1, 8), (7, 8), (17, 16), (29, 8)])
def test_bucket_score_tiled_kernel_matches_plain(cuda_device, dtype, nq, qt):
    docs, ids = _pack(nq)
    rng = np.random.default_rng(nq)
    probes = rng.integers(0, ids.shape[0], size=(nq, 4)).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=(nq, 256)).astype(np.float32),
                        device=cuda_device)
    exclude = np.where(np.arange(nq) % 2 == 0, ids[probes[:, 0], 0], -1)
    sched, member = PK.build_probe_schedule(probes, qt)
    data, ids_t, scales = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device),
        dtype=None if dtype == torch.float32 else dtype)
    args = (q, data, ids_t, torch.as_tensor(sched, device=cuda_device),
            torch.as_tensor(member, device=cuda_device))
    kw = dict(k=10, scales=scales, exclude=torch.as_tensor(
        exclude.astype(np.int32), device=cuda_device))
    before = PK.bucket_score_tiled.launches
    got = PK.bucket_score_tiled(*args, **kw)
    assert PK.bucket_score_tiled.launches == before + 1
    want = PK.bucket_score_tiled_ref(*args, **kw)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    if dtype == torch.float32:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_bucket_score_tiled_kernel_deep_list(cuda_device, dtype):
    """k_pad = 40 (the exact tier's rescore depth on a quantised pack) over
    every bucket, as search_exact schedules it."""
    docs, ids = _pack(5)
    nq, n_buckets = 21, ids.shape[0]
    q = torch.as_tensor(np.random.default_rng(5).normal(
        size=(nq, 256)).astype(np.float32), device=cuda_device)
    probes = np.tile(np.arange(n_buckets, dtype=np.int32), (nq, 1))
    sched, member = PK.build_probe_schedule_device(
        torch.as_tensor(probes, device=cuda_device), query_tile=16,
        s_len=PK.schedule_length(16, n_buckets, n_buckets))
    data, ids_t, scales = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device),
        dtype=None if dtype == torch.float32 else dtype)
    got = PK.bucket_score_tiled(q, data, ids_t, sched, member, k=40,
                                scales=scales)
    want = PK.bucket_score_tiled_ref(q, data, ids_t, sched, member, k=40,
                                     scales=scales)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    if dtype == torch.float32:
        assert torch.equal(got[1], want[1])


def test_bucket_score_tiled_raises_instead_of_falling_back(cuda_device):
    """Bad dtypes and shapes raise on the card; nothing falls back to the
    plain version (whose launch count would not move)."""
    docs, ids = _pack(0, d=40)
    data, ids_t, _ = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device))
    sched, member = PK.build_probe_schedule(np.zeros((2, 2), np.int32), 8)
    sched = torch.as_tensor(sched, device=cuda_device)
    member = torch.as_tensor(member, device=cuda_device)
    q = torch.zeros((2, 40), device=cuda_device)
    before = PK.bucket_score_tiled.launches
    with pytest.raises(ValueError, match="float32"):
        PK.bucket_score_tiled(q.double(), data, ids_t, sched, member, k=4)
    with pytest.raises(ValueError, match="unsupported pack dtype"):
        PK.bucket_score_tiled(q, data.half(), ids_t, sched, member, k=4)
    with pytest.raises(ValueError, match="scales"):
        PK.bucket_score_tiled(q, data.to(torch.int8), ids_t, sched, member,
                              k=4)
    with pytest.raises(ValueError, match="different devices"):
        PK.bucket_score_tiled(q, data, ids_t.cpu(), sched, member, k=4)
    assert PK.bucket_score_tiled.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d,qt", [(300, 16), (37, 8), (256, 32), (300, 20)])
def test_bucket_score_tiled_any_d_any_tile(cuda_device, dtype, d, qt):
    """D that fills no whole 16-byte word, and query tiles above 16 (run
    as sub-tiles): the kernel equals its plain version."""
    nq = 45
    docs, ids = _pack(d, d=d)
    rng = np.random.default_rng(d + qt)
    probes = rng.integers(0, ids.shape[0], size=(nq, 5)).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32),
                        device=cuda_device)
    sched, member = PK.build_probe_schedule(probes, qt)
    data, ids_t, scales = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device),
        dtype=None if dtype == torch.float32 else dtype)
    args = (q, data, ids_t, torch.as_tensor(sched, device=cuda_device),
            torch.as_tensor(member, device=cuda_device))
    kw = dict(k=10, scales=scales, exclude=torch.as_tensor(
        ids[probes[:, 0], 1], device=cuda_device))
    before = PK.bucket_score_tiled.launches
    got = PK.bucket_score_tiled(*args, **kw)
    assert PK.bucket_score_tiled.launches == before + 1
    want = PK.bucket_score_tiled_ref(*args, **kw)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    if dtype == torch.float32:
        assert torch.equal(got[1], want[1])


def _tiled_case(dev, dtype, *, nq, d=256, b=200, probes=4, k=10, seed=0,
                dead=False, exact=False):
    """A bucket-major pack of 3 clusterings x 8 buckets of up to b rows
    (two 128-row blocks, the second ragged), probes chosen at random or all
    buckets (exact), per-query exclude, the schedule built on the card at
    the engine's tile. dead: bucket 3 is all -1, and bucket 5 holds -1
    in the middle of its rows as well as at its tail."""
    docs, ids = _pack(seed, n=1200, k_per=8, b=b, d=d)
    if dead:
        ids[3] = -1
        ids[5, 20:150] = -1
    rng = np.random.default_rng(seed + 1)
    n_buckets = ids.shape[0]
    if exact:
        pr = np.tile(np.arange(n_buckets, dtype=np.int32), (nq, 1))
    else:
        pr = rng.integers(0, n_buckets, size=(nq, probes)).astype(np.int32)
    q = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32),
                        device=dev)
    q = torch.nn.functional.normalize(q, dim=1)
    ex = torch.as_tensor(np.where(np.arange(nq) % 3 == 0, ids[pr[:, 0], 0],
                                  -1).astype(np.int32), device=dev)
    data, ids_t, scales = PK.pack_bucket_major(
        torch.as_tensor(docs, device=dev), torch.as_tensor(ids, device=dev),
        dtype=None if dtype == torch.float32 else dtype)
    qt = min(PK.pick_query_tile(d, b), PK.pad_to(nq, 8))
    sched, member = PK.build_probe_schedule_device(
        torch.as_tensor(pr, device=dev), query_tile=qt,
        s_len=PK.schedule_length(qt, pr.shape[1], n_buckets))
    return (q, data, ids_t, sched, member), dict(k=k, exclude=ex,
                                                 scales=scales)


def _check_tiled(got, want, dtype):
    """fp32 and bf16: scores within 1e-5 (the same products summed in
    another order) and ids equal up to order inside runs of closer scores.
    int8: scores within 1e-4 (scaled by the bucket's scale after the sum)
    and the top-k ids overlapping >= 0.99 (a doc's score differs between
    clusterings, so a near tie may keep another copy)."""
    if dtype != torch.int8:
        _assert_same_ranking(got, want, tol=1e-5)
        return
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    gi, wi = got[1].cpu().numpy(), want[1].cpu().numpy()
    ov = np.mean([len(set(a) & set(w) - {-1}) / max(1, len(set(w) - {-1}))
                  for a, w in zip(gi.tolist(), wi.tolist())])
    assert ov >= 0.99


def test_scoring_smem_mirror_matches_the_cuda_source(cuda_device):
    """ops.smem_bytes, which pick_query_tile's reasoning rests on, is the
    CUDA source's score_smem_bytes for every pack."""
    import ctypes

    from repro_torch.kernels.bucket_score import ops
    from repro_torch.kernels.common import load_cuda_library

    fn = load_cuda_library("bucket_score_tiled").bucket_score_tiled_score_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_size_t
    for code, itemsize in ((0, 4), (1, 2), (2, 1)):
        assert fn(code) == ops.smem_bytes(itemsize)


def test_fpf_iter_and_topk_score_smem_mirrors_match_the_cuda_source(
        cuda_device):
    """The wrappers' shared-memory mirrors, which their plans rest on, are
    the CUDA sources' own sizes."""
    import ctypes

    from repro_torch.kernels.common import load_cuda_library
    from fpf_plan_mirror import table_rows
    from repro_torch.kernels.fpf_iter import ops as fops
    from repro_torch.kernels.topk_score import ops as tops

    lib = load_cuda_library("fpf_iter")
    fn = lib.fpf_iter_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_size_t
    for m, d in ((1, 37), (1001, 300), (5622, 2048), (200_000, 2048),
                 (10**7, 4), (1001, 60_000), (10_000, 4096), (62_500, 4096),
                 (10**7, 20)):
        p = fops._plan(m, d, 132)
        args = (p.rows, p.cached, d, int(p.center_in_smem),
                int(p.ms_in_smem), p.compact_bytes)
        assert fn(*args) == fops._smem_bytes(*args)
        assert fn(*args[:5], 0) == fops._smem_bytes(*args[:5])
    rb, tr = lib.fpf_iter_compact_row_bytes, lib.fpf_iter_table_rows
    rb.argtypes, rb.restype = [ctypes.c_int], ctypes.c_uint
    tr.argtypes, tr.restype = [ctypes.c_int] * 2, ctypes.c_int
    for nnz in (0, 1, 2, 3, 365, 546, 4096):
        assert rb(nnz) == fops._compact_row_bytes(nnz)
    for rows, nbytes in ((76, 215_616), (76, 0), (10**5, 115_776), (3, 76)):
        assert tr(rows, nbytes) == table_rows(rows, nbytes)
    fn = load_cuda_library("topk_score").topk_score_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_size_t
    for k_list in (1, 11, 200, 2500):
        for in_smem in (0, 1):
            assert fn(k_list, in_smem) == tops._smem_bytes(k_list,
                                                           bool(in_smem))


def test_topk_score_tc_smem_mirror_matches_the_cuda_source(cuda_device):
    """The tensor-core core's shared memory (stage ring, lists, candidate
    buffers, counters, barriers) as the CUDA source sizes it, for every k
    it takes, and within a block."""
    import ctypes

    from repro_torch.kernels.common import (SMEM_BYTES_PER_BLOCK,
                                            load_cuda_library)
    from repro_torch.kernels.topk_score import ops as tops

    fn = load_cuda_library("topk_score").topk_score_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_size_t
    for k_list in range(1, tops._TC_MAX_K + 1):
        assert fn(k_list) == tops._tc_smem_bytes(k_list)
        assert fn(k_list) <= SMEM_BYTES_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nq", [1, 15, 17, 64, 384])
def test_bucket_score_tiled_batches_match_plain(cuda_device, dtype, nq):
    """The two-launch kernel (scoring over the card, in-order merge) at
    batch sizes around the tile and up to calibration's 384, one launch
    count per call."""
    args, kw = _tiled_case(cuda_device, dtype, nq=nq, seed=nq)
    before = PK.bucket_score_tiled.launches
    got = PK.bucket_score_tiled(*args, **kw)
    assert PK.bucket_score_tiled.launches == before + 1
    _check_tiled(got, PK.bucket_score_tiled_ref(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("k", [10, 40, 300])
def test_bucket_score_tiled_list_depths_match_plain(cuda_device, dtype, k):
    """k_pad = 16, 40 and 304 (> 256: the merge's warp-wide shift runs
    several rounds per insertion)."""
    args, kw = _tiled_case(cuda_device, dtype, nq=17, probes=6, k=k, seed=k)
    _check_tiled(PK.bucket_score_tiled(*args, **kw),
                 PK.bucket_score_tiled_ref(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [300, 2048, 8192])
def test_bucket_score_tiled_any_d_matches_plain(cuda_device, dtype, d):
    """D = 300 (bf16 / int8 rows off 16-byte alignment: value-by-value
    stages), the smoke's 2048, and 8192 (past the old 6912 limit)."""
    args, kw = _tiled_case(cuda_device, dtype, nq=21, d=d, seed=d)
    _check_tiled(PK.bucket_score_tiled(*args, **kw),
                 PK.bucket_score_tiled_ref(*args, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("cap", [64 * 1024, 20 * 1024])
def test_bucket_score_tiled_segments_dead_buckets_exact_tier(
        cuda_device, monkeypatch, dtype, cap):
    """The exact tier (every bucket, one all -1 and one with -1 inside its
    rows) equals the plain version; a scratch cap small enough to force
    slot segments (64 KB) or tile groups of one slot (20 KB) gives the
    one-segment answer bit for bit, and two runs are bit-identical."""
    from repro_torch.kernels.bucket_score import ops

    args, kw = _tiled_case(cuda_device, dtype, nq=45, dead=True, exact=True,
                           k=20, seed=3)
    one = PK.bucket_score_tiled(*args, **kw)
    again = PK.bucket_score_tiled(*args, **kw)
    assert torch.equal(one[0], again[0]) and torch.equal(one[1], again[1])
    _check_tiled(one, PK.bucket_score_tiled_ref(*args, **kw), dtype)
    assert not torch.isin(one[1], args[2][3][args[2][3] >= 0]).any()
    monkeypatch.setattr(ops, "SCRATCH_BYTES", cap)
    n_tiles, s_len, qt = args[4].shape
    tiles, slots = ops.plan_segments(n_tiles, s_len, qt, args[1].shape[1])
    assert tiles * slots < n_tiles * s_len        # several segments
    before = PK.bucket_score_tiled.launches
    seg = PK.bucket_score_tiled(*args, **kw)
    assert PK.bucket_score_tiled.launches == before + 1
    assert torch.equal(seg[0], one[0]) and torch.equal(seg[1], one[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [256, 300, 37, 2048, 8192])
def test_bucket_score_v1_kernel_matches_plain(cuda_device, dtype, d):
    """v1: duplicates across clusterings, a probe repeated in one list,
    per-query exclude, bf16 and int8 widened against the fp32 query (int8
    with no scale), D off 16-byte rows (37, 300: value-by-value stages) and
    up to 8192 (one FMA chain per row in column order, so the same 1e-4);
    k from 1 to 300: lists held one entry a lane up to k_pad = 32, in
    shared memory past it (ids equal up to k = 40; see _check_v1 for
    300)."""
    nq = 19
    docs, ids = _pack(d + 1, d=d)
    rng = np.random.default_rng(d)
    probes = rng.integers(0, ids.shape[0], size=(nq, 6)).astype(np.int32)
    probes[:, 5] = probes[:, 0]
    q = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32),
                        device=cuda_device)
    data, ids_t, _ = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device),
        dtype=None if dtype == torch.float32 else dtype)
    args = (q, data, ids_t, torch.as_tensor(probes, device=cuda_device))
    ex = torch.as_tensor(ids[probes[:, 1], 0], device=cuda_device)
    if dtype == torch.int8:   # unscaled int8 dots are ~28 sqrt(D) x unit
        q /= 28.0 * d ** 0.5
    for k in (1, 10, 32, 40, 300):
        _check_v1(args, ex, k)


def test_bucket_score_v1_raises_instead_of_falling_back(cuda_device):
    docs, ids = _pack(0)
    data, ids_t, _ = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device), dtype=torch.int8)
    q = torch.zeros((2, 256), device=cuda_device)
    probes = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    before = PK.bucket_score.launches
    with pytest.raises(ValueError, match="unsupported pack dtype"):
        PK.bucket_score(q, data.half(), ids_t, probes, k=4)
    with pytest.raises(ValueError, match="probes"):
        PK.bucket_score(q, data.float(), ids_t, probes[:1], k=4)
    assert PK.bucket_score.launches == before


def _v1_case(dev, dtype, *, nq, share, d=256, b=200, p=6, seed=0):
    """v1 inputs: 3 clusterings x 8 buckets of up to b rows (b = 200: two
    row blocks, the second ragged), bucket 5's second block all padding and
    -1 inside its first; bucket 2 probed by the first `share` queries, the
    other probes random, each list's first bucket probed again at its end;
    exclude hits bucket 2's first row for every third query. int8 queries
    are scaled so the unscaled dots stay near 1 (the same 1e-4)."""
    docs, ids = _pack(seed, n=1200, k_per=8, b=b, d=d)
    ids[5, 128:] = -1
    ids[5, 10:40] = -1
    rng = np.random.default_rng(seed + 1)
    pr = rng.integers(0, ids.shape[0], size=(nq, p)).astype(np.int32)
    pr[:share, 1] = 2
    pr[::4, 2] = 5
    pr[:, -1] = pr[:, 0]
    q = rng.normal(size=(nq, d)).astype(np.float32)
    if dtype == torch.int8:
        q /= 28.0 * d ** 0.5
    ex = np.where(np.arange(nq) % 3 == 0, ids[2, 0], -1).astype(np.int32)
    data, ids_t, _ = PK.pack_bucket_major(
        torch.as_tensor(docs, device=dev), torch.as_tensor(ids, device=dev),
        dtype=None if dtype == torch.float32 else dtype)
    return ((torch.as_tensor(q, device=dev), data, ids_t,
             torch.as_tensor(pr, device=dev)),
            torch.as_tensor(ex, device=dev))


def _check_v1(args, ex, k):
    """One launch a call; the plain version's answer: scores within 1e-4
    and ids equal for k <= 40; for k = 300, ids equal up to order inside
    runs of scores closer than 1e-4 (a 300-deep list of ~1,300 N(0, 1)
    candidates holds neighbours 1e-7 apart, under the summation order's
    differences: measured on an H100, every mismatch was such a swap); and
    a second call bit for bit the first."""
    before = PK.bucket_score.launches
    got = PK.bucket_score(*args, k=k, exclude=ex)
    assert PK.bucket_score.launches == before + 1
    want = PK.bucket_score_ref(*args, k=k, exclude=ex)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    if k <= 40:
        assert torch.equal(got[1], want[1])
    else:
        _assert_same_ranking(got, want, tol=1e-4)
    again = PK.bucket_score(*args, k=k, exclude=ex)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("share", [1, 16, 17, 64])
@pytest.mark.parametrize("nq", [1, 19, 64, 130])
def test_bucket_score_v1_shared_buckets_match_plain(cuda_device, dtype, nq,
                                                    share):
    """A bucket probed by 1, 16 (one full group), 17 (a group and one more)
    or 64 queries (four groups), a bucket repeated in one list, a row block
    all padding, exclude hitting: the plain version's answer."""
    args, ex = _v1_case(cuda_device, dtype, nq=nq, share=min(share, nq),
                        seed=nq + share)
    got = _check_v1(args, ex, 10)
    assert not (got[1] == ex[:, None]).logical_and(ex[:, None] >= 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("cap", [64 * 1024, 6 * 1024])
def test_bucket_score_v1_segments_and_global_lists(cuda_device, monkeypatch,
                                                   dtype, cap):
    """A scratch cap that forces probe-slot segments (64 KB) or groups of
    queries one slot at a time (6 KB), and lists kept in global memory with
    a global snapshot (the shared-memory limit lowered): each gives the
    one-segment, shared-memory answer bit for bit, in one counted launch."""
    from repro_torch.kernels.bucket_score import ops

    args, ex = _v1_case(cuda_device, dtype, nq=45, share=20, p=9, seed=7)
    for k in (10, 300):
        one = _check_v1(args, ex, k)
        with monkeypatch.context() as m:
            m.setattr(ops, "SCRATCH_BYTES", cap)
            tiles, slots = ops.plan_segments(45, 9, 1, args[1].shape[1])
            assert tiles * slots < 45 * 9           # several segments
            seg = _check_v1(args, ex, k)
        assert torch.equal(seg[0], one[0]) and torch.equal(seg[1], one[1])
        with monkeypatch.context() as m:
            m.setattr(ops, "SMEM_BYTES_PER_BLOCK", 12 * 8 - 1)
            assert ops.V1Call(*args, k=k, exclude=ex).snap is not None
            glob = _check_v1(args, ex, k)
        assert torch.equal(glob[0], one[0]) and torch.equal(glob[1], one[1])


@pytest.mark.parametrize("nq,p", [(1, 1), (64, 12), (130, 12), (700, 30)])
def test_bucket_score_v1_groups_kernel_matches_plain(cuda_device, nq, p):
    """The inversion's group sizes from the CUDA kernel (a binary search
    for each run's start) equal the plain PyTorch ops', on runs from 1 to
    far more than 16 entries, with and without segments."""
    from repro_torch.kernels.bucket_score import ops

    rng = np.random.default_rng(nq * p)
    probes = torch.as_tensor(rng.integers(0, max(2, nq // 20), size=(nq, p))
                             .astype(np.int32), device=cuda_device)
    for tiles, slots in ((nq, p), (max(1, nq // 3), max(1, p // 2))):
        order, gsize = ops.invert_probes(probes, 1000, tiles=tiles,
                                         slots=slots)
        order_c, gsize_c = ops.invert_probes(probes.cpu(), 1000, tiles=tiles,
                                             slots=slots)
        assert torch.equal(order.cpu(), order_c)
        assert torch.equal(gsize.cpu(), gsize_c)


def test_bucket_score_v1_smem_mirror_matches_the_cuda_source(cuda_device):
    """ops.v1_smem_bytes is the CUDA source's score_smem_bytes for every
    pack."""
    import ctypes

    from repro_torch.kernels.bucket_score import ops
    from repro_torch.kernels.common import load_cuda_library

    fn = load_cuda_library("bucket_score").bucket_score_v1_score_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_size_t
    for code, itemsize in ((0, 4), (1, 2), (2, 1)):
        assert fn(code) == ops.v1_smem_bytes(itemsize)


def _assert_same_ranking(got, want, tol=1e-6):
    """Scores equal within ``tol`` and ids equal position by position,
    except that ids may trade places inside a run of scores closer than
    ``tol`` (summation order decides those), and the run at the k-th place
    may hold other members. -inf slots hold id -1."""
    gs, gi = got[0].cpu().numpy(), got[1].cpu().numpy()
    ws, wi = want[0].cpu().numpy(), want[1].cpu().numpy()
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
    assert np.array_equal(np.isfinite(gs), gi >= 0)
    assert np.array_equal(np.isfinite(ws), wi >= 0)
    for row_s, row_g, row_w in zip(ws, gi, wi):
        fin = np.isfinite(row_s)
        cut = np.flatnonzero(np.diff(row_s[fin]) < -tol) + 1
        runs = np.split(np.arange(int(fin.sum())), cut)
        for run in runs[:-1]:
            assert set(row_g[run]) == set(row_w[run])
        assert np.all(row_g[~fin] == -1)


def _corpus(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("k", [1, 11, 40, 600, 2500])
@pytest.mark.parametrize("d", [256, 37])
def test_topk_score_kernel_matches_plain(cuda_device, k, d):
    """k from 1 to n (and beyond the eligible rows: -inf / -1), with
    exclude and a mask that drops rows; ids equal the plain version's
    wherever the scores are more than 1e-6 apart."""
    n, nq = 2500, 21
    docs = torch.as_tensor(_corpus(k, n, d), device=cuda_device)
    q = torch.as_tensor(_corpus(k + 1, nq, d), device=cuda_device)
    rng = np.random.default_rng(k)
    mask = torch.as_tensor(rng.random(n) > 0.05, device=cuda_device)
    ex = torch.as_tensor(rng.integers(-1, n, size=nq).astype(np.int32),
                         device=cuda_device)
    for kw in (dict(), dict(exclude=ex, mask=mask)):
        before = PK.topk_score.launches
        got = PK.topk_score(q, docs, k=k, **kw)
        assert PK.topk_score.launches == before + 1
        want = PK.topk_score_ref(q, docs, k=k, **kw)
        _assert_same_ranking(got, want)


@pytest.mark.parametrize("k", [11, 600])
def test_topk_score_kernel_at_large_d(cuda_device, k):
    """D = 8192 (the queries restaged in 1024-column chunks), with exclude
    and a mask."""
    n, nq, d = 3000, 19, 8192
    docs = torch.as_tensor(_corpus(k, n, d), device=cuda_device)
    q = torch.as_tensor(_corpus(k + 1, nq, d), device=cuda_device)
    rng = np.random.default_rng(k)
    mask = torch.as_tensor(rng.random(n) > 0.05, device=cuda_device)
    ex = torch.as_tensor(rng.integers(-1, n, size=nq).astype(np.int32),
                         device=cuda_device)
    got = PK.topk_score(q, docs, k=k, exclude=ex, mask=mask)
    want = PK.topk_score_ref(q, docs, k=k, exclude=ex, mask=mask)
    _assert_same_ranking(got, want)


def _bf16_ulp(x):
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("d", [128, 300, 4096])
def test_topk_score_bf16_kernel_matches_plain(cuda_device, k, d):
    """bf16 queries and docs, fp32 accumulation (D = 300 takes the
    value-by-value loads, 128 and 4096 the 16-byte ones), with exclude and
    a mask. Without ``round_bf16`` the fp32 scores match within the
    summation order; with it each score is a bf16 value within one bf16
    ulp of the plain version's at its position, and the ids are equal on
    every row whose scores are equal (ties to the lower id in both)."""
    n, nq = 3000, 70
    docs = torch.as_tensor(_corpus(k, n, d), device=cuda_device).bfloat16()
    q = torch.as_tensor(_corpus(k + 1, nq, d), device=cuda_device).bfloat16()
    rng = np.random.default_rng(k + d)
    mask = torch.as_tensor(rng.random(n) > 0.05, device=cuda_device)
    ex = torch.as_tensor(rng.integers(-1, n, size=nq).astype(np.int32),
                         device=cuda_device)
    for kw in (dict(), dict(exclude=ex, mask=mask)):
        before = PK.topk_score.launches
        got = PK.topk_score(q, docs, k=k, **kw)
        assert PK.topk_score.launches == before + 1
        _assert_same_ranking(got, PK.topk_score_ref(q, docs, k=k, **kw),
                             tol=1e-5)
        gs, gi = PK.topk_score(q, docs, k=k, round_bf16=True, **kw)
        ws, wi = PK.topk_score_ref(q, docs, k=k, round_bf16=True, **kw)
        gs, gi, ws, wi = (x.cpu().numpy() for x in (gs, gi, ws, wi))
        assert np.array_equal(gs, gs.astype(np.float32))
        assert torch.equal(torch.as_tensor(gs),
                           torch.as_tensor(gs).bfloat16().float())
        assert np.all(np.abs(gs - ws) <= _bf16_ulp(ws))
        same = np.all(gs == ws, axis=1)
        assert same.mean() > 0.9
        assert np.array_equal(gi[same], wi[same])


def test_topk_score_ties_go_to_the_lower_id(cuda_device):
    """Duplicate doc vectors give exactly equal scores: the lower id first,
    across the doc splits, as the reference."""
    base = _corpus(3, 7, 64)
    docs = base[np.random.default_rng(4).integers(0, 7, size=4000)]
    docs_t = torch.as_tensor(docs, device=cuda_device)
    q = torch.as_tensor(base[:5], device=cuda_device)
    got = PK.topk_score(q, docs_t, k=50)
    want = PK.topk_score_ref(q.cpu(), docs_t.cpu(), k=50)
    assert torch.equal(got[1].cpu(), want[1])


def _tc_inputs(dev, nq, n, d, seed, masked):
    """Unit bf16 rows (today's corpus), and a mask and an exclude when
    ``masked``."""
    docs = torch.as_tensor(_corpus(seed, n, d), device=dev).bfloat16()
    q = torch.as_tensor(_corpus(seed + 1, nq, d), device=dev).bfloat16()
    if not masked:
        return q, docs, {}
    rng = np.random.default_rng(seed)
    mask = torch.as_tensor(rng.random(n) > 0.05, device=dev)
    ex = torch.as_tensor(rng.integers(-1, n, size=nq).astype(np.int32),
                         device=dev)
    return q, docs, dict(exclude=ex, mask=mask)


def _bf16_round(x):
    return torch.as_tensor(x, dtype=torch.float64).bfloat16().double().numpy()


def _assert_rounded_topk(q, docs, kw, got, want, k, tol=1e-5):
    """``round_bf16``: every score a bf16 value within one bf16 ulp of the
    plain version's at its position, and the kernel's list exactly the
    top-k by (score descending, id ascending) of scores that are each the
    bf16 rounding of a value within ``tol`` (the fp32 summation order, as
    without rounding) of the exact product: its scores are such roundings
    of its ids' exact products, its order is that order, and no other
    eligible doc outranks its k-th entry even at its lowest such rounding.
    Ties are exact, so ids are equal wherever no doc's product lies within
    ``tol`` of a bf16 rounding midpoint."""
    gs, gi = (x.cpu().numpy() for x in got)
    ws = want[0].cpu().numpy()
    assert torch.equal(torch.as_tensor(gs),
                       torch.as_tensor(gs).bfloat16().float())
    assert np.all(np.abs(gs - ws) <= _bf16_ulp(ws))
    exact = (q.double() @ docs.double().T).cpu().numpy()
    lo, hi = _bf16_round(exact - tol), _bf16_round(exact + tol)
    nq, n = exact.shape
    ok = np.ones((nq, n), bool)
    if "mask" in kw:
        ok &= kw["mask"].cpu().numpy()[None, :]
        ex = kw["exclude"].cpu().numpy()
        ok[ex >= 0, ex[ex >= 0]] = False
    for r in range(nq):
        ids, sc = gi[r], gs[r].astype(np.float64)
        assert len(set(ids.tolist())) == k and ok[r, ids].all()
        assert np.all((lo[r, ids] <= sc) & (sc <= hi[r, ids]))
        assert all(sc[p] > sc[p + 1] or (sc[p] == sc[p + 1]
                                         and ids[p] < ids[p + 1])
                   for p in range(k - 1))
        rest = ok[r].copy()
        rest[ids] = False
        last_s, last_i = sc[-1], ids[-1]
        low = lo[r, rest]
        others = np.flatnonzero(rest)
        assert not np.any((low > last_s) | ((low == last_s)
                                            & (others < last_i)))


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("d", [128, 4096, 8192])
@pytest.mark.parametrize("nq", [1, 65, 256, 300])
def test_topk_score_tc_core_matches_plain(cuda_device, nq, d, k):
    """The tensor-core core (bf16, D % 8 == 0, k <= 32) on n = 3001 rows
    (not a whole number of 128-row tiles), with and without exclude and a
    mask, with and without ``round_bf16``. Without rounding: scores within
    1e-5 of the plain version's, ids equal outside runs of closer scores.
    With it: see ``_assert_rounded_topk``."""
    n = 3001
    for masked in (False, True):
        q, docs, kw = _tc_inputs(cuda_device, nq, n, d, nq + d + k, masked)
        for rnd in (False, True):
            before = PK.topk_score.launches, PK.topk_score.tc_launches
            got = PK.topk_score(q, docs, k=k, round_bf16=rnd, **kw)
            assert (PK.topk_score.launches, PK.topk_score.tc_launches) == (
                before[0] + 1, before[1] + 1)
            want = PK.topk_score_ref(q, docs, k=k, round_bf16=rnd, **kw)
            if rnd:
                _assert_rounded_topk(q, docs, kw, got, want, k)
            else:
                _assert_same_ranking(got, want, tol=1e-5)


@pytest.mark.parametrize("rnd", [False, True])
@pytest.mark.parametrize("nq,k", [(65, 10), (300, 32)])
def test_topk_score_tc_ties_are_exact(cuda_device, nq, k, rnd):
    """Duplicated bf16 docs (7 distinct unit rows, so runs of exactly equal
    scores): ids equal the plain version's, scores within 1e-5. Rows whose
    products sum exactly in fp32 in any order (entries in {-2..2} / 8, D =
    4096): every score equals the plain version's bit for bit, and every
    id too. Ties go to the lower id across tiles, ranges and the candidate
    rounds."""
    g = np.random.default_rng(nq + k)
    base = _corpus(3, 7, 256)
    dup = torch.as_tensor(base[g.integers(0, 7, size=5000)],
                          device=cuda_device).bfloat16()
    qd = torch.as_tensor(base[g.integers(0, 7, size=nq)],
                         device=cuda_device).bfloat16()
    grid_docs = torch.as_tensor(g.integers(-2, 3, size=(4001, 4096)) / 8,
                                device=cuda_device).bfloat16()
    grid_q = torch.as_tensor(g.integers(-2, 3, size=(nq, 4096)) / 8,
                             device=cuda_device).bfloat16()
    ex = torch.as_tensor(g.integers(-1, 4001, size=nq).astype(np.int32),
                         device=cuda_device)
    mask = torch.as_tensor(g.random(4001) > 0.05, device=cuda_device)
    for q, docs, kw in ((qd, dup, {}), (grid_q, grid_docs, {}),
                        (grid_q, grid_docs, dict(exclude=ex, mask=mask))):
        before = PK.topk_score.tc_launches
        gs, gi = PK.topk_score(q, docs, k=k, round_bf16=rnd, **kw)
        assert PK.topk_score.tc_launches == before + 1
        ws, wi = PK.topk_score_ref(q, docs, k=k, round_bf16=rnd, **kw)
        assert torch.equal(gi.cpu(), wi.cpu())
        if docs is dup:
            assert float((gs - ws).abs().max()) <= 1e-5
        else:
            assert torch.equal(gs.cpu(), ws.cpu())


def test_topk_score_routes_by_shape(cuda_device):
    """bf16 at D = 4096 and k = 10 goes to the tensor cores; D = 300, k =
    33, an unaligned row pointer and fp32 keep the CUDA-core core; either
    core may be forced where it applies, and the answers agree."""
    def tc_moves(q, docs, k, **kw):
        before = PK.topk_score.launches, PK.topk_score.tc_launches
        PK.topk_score(q, docs, k=k, **kw)
        after = PK.topk_score.launches, PK.topk_score.tc_launches
        assert after[0] == before[0] + 1
        return after[1] - before[1]

    q, docs, _ = _tc_inputs(cuda_device, 5, 700, 4096, 1, False)
    assert tc_moves(q, docs, 10) == 1
    assert tc_moves(q, docs, 33) == 0
    assert tc_moves(q, docs, 10, core="fma") == 0
    assert tc_moves(q.float(), docs.float(), 10) == 0
    q3, docs3, _ = _tc_inputs(cuda_device, 5, 700, 300, 1, False)
    assert tc_moves(q3, docs3, 10) == 0
    flat = torch.empty(700 * 4096 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    skew = flat[1:].view(700, 4096)
    skew.copy_(docs)
    assert tc_moves(q, skew, 10) == 0
    with pytest.raises(ValueError, match="core='tc'"):
        PK.topk_score(q, skew, k=10, core="tc")
    with pytest.raises(ValueError, match="core='tc'"):
        PK.topk_score(q3, docs3, k=10, core="tc")
    with pytest.raises(ValueError, match="core='tc'"):
        PK.topk_score(q, docs, k=33, core="tc")
    a = PK.topk_score(q, docs, k=10, round_bf16=True, core="tc")
    b = PK.topk_score(q, docs, k=10, round_bf16=True, core="fma")
    c = PK.topk_score(q, skew, k=10, round_bf16=True)
    assert np.all(np.abs(a[0].cpu().numpy() - b[0].cpu().numpy())
                  <= _bf16_ulp(b[0].cpu().numpy()))
    assert torch.equal(b[0], c[0]) and torch.equal(b[1], c[1])


def test_topk_score_raises_instead_of_falling_back(cuda_device):
    docs = torch.zeros((10, 16), device=cuda_device)
    q = torch.zeros((2, 16), device=cuda_device)
    before = PK.topk_score.launches
    with pytest.raises(ValueError, match="float32"):
        PK.topk_score(q, docs.half(), k=3)
    with pytest.raises(ValueError, match="mask"):
        PK.topk_score(q, docs, k=3, mask=torch.ones(10, device=cuda_device))
    with pytest.raises(ValueError, match="k must be"):
        PK.topk_score(q, docs, k=0)
    with pytest.raises(ValueError, match="different devices"):
        PK.topk_score(q, docs.cpu(), k=3)
    assert PK.topk_score.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("l,e,itype", [(9, 72, torch.int32),
                                       (70, 128, torch.int64),
                                       (40, 37, torch.int32)])
def test_embed_bag_kernel_matches_plain(cuda_device, dtype, combiner,
                                        weighted, l, e, itype):
    """One warp per bag: bags of 9, 70 (three 32-slot groups) and 40 slots;
    rows of 72 and 128 values (16-byte loads) and 37 (value by value);
    int32 and int64 indices as they are; ids past V skipped."""
    rng = np.random.default_rng(l)
    # rows scaled so that every bag's sum has the spread of a 9-slot bag
    # (the bf16 tolerance below is one bf16 step at that size)
    table = torch.as_tensor((rng.normal(size=(500, e)) * 3 / l ** 0.5)
                            .astype(np.float32), device=cuda_device).to(dtype)
    idx = rng.integers(-1, 520, size=(33, l)).astype(np.int64)
    idx[3] = -1                                       # an all-padding bag
    idx = torch.as_tensor(idx, device=cuda_device).to(itype)
    w = (torch.as_tensor(rng.random((33, l)).astype(np.float32),
                         device=cuda_device) if weighted else None)
    before = PK.embed_bag.launches
    got = PK.embed_bag(table, idx, w, combiner=combiner)
    assert PK.embed_bag.launches == before + 1
    want = PK.embed_bag_ref(table, idx, w, combiner=combiner)
    assert got.dtype == dtype
    # fp32: the same fp32 sums in another order; bf16: both round one fp32
    # sum to bf16, which can land one bf16 step apart
    atol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert torch.all(got[3] == 0)


def test_embed_bag_raises_instead_of_falling_back(cuda_device):
    table = torch.zeros((10, 8), device=cuda_device)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    before = PK.embed_bag.launches
    with pytest.raises(ValueError, match="combiner"):
        PK.embed_bag(table, idx, combiner="max")
    with pytest.raises(ValueError, match="table"):
        PK.embed_bag(table.half(), idx)
    with pytest.raises(ValueError, match="indices"):
        PK.embed_bag(table, idx.float())
    with pytest.raises(ValueError, match="weights"):
        PK.embed_bag(table, idx, torch.ones((3, 3), device=cuda_device))
    assert PK.embed_bag.launches == before


def test_build_on_card_is_deterministic(cuda_device):
    """Two builds of one index on the card: bit-identical leaders, buckets
    and assignments (the medoid sums have a fixed order)."""
    rng = np.random.default_rng(2)
    spec = P.FieldSpec(("a", "b", "c"), (64, 64, 128))
    docs = P.normalize_fields(torch.as_tensor(
        rng.normal(size=(6000, 256)).astype(np.float32)), spec)
    builds = [P.ClusterPruneIndex.build(
        docs, spec, 48, device=cuda_device,
        generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    a, b = builds
    assert torch.equal(a.leaders, b.leaders)
    assert torch.equal(a.buckets, b.buckets)
    assert np.array_equal(a.assign, b.assign)


def test_brute_force_on_card_launches_topk_score(cuda_device):
    """brute_force_topk / bottomk on CUDA tensors go through the kernel,
    with mask= and exclude= applied there."""
    docs = torch.as_tensor(_corpus(9, 3000, 128), device=cuda_device)
    q = docs[:6]
    ex = torch.arange(6, dtype=torch.int32, device=cuda_device)
    mask = torch.ones(3000, dtype=torch.bool, device=cuda_device)
    mask[100:200] = False
    before = PK.topk_score.launches
    top = P.brute_force_topk(docs, q, 7, exclude=ex, mask=mask)
    bot = P.brute_force_bottomk(docs, q, 7, exclude=ex, mask=mask)
    assert PK.topk_score.launches == before + 2
    cpu = [x.cpu() for x in (docs, q, ex, mask)]
    for got, fn in ((top, P.brute_force_topk), (bot, P.brute_force_bottomk)):
        want = fn(cpu[0], cpu[1], 7, exclude=cpu[2], mask=cpu[3])
        torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-5, rtol=0)
        assert torch.equal(got[1].cpu(), want[1])


def _planted_duplicates(m, d, seed):
    """Unit rows where every 7th row repeats an earlier one: exact ties in
    maxsim, so the first index must win them."""
    rng = np.random.default_rng(seed)
    x = _corpus(seed, m, d)
    later = np.arange(6, m, 7)
    if later.size:
        src = rng.integers(0, later, size=later.size)
        x[later] = x[src - (src % 7 == 6)]     # copies of rows kept as they are
    return x, set(later.tolist())


@pytest.mark.parametrize("d", [37, 300, 2048])
@pytest.mark.parametrize("m", [1, 1001, 5622])
def test_fpf_centers_fused_one_launch_matches_plain(cuda_device, m, d):
    """Every round of an FPF run in ONE launch: the float64 checks of
    :func:`_assert_fpf_centers_match_float64`, and two runs give the same
    bits."""
    k = min(316, max(5, m // 3))
    x_np, later = _planted_duplicates(m, d, m + d)
    x = torch.as_tensor(x_np, device=cuda_device)
    launches, rounds = PK.fpf_iter.launches, PK.fpf_iter.rounds
    got = PK.fpf_centers_fused(x, k, m // 2)
    assert PK.fpf_iter.launches == launches + 1
    assert PK.fpf_iter.rounds == rounds + k - 1
    assert torch.equal(got, PK.fpf_centers_fused(x, k, m // 2))
    _assert_fpf_centers_match_float64(x, got, later)


def _assert_fpf_centers_match_float64(x, got, later):
    """An FPF run's centers ``got`` (``got[0]`` the first) over the rows
    ``x``, against float64: each center is an argmin of the maxsim (within
    1e-5) given the centers before it, never a row of ``later`` (copies of
    earlier rows: the first index wins their ties), and the centers equal
    the plain chain's (float64, first argmin; exact copies tie exactly
    there, as in the kernel) up to its first near tie between rows that are
    not copies of one another."""
    got = got.cpu().numpy()
    m, k = x.shape[0], len(got)
    x64 = x.double()
    sims = (x64 @ x64[torch.as_tensor(got[:-1], device=x.device).long()].T)
    sims = sims.cpu().numpy()          # each row against each center
    first = np.ones(m, bool)
    first[list(later)] = False
    ms = np.full(m, -np.inf)
    chain = True
    for i in range(1, k):
        ms = np.maximum(ms, sims[:, i - 1])
        assert ms[got[i]] <= ms.min() + 1e-5
        assert int(got[i]) not in later     # its earlier copy ties it
        if chain:
            two = np.sort(ms[first])[:2]
            if len(two) == 2 and two[1] - two[0] <= 1e-5:
                chain = False          # a near tie: the chains may part here
            else:
                assert got[i] == int(np.argmin(ms)), f"round {i}"


def _ts2_like_rows(m, seed):
    """``m`` rows of a corpus with the TS2 index's fields and topic model
    (hashed dims 1,024 / 1,024 / 2,048, 200 topics): hashed tf-idf, about
    91 % zeros."""
    from repro_torch.data import CorpusConfig, make_corpus

    docs, _, _ = make_corpus(CorpusConfig(
        n_docs=m, field_dims=(1024, 1024, 2048), n_topics=200,
        topic_mix_alpha=1.0, noise_terms=(4, 2, 24), seed=seed))
    return docs


def _fpf_sparse_case(case):
    """The FPF rows of one case and the rows that copy earlier ones: TS2-like
    rows at the TS2 sample's size (every CTA holds its rows compacted); rows
    made denser in the first 20 CTAs (those overflow the compacted budget
    and stream the rest); TS2-like rows mixed with dense ones (the first 10
    CTAs' rows and every 7th row: those CTAs keep the dense form) and a row
    of one nonzero. In each, every 9th row is a copy of an earlier one:
    exact ties, which the first index wins."""
    rng = np.random.default_rng(len(case))
    if case == "ts2":
        x = _ts2_like_rows(10_000, 11)
    elif case == "overflow":
        x = _ts2_like_rows(10_000, 12)
        fill = rng.random((20 * 76, x.shape[1]), dtype=np.float32)
        x[:20 * 76] += (fill < 0.3) * fill * 0.05
        x[:20 * 76] /= np.linalg.norm(x[:20 * 76], axis=1, keepdims=True)
    else:
        x = _ts2_like_rows(3_000, 13)
        for rows in (slice(0, 230), slice(None, None, 7)):
            dense = rng.standard_normal(x[rows].shape).astype(np.float32)
            x[rows] = dense / np.linalg.norm(dense, axis=1, keepdims=True)
        x[2000] = 0.0
        x[2000, 77] = 1.0
    later = np.arange(8, x.shape[0], 9)
    x[later] = x[later - 5]
    return np.ascontiguousarray(x), set(later.tolist())


@pytest.mark.parametrize("case", ["ts2", "overflow", "mixed"])
def test_fpf_compacted_rows_match_the_dense_plan_bit_for_bit(cuda_device,
                                                            case):
    """Rows held compacted give the dense plan's centers, values and final
    maxsim bit for bit (``torch.equal``), through one whole run and through
    the single-round API; ``fpf_centers_fused`` gives the same centers; the
    rows held compacted are those the plan's mirror of each CTA predicts,
    and the trace counters count them while a profiler records. Against
    the plain version: the whole run passes the float64 checks of
    :func:`_assert_fpf_centers_match_float64`, and three chained single
    rounds give the plain maxsim within 1e-5 and a center within 1e-5 of
    its minimum."""
    from fpf_plan_mirror import cta_held
    from repro_torch.kernels.fpf_iter import ops as fops
    from repro_torch.runtime import trace

    x_np, later = _fpf_sparse_case(case)
    x = torch.as_tensor(x_np, device=cuda_device)
    m, d = x.shape
    k = 600
    plan = fops._plan(m, d, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert plan.compact_bytes > 0
    nnz = (x_np != 0).sum(1)
    held = [cta_held(nnz[b * plan.rows:(b + 1) * plan.rows], plan)
            for b in range(plan.grid)]
    want_held = sum(h for h, compacted in held if compacted)
    compacted = [c for _, c in held]
    assert all(compacted) == (case != "mixed") and any(compacted)
    assert (want_held == m) == (case == "ts2")

    def run(p):
        ms = torch.empty((m,), device=cuda_device)
        centers = torch.zeros((k,), dtype=torch.int32, device=cuda_device)
        centers[0] = m // 2
        vals = torch.zeros((k,), device=cuda_device)
        n_held = fops._launch(x, None, ms, centers, vals, k, p)
        return centers, vals, ms, int(n_held)

    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        *got, n_held = run(plan)
        counted = trace.counters()
    trace.reset()
    assert n_held == want_held
    assert counted["fpf_iter.rows"] == m
    assert counted["fpf_iter.compact_rows"] == want_held
    *want, dense_held = run(plan._replace(compact_bytes=0))
    assert dense_held == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], PK.fpf_centers_fused(x, k, m // 2))
    assert torch.equal(got[0], run(plan)[0])
    assert len(set(got[0].tolist())) == k      # no row chosen twice
    _assert_fpf_centers_match_float64(x, got[0], later)
    ms = torch.full((m,), float("-inf"), device=cuda_device)
    cur = torch.tensor(3, dtype=torch.int32, device=cuda_device)
    for _ in range(3):
        one = PK.fpf_iter(x, cur, ms)
        ref = PK.fpf_iter_ref(x, cur, ms)
        torch.testing.assert_close(one[0], ref[0], atol=1e-5, rtol=0)
        assert float(ref[0][int(one[1])]) <= float(ref[0].min()) + 1e-5
        c2 = torch.tensor([int(cur), 0], dtype=torch.int32,
                          device=cuda_device)
        v2 = torch.zeros((2,), device=cuda_device)
        ms2 = torch.empty_like(ms)
        fops._launch(x, ms, ms2, c2, v2, 2, plan._replace(compact_bytes=0))
        assert torch.equal(one[0], ms2) and int(one[1]) == int(c2[1])
        assert torch.equal(one[2], v2[1])
        ms, cur = one[0], one[1]


@pytest.mark.parametrize("d", [300, 2048, 8192])
@pytest.mark.parametrize("k", [1, 11, 200, 300])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 130])
def test_topk_score_query_tiles_match_plain(cuda_device, nq, k, d):
    """Query tiles of 64 (nq around and past one tile), lists in shared
    memory and past 128 entries, D aligned and wide; mask and exclude. Scores
    within 1e-5 (a sequential fp32 FMA chain of up to 8192 terms against
    the plain matmul), ids equal outside runs of closer scores."""
    n = 3000
    docs = torch.as_tensor(_corpus(nq + d, n, d), device=cuda_device)
    q = torch.as_tensor(_corpus(nq + d + 1, nq, d), device=cuda_device)
    rng = np.random.default_rng(nq * k)
    mask = torch.as_tensor(rng.random(n) > 0.05, device=cuda_device)
    ex = torch.as_tensor(rng.integers(-1, n, size=nq).astype(np.int32),
                         device=cuda_device)
    before = PK.topk_score.launches
    got = PK.topk_score(q, docs, k=k, exclude=ex, mask=mask)
    assert PK.topk_score.launches == before + 1
    want = PK.topk_score_ref(q, docs, k=k, exclude=ex, mask=mask)
    _assert_same_ranking(got, want, tol=1e-5)
    ids = got[1].cpu().numpy()
    assert not np.any(ids == ex.cpu().numpy()[:, None])
    assert mask.cpu().numpy()[ids[ids >= 0]].all()


@pytest.mark.parametrize("dims,opts", [((64, 64, 128), {}),
                                       ((100, 100, 100), {}),
                                       ((64, 64, 128), {"query_tile": 32})])
def test_fused_engine_matches_reference_on_card(cuda_device, dims, opts):
    rng = np.random.default_rng(1)
    spec = P.FieldSpec(("a", "b", "c"), dims)
    docs = P.normalize_fields(torch.as_tensor(
        rng.normal(size=(3000, spec.total_dim)).astype(np.float32)), spec)
    index = P.ClusterPruneIndex.build(
        docs, spec, 32, device=cuda_device,
        generator=torch.Generator().manual_seed(0))
    assert index.method == "fpf_fused"
    qw = docs[:40].to(cuda_device)
    excl = torch.arange(40, dtype=torch.int32, device=cuda_device)
    fs, fi, fn = P.get_engine(index, "fused", **opts).search(
        qw, probes=9, k=10, exclude=excl)
    rs, ri, rn = P.get_engine(index, "reference").search(qw, probes=9, k=10,
                                                         exclude=excl)
    torch.testing.assert_close(fs, rs, atol=1e-4, rtol=0)
    assert torch.equal(fn, rn)
    assert (fi == ri).float().mean() > 0.99


def _mutation_corpus(seed, n=4000):
    rng = np.random.default_rng(seed)
    spec = P.FieldSpec(("a", "b", "c"), (64, 64, 128))
    docs = P.normalize_fields(torch.as_tensor(
        rng.normal(size=(n, 256)).astype(np.float32)), spec)
    return docs, spec


@pytest.mark.parametrize("method", ["kmeans", "random"])
def test_baseline_builds_on_card_are_deterministic(cuda_device, method):
    """k-means (10 Lloyd iterations) and random leaders built twice on the
    card: bit-identical leaders, buckets and assignments (the centroid sums
    run in a fixed order, no atomics); and equal to a CPU build of the same
    draws up to fp32 order (leaders 1e-5, assignments on 99 % of rows)."""
    docs, spec = _mutation_corpus(3)
    opts = {"iters": 10} if method == "kmeans" else {}
    a, b, cpu = (P.ClusterPruneIndex.build(
        docs, spec, 40, n_clusterings=2, method=method, device=dev,
        generator=torch.Generator().manual_seed(1), **opts)
        for dev in (cuda_device, cuda_device, "cpu"))
    assert torch.equal(a.leaders, b.leaders)
    assert torch.equal(a.buckets, b.buckets)
    assert np.array_equal(a.assign, b.assign)
    torch.testing.assert_close(a.leaders.cpu(), cpu.leaders, atol=1e-5,
                               rtol=0)
    assert np.mean(a.assign == cpu.assign) > 0.99


def _mutate(index, docs, spec):
    """One add of 300 docs (copies of 0..19 among them) and one remove of
    old and new ids; returns the added ids."""
    rng = np.random.default_rng(5)
    new = torch.cat([docs[:20], P.normalize_fields(torch.as_tensor(
        rng.normal(size=(280, 256)).astype(np.float32)), spec)])
    ids = index.add_documents(new.to(index.docs.device))
    index.remove_documents(np.r_[np.arange(40, 140), ids[50:100]])
    return ids


def test_mutations_on_card_equal_the_cpu(cuda_device):
    """add_documents / remove_documents on the card give the buckets,
    counts and assignments of the same operations on a CPU copy."""
    docs, spec = _mutation_corpus(4)
    cpu = P.ClusterPruneIndex.build(docs, spec, 32, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    card = P.ClusterPruneIndex.from_numpy(cpu._archive(), device=cuda_device)
    ids_c = _mutate(cpu, docs, spec)
    ids_g = _mutate(card, docs, spec)
    np.testing.assert_array_equal(ids_g, ids_c)
    assert card.buckets.device.type == "cuda"
    assert card.counts.device.type == "cuda"
    assert torch.equal(card.buckets.cpu(), cpu.buckets)
    assert torch.equal(card.counts.cpu(), cpu.counts)
    np.testing.assert_array_equal(card.assign, cpu.assign)
    np.testing.assert_array_equal(card.removed, cpu.removed)
    assert card.version == cpu.version == 2


def test_fused_after_mutation_equals_reference_on_card(cuda_device):
    """After an add and a remove on the card: the pack is re-made once, the
    fused answers equal the reference backend's (ids and n_scored, scores
    1e-4), copies are hit #1 and removed ids never return."""
    docs, spec = _mutation_corpus(6)
    index = P.ClusterPruneIndex.build(
        docs, spec, 32, device=cuda_device,
        generator=torch.Generator().manual_seed(0), pack_major=True)
    eng = P.get_engine(index, "fused")
    data0 = index.ensure_bucket_major()[0]
    ids = _mutate(index, docs, spec)
    assert index.bucket_data is None and "_engines" not in index.__dict__
    qw = P.weighted_query(index.docs[:20], torch.full((20, 3), 1 / 3,
                                                      device=cuda_device),
                          spec)
    excl = torch.arange(20, dtype=torch.int32, device=cuda_device)
    fused = P.get_engine(index, "fused")
    assert fused is not eng
    s_f, i_f, n_f = fused.search(qw, probes=12, k=10, exclude=excl)
    data1 = index.ensure_bucket_major()[0]
    assert data1 is not data0
    s_f2, i_f2, _ = fused.search(qw, probes=12, k=10, exclude=excl)
    assert index.ensure_bucket_major()[0] is data1
    assert torch.equal(i_f, i_f2)
    s_r, i_r, n_r = P.get_engine(index, "reference").search(
        qw, probes=12, k=10, exclude=excl)
    assert torch.equal(i_f, i_r) and torch.equal(n_f, n_r)
    torch.testing.assert_close(s_f, s_r, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(i_f[:, 0].cpu().numpy(), ids[:20])
    gone = set(range(40, 140)) | set(ids[50:100].tolist())
    assert not gone & set(i_f.reshape(-1).tolist())


@pytest.mark.parametrize("method", ["kmeans", "random"])
def test_celldec_search_on_card_equals_the_cpu(cuda_device, method):
    """CellDec (k-means) and PODS07 (random leaders) region indexes built on
    the CPU and loaded on the card: search_weighted on the card gives the
    CPU's n_scored on every query, its ids on every row whose exact scores
    keep gaps above 1e-5 (all but near ties, which fp32 order may swap),
    and its scores to 1e-5. Queries fall in all four weight regions."""
    docs, spec = _mutation_corpus(8)
    opts = {"iters": 10} if method == "kmeans" else {}
    cpu = P.CellDecIndex.build(docs, spec, 24, method=method, device="cpu",
                               generator=torch.Generator().manual_seed(2),
                               **opts)
    card = P.CellDecIndex(
        spec=spec, theta=cpu.theta, docs=docs.to(cuda_device),
        indexes=[P.ClusterPruneIndex.from_numpy(i._archive(),
                                                device=cuda_device)
                 for i in cpu.indexes])
    nq = 48
    w = np.tile(np.array([[0.6, 0.2, 0.2], [0.2, 0.6, 0.2],
                          [0.2, 0.2, 0.6], [1 / 3, 1 / 3, 1 / 3]],
                         np.float32), (nq // 4, 1))
    assert set(P.region_of(torch.as_tensor(w), 3).tolist()) == {0, 1, 2, 3}
    excl = np.arange(nq, dtype=np.int32)
    s_c, i_c, n_c = cpu.search_weighted(docs[:nq], torch.as_tensor(w),
                                        probes=6, k=10,
                                        exclude=torch.as_tensor(excl))
    s_g, i_g, n_g = card.search_weighted(
        docs[:nq].to(cuda_device), torch.as_tensor(w, device=cuda_device),
        probes=6, k=10, exclude=torch.as_tensor(excl, device=cuda_device))
    assert i_g.device.type == "cuda"
    np.testing.assert_array_equal(n_g.cpu().numpy(), n_c.numpy())
    clear = (-np.diff(s_c.numpy(), axis=1) > 1e-5).all(axis=1)
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(i_g.cpu().numpy()[clear],
                                  i_c.numpy()[clear])
    torch.testing.assert_close(s_g.cpu(), s_c, atol=1e-5, rtol=0)


# ------------------------------------------------------------ serving tier
def _serving_index(dev, *, seed=11, n=6000, pack_major=None):
    docs, spec = _mutation_corpus(seed, n)
    index = P.ClusterPruneIndex.build(
        docs, spec, 48, method="fpf", device=dev, pack_major=pack_major,
        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize(dev)
    return index, spec


def _serving_requests(spec, n, *, k=10, seed=3, n_docs=6000):
    rng = np.random.default_rng(seed)
    qids = rng.choice(n_docs, n, replace=False)
    w = rng.dirichlet([1.0] * 3, size=n)
    return [P.SearchRequest(like=int(q), k=k, probes=12,
                            weights=dict(zip(spec.names, map(float, wi))))
            for q, wi in zip(qids, w)]


def _burst(retriever, requests, **server_kw):
    import asyncio

    from repro_torch import serving as PS

    async def go():
        async with PS.SearchServer(retriever, **server_kw) as server:
            streams = [e.stream for e in server.pool.entries]
            resps = await asyncio.gather(
                *(server.submit(r) for r in requests))
            return (resps, streams, server.stats.snapshot(),
                    server.pool.health_snapshot())

    return asyncio.run(go())


def _assert_answers_as_sync(resps, requests, index, spec):
    """Ids equal one-by-one sync search on every row whose sync top-(k+1)
    keeps gaps above 1e-5 (a near tie may swap under another batch's
    schedule), n_scored equal on all, scores within 1e-5."""
    solo = P.Retriever(index, backend="fused")
    deep = solo.search([P.SearchRequest(like=r.like, weights=r.weights,
                                        k=r.k + 1, probes=r.probes)
                        for r in requests])
    solo._flush_request_caches()
    clear = 0
    for resp, req, d in zip(resps, requests, deep):
        ref = solo.search(req)
        assert resp.n_scored == ref.n_scored
        np.testing.assert_allclose(resp.scores, ref.scores, atol=1e-5)
        if np.all(-np.diff(d.scores) > 1e-5):
            clear += 1
            np.testing.assert_array_equal(resp.doc_ids, ref.doc_ids)
    assert clear >= 0.8 * len(requests)


def test_replicas_on_their_own_streams_answer_a_burst_as_sync(cuda_device):
    """Two replicas, each on its own CUDA stream (not the default one), take
    a 64-request burst in batches of 16; every answer is the synchronous
    one."""
    index, spec = _serving_index(cuda_device)
    requests = _serving_requests(spec, 64)
    resps, streams, snap, health = _burst(
        P.Retriever(index, backend="fused"), requests, window_s=0.005,
        max_batch=16, replicas=2)
    assert all(isinstance(s, torch.cuda.Stream) for s in streams)
    assert streams[0] != streams[1]
    assert torch.cuda.default_stream(cuda_device) not in streams
    assert snap["completed"] == 64 and snap["failed"] == 0
    assert all(h["successes"] >= 1 for h in health)
    _assert_answers_as_sync(resps, requests, index, spec)


def test_replica_compute_excludes_the_other_replicas_work(cuda_device):
    """Replica 1 holds ~1 s of device work and then a 64-query fused batch
    on its stream while replica 0 serves its own 64-query batch: replica
    0's compute_s waits for its own stream only (a device-wide sync would
    wait out replica 1's spin), so it stays under half of the spin, while
    replica 1's search, on the stream behind the spin, takes longer than
    that. (Replica 1's wait lands in its query resolution, whose host
    copies follow its stream, before its compute_s clock starts.)"""
    from repro_torch import serving as PS

    index, spec = _serving_index(cuda_device)
    retriever = P.Retriever(index, backend="fused")
    reqs_a = _serving_requests(spec, 64, seed=4)
    reqs_b = _serving_requests(spec, 64, seed=5)
    retriever.search(reqs_a)                     # kernels built, pack made
    retriever._flush_request_caches()
    pool = PS.ReplicaPool(retriever, 2)
    rep_a, rep_b = pool.entries
    spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    enqueued = threading.Event()
    out = {}

    def run_b():
        with torch.cuda.stream(rep_b.stream):
            spin[0].record()
            torch.cuda._sleep(2_000_000_000)
            spin[1].record()
        enqueued.set()
        t0 = time.perf_counter()
        out["b"] = rep_b.run(reqs_b)
        out["b_wall"] = time.perf_counter() - t0

    def run_a():
        assert enqueued.wait(timeout=60)
        out["a"] = rep_a.run(reqs_a)

    threads = [threading.Thread(target=run_b), threading.Thread(target=run_a)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    torch.cuda.synchronize(cuda_device)
    spin_s = spin[0].elapsed_time(spin[1]) / 1e3
    compute_a = out["a"][0].compute_s
    assert spin_s > 0.2
    assert compute_a < 0.5 * spin_s < out["b_wall"]
    _assert_answers_as_sync(out["a"], reqs_a, index, spec)
    _assert_answers_as_sync(out["b"], reqs_b, index, spec)


def test_one_pack_under_concurrent_first_use_on_card(cuda_device,
                                                     monkeypatch):
    """A fresh index with no pack, a 2-replica burst: the bucket-major pack
    is made once, and both streams read it only after it is complete."""
    import repro_torch.core.index as index_mod

    index, spec = _serving_index(cuda_device, pack_major=False)
    assert index.bucket_data is None
    packs = []
    real_pack = index_mod.pack_buckets_major

    def counted(*a, **kw):
        packs.append(1)
        return real_pack(*a, **kw)

    monkeypatch.setattr(index_mod, "pack_buckets_major", counted)
    requests = _serving_requests(spec, 64, seed=6)
    resps, _, snap, health = _burst(
        P.Retriever(index, backend="fused"), requests, window_s=0.005,
        max_batch=16, replicas=2)
    assert len(packs) == 1
    assert snap["completed"] == 64
    assert all(h["successes"] >= 1 for h in health)
    _assert_answers_as_sync(resps, requests, index, spec)


# ------------------------------------------------------- sharded backend
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_bucket_score_tiled_per_shard_matches_plain(cuda_device, dtype):
    """One shard's call at a small shard-local block (B_l of a 3-shard
    pack), on all three packs: kernel against plain version, and the
    sharded scoring call launches the kernel once per shard."""
    from repro_torch.core import distributed as PD

    docs, spec = _mutation_corpus(11, n=3000)
    index = P.ClusterPruneIndex.build(
        docs, spec, 32, device=cuda_device,
        generator=torch.Generator().manual_seed(0))
    index.pack_dtype = {torch.float32: None, torch.bfloat16: "bfloat16",
                        torch.int8: "int8"}[dtype]
    eng = P.get_engine(index, "sharded", n_shards=3)
    qw = index.docs[:40]
    excl = torch.arange(40, dtype=torch.int32, device=cuda_device)
    _, args, kw = eng.kernel_inputs(qw, probes=9, k=10, exclude=excl)
    data, ids, scales, q, sched, member = args
    assert data.dtype == dtype and data.shape[2] < index.buckets.shape[2]
    for s in range(3):
        sargs = (q, data[s], ids[s], sched, member)
        skw = dict(k=10, scales=None if scales is None else scales[s],
                   exclude=PD.local_exclude(excl, s * kw["n_local"],
                                            kw["n_local"]))
        got = PK.bucket_score_tiled(*sargs, **skw)
        want = PK.bucket_score_tiled_ref(*sargs, **skw)
        torch.testing.assert_close(got[0], want[0], atol=1e-4 if dtype ==
                                   torch.float32 else 2e-3, rtol=0)
        if dtype == torch.float32:
            assert torch.equal(got[1], want[1])
    before = PK.bucket_score_tiled.launches
    PD.distributed_bucket_score(*args, **kw)
    assert PK.bucket_score_tiled.launches == before + 3


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_engine_on_card_equals_plain_on_cpu(cuda_device, n_shards):
    """ShardedEngine on the card against the same engine on a CPU copy of
    the index (the plain versions): n_scored equal, ids equal on rows whose
    CPU top-(k+1) keeps gaps above 1e-5 (fp32 order may swap near ties),
    scores 1e-4, for plain, exclude and rescore searches and the exact
    tier; one bucket_score_tiled launch per shard per search, and one
    topk_score launch per shard per sharded brute force."""
    from repro_torch.core import distributed as PD

    docs, spec = _mutation_corpus(12, n=3001)
    cpu = P.ClusterPruneIndex.build(docs, spec, 32, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    card = P.ClusterPruneIndex.from_numpy(cpu._archive(), device=cuda_device)
    e_card = P.get_engine(card, "sharded", n_shards=n_shards)
    e_cpu = P.get_engine(cpu, "sharded", n_shards=n_shards)
    qw = card.docs[:40]
    excl = torch.arange(40, dtype=torch.int32, device=cuda_device)

    def check(got, want, deep_scores):
        clear = (-np.diff(deep_scores.numpy(), axis=1) > 1e-5).all(axis=1)
        assert clear.mean() > 0.8
        assert torch.equal(got[2].cpu(), want[2])
        torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[1].cpu().numpy()[clear],
                                      want[1].numpy()[clear])

    before = PK.bucket_score_tiled.launches
    for kw in (dict(probes=9), dict(probes=9, exclude=excl),
               dict(probes=9, rescore=40)):
        kw_cpu = {k_: (v.cpu() if torch.is_tensor(v) else v)
                  for k_, v in kw.items()}
        got = e_card.search(qw, k=10, **kw)
        check(got, e_cpu.search(qw.cpu(), k=10, **kw_cpu),
              e_cpu.search(qw.cpu(), k=11, **kw_cpu)[0])
    assert PK.bucket_score_tiled.launches == before + 3 * n_shards
    gt = P.brute_force_topk(cpu.docs, qw.cpu(), 11)
    check(e_card.search_exact(qw, k=10), e_cpu.search_exact(qw.cpu(), k=10),
          gt[0])
    before = PK.topk_score.launches
    s, i = PD.distributed_brute_topk(PD.shard_docs(card.docs, n_shards), qw,
                                     k=10, exclude=excl,
                                     n_valid=card.n_docs)
    assert PK.topk_score.launches == before + n_shards
    want = P.brute_force_topk(card.docs, qw, 10, exclude=excl)
    assert torch.equal(i, want[1])
    torch.testing.assert_close(s, want[0], atol=1e-5, rtol=0)


# ------------------------------------------------- the recsys serving path
def _dlrm_batch(cfg, dev, multi_hot, batch=64):
    from repro_torch.data import RecsysBatchConfig, click_batch

    dense, sparse, _ = click_batch(
        RecsysBatchConfig(vocab_sizes=cfg.vocab_sizes, multi_hot=multi_hot),
        batch, step=0)
    if multi_hot > 1:
        sparse[::5, :, -1] = -1                       # padded bags
    else:
        sparse = sparse[..., 0]
    return {"dense": torch.as_tensor(dense, device=dev),
            "sparse": torch.as_tensor(sparse, device=dev)}


@pytest.mark.parametrize("multi_hot", [3, 8])
def test_dlrm_multi_hot_forward_kernel_matches_plain_embed_bag(
        cuda_device, monkeypatch, multi_hot):
    """DLRM's multi-hot forward on the card: one embed_bag launch per
    field, logits equal to the same forward with the plain embed_bag_ref
    (fp32 bags of <= 8 rows summed in another order); the one-hot forward
    launches nothing."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import recsys_serve_step
    from repro_torch.models import recsys as rs

    cfg = get_arch("dlrm-mlperf").make_smoke_config()
    model = rs.DLRM(cfg, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(0))
    batch = _dlrm_batch(cfg, cuda_device, multi_hot)
    before = PK.embed_bag.launches
    got = recsys_serve_step(model, batch)
    assert PK.embed_bag.launches == before + cfg.n_sparse
    monkeypatch.setattr(
        rs, "embed_bag",
        lambda t, i, w=None, *, combiner="sum": PK.embed_bag_ref(
            t, i, w, combiner=combiner))
    want = recsys_serve_step(model, batch)
    assert PK.embed_bag.launches == before + cfg.n_sparse
    assert got.shape == (64,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    monkeypatch.undo()
    recsys_serve_step(model, _dlrm_batch(cfg, cuda_device, 1))
    assert PK.embed_bag.launches == before + cfg.n_sparse


def test_recsys_forwards_on_the_card_match_the_cpu(cuda_device):
    """The four smoke models with the same weights on the card and the
    CPU: the serve step agrees (fp32 without TF32, other kernels' order);
    MIND's retrieval step gives the CPU's top-k."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import (recsys_retrieval_step,
                                            recsys_serve_step)
    from repro_torch.data import history_batch
    from repro_torch.models import recsys as rs

    for arch in ("dlrm-mlperf", "autoint", "bst", "mind"):
        cfg = get_arch(arch).make_smoke_config()
        cpu = {"dlrm-mlperf": rs.DLRM, "autoint": rs.AutoInt,
               "bst": rs.BST, "mind": rs.MIND}[arch](cfg, device="cpu")
        card = type(cpu)(cfg, device=cuda_device)
        card.load_state_dict(cpu.state_dict())
        if arch in ("dlrm-mlperf", "autoint"):
            batch = _dlrm_batch(cfg, "cpu", 1)
            if arch == "autoint":
                batch.pop("dense")
        else:
            hl = cfg.seq_len if arch == "bst" else cfg.hist_len
            h, t, _ = history_batch(cfg.n_items, 32, hl, step=1)
            batch = {"hist": torch.as_tensor(h), "target": torch.as_tensor(t)}
        want = recsys_serve_step(cpu, batch)
        got = recsys_serve_step(card, {k: v.to(cuda_device)
                                       for k, v in batch.items()})
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    cands = cpu.p["item_emb"].detach()
    w = torch.full((32, cfg.n_interests), 1.0 / cfg.n_interests)
    wv, wi = recsys_retrieval_step(cpu, batch["hist"], cands, weights=w,
                                   k=20)
    gv, gi = recsys_retrieval_step(card, batch["hist"].to(cuda_device),
                                   cands.to(cuda_device),
                                   weights=w.to(cuda_device), k=20)
    torch.testing.assert_close(gv.cpu(), wv, atol=1e-4, rtol=0)
    gaps = (-torch.diff(wv, dim=1) > 1e-4).all(dim=1)
    assert torch.equal(gi.cpu()[gaps], wi[gaps])


# ------------------------------------------------- recsys training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_autograd_on_the_card_matches_autograd_through_plain(
        cuda_device, dtype, combiner, weighted):
    """``embed_bag`` under grad mode on the card (the CUDA forward, one
    counted launch, the plain backward) against autograd through
    ``embed_bag_ref`` on the same tensors: -1 padding, duplicate ids, an
    empty bag."""
    from repro_torch.models.embedding import embed_bag

    g = torch.Generator(device=cuda_device).manual_seed(3)
    v, e, b, l = 500, 128, 64, 6
    table = torch.randn(v, e, generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(0, v, (b, l), generator=g, device=cuda_device)
    idx[:, 1] = idx[:, 0]
    idx[::4, -2:] = -1
    idx[7] = -1
    w = torch.rand(b, l, generator=g, device=cuda_device) + 0.5
    cot = torch.randn(b, e, generator=g, device=cuda_device)
    grads = []
    for fn in (embed_bag, PK.embed_bag_ref):
        t = table.clone().requires_grad_()
        ww = w.clone().requires_grad_() if weighted else None
        before = PK.embed_bag.launches
        out = fn(t, idx, ww, combiner=combiner)
        launched = PK.embed_bag.launches - before
        assert launched == (1 if fn is embed_bag else 0)
        (out.float() * cot).sum().backward()
        grads.append((t.grad.float(), None if ww is None else ww.grad))
    (gt, gw), (wt, ww_) = grads
    # relative to each tensor's largest value: fp32 sums in another order;
    # on bf16 the plain side's autograd adds duplicates in bf16 (a
    # rounding each, 2**-8 of the value), the kernel's backward in fp32
    # once (a CPU probe of this case saw 0.0081 of the max)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    for got, want in ((gt, wt), (gw, ww_)) if weighted else ((gt, wt),):
        err = float((got - want).abs().max())
        assert err <= rtol * float(want.abs().max()), err


def test_dlrm_multi_hot_train_step_on_the_card(cuda_device):
    """One ``recsys_train_step`` of the smoke DLRM, multi-hot, on the card:
    exactly one ``embed_bag`` launch per field, a finite loss, every
    gradient equal to the same step on the CPU from the same weights
    (fp32 without TF32, another summation order), and the parameters
    updated in place."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import (recsys_loss_and_grads,
                                            recsys_train_step)
    from repro_torch.models import recsys as rs
    from repro_torch.optim import adamw

    cfg = get_arch("dlrm-mlperf").make_smoke_config()
    cpu = rs.DLRM(cfg, device="cpu")
    card = rs.DLRM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    batch = _dlrm_batch(cfg, "cpu", 8)
    batch["label"] = (torch.arange(64) % 3 == 0).float()
    on_card = {k: x.to(cuda_device) for k, x in batch.items()}
    before = PK.embed_bag.launches
    loss, grads = recsys_loss_and_grads(card, on_card)
    assert PK.embed_bag.launches == before + cfg.n_sparse
    want_loss, want = recsys_loss_and_grads(cpu, batch)
    torch.testing.assert_close(loss.cpu(), want_loss, atol=1e-5, rtol=1e-5)
    for name, g in grads.items():
        scale = float(want[name].abs().max()) or 1.0
        assert float((g.cpu() - want[name]).abs().max()) <= 1e-4 * scale, name
    opt = adamw(1e-3)
    state = opt.init(dict(card.p))
    w0 = card.p["table_0"].detach().clone()
    loss, state = recsys_train_step(card, opt, state, on_card)
    assert PK.embed_bag.launches == before + 2 * cfg.n_sparse
    assert bool(torch.isfinite(loss)) and state.step == 1
    assert not torch.equal(w0, card.p["table_0"])


# ------------------------------------------------------------- LM family
def _lm_pair(arch, device, dtype=torch.float32):
    """One smoke config's module on the CPU and the same weights on
    ``device``, in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(), dtype=dtype)
    cpu = tf.Transformer(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    card = tf.Transformer(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.parametrize("shape", [(96, 4096, 640), (3, 512, 7, 256)])
def test_lm_matmul32_bf16_on_the_card_is_the_fp32_upcast_product(
        cuda_device, shape):
    """The fp32-returning product on bf16 inputs (cuBLAS, fp32
    accumulation) against the fp32 product of the upcast operands: both
    sum exact bf16 products in fp32, in another order, so they agree to
    ~sqrt(K) fp32 roundings of the sum's terms (1e-5 of the largest
    |value| holds K = 4096 with margin). A transposed operand (the
    attention's ``k``) and the batched form too."""
    from repro_torch.models.transformer import matmul32

    g = torch.Generator().manual_seed(len(shape))
    if len(shape) == 3:
        m, k, n = shape
        a = torch.randn(m, k, generator=g).bfloat16().to(cuda_device)
        b = torch.randn(n, k, generator=g).bfloat16().to(cuda_device).T
    else:
        bt, m, n, k = shape
        a = torch.randn(bt, m, k, generator=g).bfloat16().to(cuda_device)
        b = torch.randn(bt, n, k, generator=g).bfloat16().to(
            cuda_device).transpose(1, 2)
    with torch.no_grad():
        got = matmul32(a, b)
    want = torch.matmul(a.double(), b.double())
    assert got.dtype == torch.float32
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    # while autograd records, the upcast path (same function) with a
    # backward that returns bf16 gradients
    a.requires_grad_(True)
    out = matmul32(a, b)
    torch.testing.assert_close(out, got, atol=1e-5 * float(want.abs().max()),
                               rtol=0)
    out.sum().backward()
    assert a.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3-8b", torch.float32), ("qwen2-moe-a2.7b", torch.float32),
    ("llama4-maverick-400b-a17b", torch.float32),
    ("qwen3-8b", torch.bfloat16)])
def test_lm_block_on_the_card_matches_the_cpu(cuda_device, arch, dtype):
    """One smoke-width block on the card against the same block on the CPU
    (the path the CPU tests hold against JAX). fp32 (no TF32): summation
    order only, 1e-4 of the largest |value| (the random-init residual
    grows to ~1e2). bf16 (dense only, so no router decision can flip):
    both round at the same places; 2^-6 of the largest |value| allows a
    few one-ulp flips carried to the output."""
    from repro_torch.models import transformer as tf

    cfg, cpu, card = _lm_pair(arch, cuda_device, dtype)
    toks = torch.randint(0, cfg.vocab, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(40).expand(2, 40)
    with torch.no_grad():
        outs = []
        for model in (cpu, card):
            p = tf._tree(model)
            x = tf._embed(p, toks.to(model.device), cfg)
            y, aux, kvs = tf.block_fn(tf._block(p["layers"], 0), x, cfg,
                                      pos.to(model.device))
            outs.append((y.float().cpu(), float(aux)))
    (want, aux_w), (got, aux_g) = outs
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * float(
        want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert aux_g == pytest.approx(aux_w, rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-moe-a2.7b"])
def test_lm_prefill_decode_and_gradients_on_the_card_match_the_cpu(
        cuda_device, arch):
    """fp32 smoke config: prefill, three decode steps (the cache written in
    place on the card) and ``loss_fn``'s gradients through the per-block
    checkpoint, card against CPU, 1e-4 of each tensor's largest value."""
    from repro_torch.models import transformer as tf

    cfg, cpu, card = _lm_pair(arch, cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 21),
                         generator=torch.Generator().manual_seed(2))

    def close(got, want, what):
        scale = float(want.abs().max()) or 1.0
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * scale, (what, err, scale)

    with torch.no_grad():
        lw, cw = tf.prefill(cpu, toks, cfg)
        lg, cg = tf.prefill(card, toks.to(cuda_device), cfg)
        close(lg, lw, "prefill")
        for step in range(3):
            nxt = lw.argmax(-1).to(torch.int32)
            lw, cw = tf.decode_step(cpu, cw, nxt, cfg)
            lg, cg = tf.decode_step(card, cg, nxt.to(cuda_device), cfg)
            close(lg, lw, f"decode {step}")
            close(cg["k"], cw["k"], f"cache {step}")
        assert int(cg["length"]) == 24
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    lw, _ = tf.loss_fn(cpu, toks, labels, cfg)
    lg, _ = tf.loss_fn(card, toks.to(cuda_device), labels.to(cuda_device),
                       cfg)
    gw = torch.autograd.grad(lw, list(cpu.parameters()))
    gg = torch.autograd.grad(lg, list(card.parameters()))
    assert float(lg.detach()) == pytest.approx(float(lw.detach()), rel=1e-5)
    for (name, _), a, b in zip(cpu.named_parameters(), gg, gw):
        close(a, b, name)


# ------------------------------------- training driver and the GNN family
def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """Leaves on the card (fp32, bf16, the int step) restore onto the
    card bit for bit, in their dtypes."""
    from repro_torch.checkpoint import restore_pytree, save_pytree

    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(5, 7, generator=g, device=cuda_device),
            "b": torch.randn(9, generator=g, device=cuda_device).bfloat16(),
            "step": 4}
    save_pytree(tree, str(tmp_path))
    like = {"w": torch.zeros(5, 7, device=cuda_device),
            "b": torch.zeros(9, dtype=torch.bfloat16, device=cuda_device),
            "step": 0}
    out = restore_pytree(like, str(tmp_path))
    assert out["step"] == 4
    for k in ("w", "b"):
        assert out[k].device == tree[k].device and out[k].dtype == tree[k].dtype
        assert torch.equal(out[k].view(torch.int16 if k == "b" else
                                       torch.int32),
                           tree[k].view(torch.int16 if k == "b" else
                                        torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_lm_resume_on_the_card_equals_the_uninterrupted_run(
        cuda_device, tmp_path, dtype):
    """qwen3-8b's smoke config (dense): 6 steps uninterrupted against 3
    steps, a checkpoint and a resume to 6, all on the card. The resumed
    run restores every tensor bit for bit and sees the same batches, and
    each step runs the same kernels on the same inputs, so its losses and
    final parameters equal the uninterrupted run's bit for bit."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_lm

    cfg = dataclasses.replace(get_arch("qwen3-8b").make_smoke_config(),
                              dtype=dtype)
    run = dict(batch=2, seq_len=32, log_every=100, device=cuda_device)
    whole, lw = train_lm(cfg, steps=6, **run)
    ck = str(tmp_path / "run")
    train_lm(cfg, steps=3, ckpt_dir=ck, ckpt_every=3, **run)
    resumed, lr = train_lm(cfg, steps=6, ckpt_dir=ck, ckpt_every=3, **run)
    assert len(lr) == 3 and lr == lw[3:]
    for (n, a), b in zip(resumed.named_parameters(), whole.parameters()):
        assert a.dtype == dtype and torch.equal(a, b), n


def test_gcn_on_the_card_matches_the_cpu(cuda_device):
    """gcn_loss, sampled_loss and graph_readout_loss with their gradients
    on the card against the port's CPU path on the same weights and inputs
    (padded edges included): index_add_ sums with atomics in no fixed
    order, a few ulps of each sum; 1e-4 of each tensor's largest |value|
    (chip_smoke's L_CPU_RTOL)."""
    from repro_torch.data import cora_like, molecule_batch
    from repro_torch.models import gnn

    cfg = gnn.GCNConfig(n_layers=2, d_in=48, d_hidden=16, n_classes=5,
                        readout="mean")
    g = cora_like(700, 6.0, 48, 5, seed=3)
    pad = np.array([[700, 700, 4], [700, 9, 700]], np.int32)
    edges = np.concatenate([g.edge_index, pad], 1)
    mol = molecule_batch(16, 12, 30, 48, 5, seed=4)
    params = gnn.gcn_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    lists = [edges[:, :3000], edges[:, 3000:]]

    def losses(dev):
        p = {k: v.detach().to(dev).requires_grad_(True)
             for k, v in params.items()}
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out = {
            "full": gnn.gcn_loss(p, t(g.features), t(edges), t(g.labels),
                                 t((np.arange(700) % 2).astype(np.float32)),
                                 cfg),
            "sampled": gnn.sampled_loss(p, t(g.features),
                                        [t(e) for e in lists],
                                        t(g.labels[:64]), 64, cfg),
            "readout": gnn.graph_readout_loss(
                p, t(mol.features), t(mol.edge_index), t(mol.graph_ids),
                t(mol.labels), 16, cfg)}
        return {k: [v.detach().cpu()] + [
            x.cpu() for x in torch.autograd.grad(v, list(p.values()))]
            for k, v in out.items()}

    want, got = losses("cpu"), losses(cuda_device)
    for k in want:
        for a, b in zip(got[k], want[k]):
            scale = float(b.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("mixed", [False, True], ids=["card", "mixed"])
def test_api_resolves_a_raw_batch_with_one_sync(cuda_device, mixed):
    """512 requests of four 64-d interest blocks on the card resolve with
    one synchronising read (the batch's validity), and their ``(512, D)``
    queries equal the same requests resolved on the CPU within 1e-6. With
    every other request's blocks in host arrays the batch is copied block
    by block, and gives the same values."""
    import types
    import warnings

    from repro_torch.core.api import SearchRequest, _resolve_queries

    spec = P.FieldSpec(names=("i0", "i1", "i2", "i3"), dims=(64,) * 4)
    v = torch.randn(512, 4, 64, generator=torch.Generator().manual_seed(0))

    def resolve(dev):
        index = types.SimpleNamespace(
            spec=spec, docs=torch.empty((0, spec.total_dim), device=dev))
        x = v.to(dev)
        reqs = [SearchRequest(query=[b.numpy() for b in v[i]]
                              if mixed and i % 2 else list(x[i].unbind()),
                              recall_target=0.9)
                for i in range(len(v))]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                q = _resolve_queries(index, reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "synchroniz" in str(w.message)]
        return q, len(syncs)

    got, syncs = resolve(cuda_device)
    want, _ = resolve(torch.device("cpu"))
    if not mixed:
        assert syncs == 1
    assert got.shape == (512, spec.total_dim) and got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-6
