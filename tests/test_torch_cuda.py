"""PyTorch port on the card: the hand-written kernels (CUDA
``bucket_score_tiled``, ``bucket_score`` v1, ``topk_score``, ``embed_bag``;
Triton ``fpf_iter``) against their plain PyTorch versions, the fused engine
against the reference engine, and a build repeated on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
        pytest.skip("needs a CUDA device (the CUDA and Triton kernels have no "
                    "CPU mode; their plain versions are tested on the CPU)")
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
    with pytest.raises(ValueError, match="shared memory"):
        PK.bucket_score_tiled(torch.zeros((2, 8192), device=cuda_device),
                              torch.zeros((1, 8, 8192), device=cuda_device),
                              ids_t[:1, :8], sched, member, k=4)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 300, 37])
def test_bucket_score_v1_kernel_matches_plain(cuda_device, dtype, d):
    """v1: duplicates across clusterings, a probe repeated in one list,
    per-query exclude, bf16 widened against the fp32 query."""
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
    for k in (10, 40):
        before = PK.bucket_score.launches
        got = PK.bucket_score(*args, k=k, exclude=ex)
        assert PK.bucket_score.launches == before + 1
        want = PK.bucket_score_ref(*args, k=k, exclude=ex)
        torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
        assert torch.equal(got[1], want[1])


def test_bucket_score_v1_raises_instead_of_falling_back(cuda_device):
    docs, ids = _pack(0)
    data, ids_t, _ = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device), dtype=torch.int8)
    q = torch.zeros((2, 256), device=cuda_device)
    probes = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    before = PK.bucket_score.launches
    with pytest.raises(ValueError, match="int8"):
        PK.bucket_score(q, data, ids_t, probes, k=4)
    with pytest.raises(ValueError, match="probes"):
        PK.bucket_score(q, data.float(), ids_t, probes[:1], k=4)
    assert PK.bucket_score.launches == before


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
def test_embed_bag_kernel_matches_plain(cuda_device, dtype, combiner,
                                        weighted):
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.normal(size=(500, 72)).astype(np.float32),
                            device=cuda_device).to(dtype)
    idx = rng.integers(-1, 500, size=(33, 9)).astype(np.int32)
    idx[3] = -1                                       # an all-padding bag
    idx = torch.as_tensor(idx, device=cuda_device)
    w = (torch.as_tensor(rng.random((33, 9)).astype(np.float32),
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
