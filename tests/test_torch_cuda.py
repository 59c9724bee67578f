"""PyTorch port on the card: the hand-written kernels (CUDA
``bucket_score_tiled``, Triton ``fpf_iter``) against their plain PyTorch
versions, and the fused engine against the reference engine.

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
    docs, ids = _pack(0, d=40)                      # D % 16 != 0
    data, ids_t, _ = PK.pack_bucket_major(
        torch.as_tensor(docs, device=cuda_device),
        torch.as_tensor(ids, device=cuda_device))
    sched, member = PK.build_probe_schedule(np.zeros((2, 2), np.int32), 8)
    with pytest.raises(ValueError, match="divisible by 16"):
        PK.bucket_score_tiled(
            torch.zeros((2, 40), device=cuda_device), data, ids_t,
            torch.as_tensor(sched, device=cuda_device),
            torch.as_tensor(member, device=cuda_device), k=4)


def test_fused_engine_matches_reference_on_card(cuda_device):
    rng = np.random.default_rng(1)
    spec = P.FieldSpec(("a", "b", "c"), (64, 64, 128))
    docs = P.normalize_fields(torch.as_tensor(
        rng.normal(size=(3000, 256)).astype(np.float32)), spec)
    index = P.ClusterPruneIndex.build(
        docs, spec, 32, device=cuda_device,
        generator=torch.Generator().manual_seed(0))
    assert index.method == "fpf_fused"
    qw = docs[:40].to(cuda_device)
    excl = torch.arange(40, dtype=torch.int32, device=cuda_device)
    fs, fi, fn = P.get_engine(index, "fused").search(qw, probes=9, k=10,
                                                     exclude=excl)
    rs, ri, rn = P.get_engine(index, "reference").search(qw, probes=9, k=10,
                                                         exclude=excl)
    torch.testing.assert_close(fs, rs, atol=1e-4, rtol=0)
    assert torch.equal(fn, rn)
    assert (fi == ri).float().mean() > 0.99
