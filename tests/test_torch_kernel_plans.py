"""PyTorch port, the plans of the ``fpf_iter``, ``topk_score`` and
``bucket_score`` (v1) CUDA kernels (pure Python, so they are checked here
without a card): the cooperative FPF grid and each CTA's choice between
dense and compacted rows, the 64-query split of the
brute-force scoring, the packed (value, row) key whose atomic minimum picks
each FPF center, against ``torch.argmin`` and the reference's
``jnp.argmin``, and v1's inversion of the probe lists into groups of one
bucket, its scratch segments and its scoring CTA's shared memory."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.bucket_score import ops as bops  # noqa: E402
from repro_torch.kernels.common import SMEM_BYTES_PER_BLOCK  # noqa: E402
from repro_torch.kernels.fpf_iter import ops as fops  # noqa: E402
from repro_torch.kernels.topk_score import ops as tops  # noqa: E402
from fpf_plan_mirror import cta_held, table_rows  # noqa: E402

N_SMS = 132   # an H100 SXM


@pytest.mark.parametrize("d", [37, 300, 2048])
@pytest.mark.parametrize("m", [1, 2, 1001, 5622, 200_000])
def test_fpf_plan_covers_every_row_once(m, d):
    """Each CTA owns a contiguous, non-empty range of rows; the ranges
    cover the m rows once; the grid fits one CTA per SM; the CTA's shared
    memory fits a block, and holds as many rows as fit."""
    p = fops._plan(m, d, N_SMS)
    grid, rows, cached = p.grid, p.rows, p.cached
    assert 1 <= grid <= N_SMS
    owned = np.minimum(rows, m - np.arange(grid) * rows)
    assert owned.min() >= 1 and owned.sum() == m
    assert 1 <= cached <= rows and p.center_in_smem and p.ms_in_smem
    smem = _smem(p, d)
    assert smem <= SMEM_BYTES_PER_BLOCK
    if cached < rows:
        assert smem + 4 * fops.pad_to(d, 4) > SMEM_BYTES_PER_BLOCK
        assert p.compact_bytes % 16 == 0
        assert smem + 16 > SMEM_BYTES_PER_BLOCK
    else:
        assert p.compact_bytes == 0    # compacting cannot hold more


def _smem(p, d):
    return fops._smem_bytes(p.rows, p.cached, d, p.center_in_smem,
                            p.ms_in_smem, p.compact_bytes)


def test_fpf_plan_keeps_maxsim_in_global_past_a_quarter_of_smem():
    m = 40 * SMEM_BYTES_PER_BLOCK
    p = fops._plan(m, 4, N_SMS)
    assert p.grid == N_SMS and p.center_in_smem and not p.ms_in_smem
    assert p.compact_bytes == 0    # a 16-byte row is below any compacted one
    assert _smem(p, 4) <= SMEM_BYTES_PER_BLOCK


def test_fpf_plan_reads_a_center_wider_than_half_of_smem_from_l2():
    d = SMEM_BYTES_PER_BLOCK // 4
    p = fops._plan(1001, d, N_SMS)
    assert not p.center_in_smem and p.cached == 0 and p.compact_bytes == 0
    assert _smem(p, d) <= SMEM_BYTES_PER_BLOCK


TS2_M, TS2_D = 10_000, 4096     # the TS2 build's FPF sample


def _ctas(m, rows):
    """Each CTA's local row count."""
    return [min(rows, m - b * rows) for b in range(-(-m // rows))]


@pytest.mark.parametrize("nnz_hi", [1, 365, 546, TS2_D])
@pytest.mark.parametrize("m,d", [(TS2_M, TS2_D), (5622, 2048),
                                 (62_500, 4096), (1001, 300)])
def test_fpf_cta_holds_each_row_in_one_form_once(m, d, nnz_hi):
    """Every row of a CTA is held compacted, held dense or streamed, once:
    the held rows are the CTA's first; compacted ones fit the region
    beside their offset table, as many as fit in order, and only where
    that is more than the dense form holds."""
    rng = np.random.default_rng(m + d + nnz_hi)
    p = fops._plan(m, d, N_SMS)
    table = table_rows(p.rows, p.compact_bytes)
    for r in _ctas(m, p.rows):
        nnz = rng.integers(0, min(nnz_hi, d) + 1, size=r)
        held, compacted = cta_held(nnz, p)
        forms = (["compact" if compacted else "dense"] * held
                 + ["streamed"] * (r - held))
        assert len(forms) == r and 0 <= held <= r
        dense = min(p.cached, r)
        if not compacted:
            assert held == dense
            continue
        assert held > dense and held <= table
        sizes = [fops._compact_row_bytes(int(n)) for n in nnz]
        assert 4 * table + sum(sizes[:held]) <= p.compact_bytes
        if held < min(r, table):        # the next row does not fit
            assert 4 * table + sum(sizes[:held + 1]) > p.compact_bytes


@pytest.mark.parametrize("nnz", [365, 538, 546])
def test_fpf_ts2_cta_fits_a_block_at_the_measured_densities(nnz):
    """At the TS2 sample's shape, a CTA's shared memory stays within a
    block for rows of up to the measured most nonzeros (546; mean 365.5,
    p99 538), and the compacted form holds more rows than the dense one
    (13 of 76), all of them at the mean."""
    p = fops._plan(TS2_M, TS2_D, N_SMS)
    assert (p.grid, p.rows, p.cached) == (N_SMS, 76, 13)
    assert _smem(p, TS2_D) <= SMEM_BYTES_PER_BLOCK
    held, compacted = cta_held([nnz] * p.rows, p)
    assert compacted and held > p.cached
    assert (4 * table_rows(p.rows, p.compact_bytes)
            + held * fops._compact_row_bytes(nnz)) <= p.compact_bytes
    assert held == p.rows or nnz > 365


@pytest.mark.parametrize("m,d", [(1001, 300), (5622, 2048), (TS2_M, TS2_D),
                                 (62_500, 4096), (200_000, 2048)])
def test_fpf_dense_rows_compact_none(m, d):
    """Rows without zeros hold the dense form in every CTA."""
    p = fops._plan(m, d, N_SMS)
    for r in _ctas(m, p.rows):
        assert cta_held([d] * r, p) == (min(p.cached, r), False)


@pytest.mark.parametrize("m,d,compacts", [
    (40 * SMEM_BYTES_PER_BLOCK, 16, False),
    (40 * SMEM_BYTES_PER_BLOCK, 20, True),
    (TS2_M, 29_056, True), (TS2_M, 29_060, False), (TS2_M, 65_536, False),
    (TS2_M, 70_000, False)])
def test_fpf_plan_compacts_only_with_uint16_columns(m, d, compacts):
    """Compacted columns are uint16: a plan compacts only with the center's
    row in shared memory, which holds D <= 29,056 < 65,536; wider rows,
    and rows no larger than the least compacted one (72 bytes), take the
    dense form."""
    p = fops._plan(m, d, N_SMS)
    assert p.cached < p.rows
    assert bool(p.compact_bytes) == compacts
    if compacts:
        assert p.center_in_smem and d < 2 ** 16
    held, compacted = cta_held([1] * p.rows, p)
    assert compacted == compacts


@pytest.mark.parametrize("n", [1, 1000, 100_000])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 130])
def test_topk_split_plan_covers_the_docs(nq, n):
    """64-query tiles cover the queries, whole 128-row blocks cover the
    docs, about two CTAs per SM, no more splits than the merge launch's
    shared memory takes, and two CTAs fit an SM's shared memory."""
    rows = tops._split_rows(nq, n, N_SMS)
    tiles = -(-nq // tops._QT)
    splits = -(-n // rows)
    assert tops._QT == 64 and (tiles - 1) * 64 < nq <= tiles * 64
    assert rows % 128 == 0
    assert (splits - 1) * rows < n <= splits * rows
    assert tiles * splits <= 2 * N_SMS + tiles - 1
    assert splits <= tops._MAX_SPLITS
    k_list = min(11, rows)
    assert tops._smem_bytes(k_list, True) * 2 <= SMEM_BYTES_PER_BLOCK


def test_topk_merge_smem_is_bounded_at_the_most_splits():
    """The merge launch keeps each split's list head (score, id) and read
    position in shared memory, 12 bytes a split: at most 48 KB."""
    rows = tops._split_rows(1, 10**9, 100_000)
    assert -(-10**9 // rows) <= tops._MAX_SPLITS
    assert 12 * tops._MAX_SPLITS <= 48 * 1024


CASES = {
    "ties": [0.5, 0.25, 0.25, 0.7, 0.25],
    "signed zeros": [0.3, 0.0, -0.0, 0.1, 0.0],
    "negative zero first": [-0.0, 0.0, 0.2],
    "negatives": [-0.5, -0.75, 0.1, -0.75, -0.1],
    "minus inf": [0.2, float("-inf"), -1.0, float("-inf")],
    "random": list(np.random.default_rng(0).normal(size=257)
                   .astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_key_minimum_is_the_first_argmin(case):
    vals = np.asarray(CASES[case], np.float32)
    keys = [fops._pack_key(v, i) for i, v in enumerate(vals)]
    best = min(keys)
    want = int(torch.argmin(torch.as_tensor(vals)))
    assert best & 0xFFFFFFFF == want == int(jnp.argmin(jnp.asarray(vals)))
    assert fops._key_value(best) == vals[want]
    # the key order is the (value, row) order everywhere, not just at the min
    order = sorted(range(len(vals)), key=lambda i: keys[i])
    assert order == sorted(range(len(vals)), key=lambda i: (vals[i], i))


@pytest.mark.parametrize("v", [0.0, -0.0, 1.0, -1.0, 3.5e-39, -2.0e38,
                               float("-inf"), float("inf")])
def test_packed_key_keeps_the_value(v):
    back = fops._key_value(fops._pack_key(v, 7))
    assert back == np.float32(v) and (v != 0 or np.signbit(back) == 0)


# ------------------------------------------------------- bucket_score (v1)
def _probes(pattern, nq, p, n_buckets=300, seed=0):
    """Probe lists with a chosen sharing: ``"distinct"`` (no bucket shared),
    ``"repeat"`` (random, and each list probes its first bucket again),
    ``"G"`` / ``"G+1"`` / ``"all"`` (one bucket probed by 16, 17 or all nq
    queries, the rest distinct)."""
    rng = np.random.default_rng(seed)
    pr = rng.permutation(n_buckets * 8)[: nq * p].reshape(nq, p) + 1
    if pattern == "repeat":
        pr = rng.integers(0, 7, size=(nq, p))
        pr[:, -1] = pr[:, 0]
    elif pattern != "distinct":
        share = {"G": bops.V1_GROUP, "G+1": bops.V1_GROUP + 1,
                 "all": nq}[pattern]
        pr[: min(share, nq), p // 2] = 0
    return pr.astype(np.int32)


def _oracle(probes, tiles, slots):
    """numpy: the stable order of the flat entries by (segment, bucket) and
    the groups of at most V1_GROUP entries cut from each run's start."""
    nq, p = probes.shape
    f = np.arange(nq * p)
    seg = (f // p // tiles) * -(-p // slots) + f % p // slots
    key = seg.astype(np.int64) * (int(probes.max()) + 1) + probes.reshape(-1)
    order = np.argsort(key, kind="stable")
    gsize = np.zeros(nq * p, np.int64)
    e = 0
    while e < f.size:
        run = int(np.sum(key[order][e:] == key[order][e]))
        for g0 in range(0, run, bops.V1_GROUP):
            gsize[e + g0] = min(bops.V1_GROUP, run - g0)
        e += run
    return order, gsize, key


@pytest.mark.parametrize("pattern", ["distinct", "repeat", "G", "G+1", "all"])
@pytest.mark.parametrize("p", [1, 12])
@pytest.mark.parametrize("nq", [1, 7, 64, 130])
def test_v1_inversion_groups_every_entry_once(nq, p, pattern):
    """Every (q, p) entry lies in exactly one group; a group holds at most
    V1_GROUP entries, all of one bucket, in (q, p) order; order and group
    sizes equal the numpy oracle's."""
    probes = _probes(pattern, nq, p)
    order, gsize = bops.invert_probes(torch.as_tensor(probes), 10_000,
                                      tiles=nq, slots=p)
    order, gsize = order.numpy(), gsize.numpy()
    assert order.dtype == gsize.dtype == np.int32
    want_order, want_gsize, _ = _oracle(probes, nq, p)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(gsize, want_gsize)
    flat = probes.reshape(-1)
    seen = np.zeros(nq * p, np.int64)
    for e in np.flatnonzero(gsize):
        members = order[e:e + gsize[e]]
        assert 1 <= members.size <= bops.V1_GROUP
        assert np.unique(flat[members]).size == 1
        assert np.all(np.diff(members) > 0)
        seen[members] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("tiles,slots", [(64, 12), (64, 5), (10, 12),
                                         (7, 1), (1, 1)])
def test_v1_inversion_keeps_segments_contiguous(tiles, slots):
    """With segments of ``tiles`` queries × ``slots`` probe slots, segment j
    (in the wrapper's loop order) owns one contiguous range of sorted
    entries, of its size, and no group crosses a segment."""
    nq, p = 64, 12
    probes = _probes("repeat", nq, p, seed=tiles * 13 + slots)
    order, gsize = bops.invert_probes(torch.as_tensor(probes), 7,
                                      tiles=tiles, slots=slots)
    order, gsize = order.numpy(), gsize.numpy()
    want_order, want_gsize, _ = _oracle(probes, tiles, slots)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(gsize, want_gsize)
    e0 = 0
    for t0 in range(0, nq, tiles):
        for s0 in range(0, p, slots):
            nt, ns = min(tiles, nq - t0), min(slots, p - s0)
            q, s = np.divmod(order[e0:e0 + nt * ns], p)
            assert np.all((q >= t0) & (q < t0 + nt) & (s >= s0)
                          & (s < s0 + ns))
            heads = np.flatnonzero(gsize[e0:e0 + nt * ns]) + e0
            assert np.all(heads + gsize[heads] <= e0 + nt * ns)
            e0 += nt * ns
    assert e0 == nq * p


@pytest.mark.parametrize("cap", [None, 64 * 1024, 4 * 1024, 1])
@pytest.mark.parametrize("nq,p,b", [(1, 1, 5), (64, 12, 1624), (130, 6, 200),
                                    (19, 12, 4000)])
def test_v1_segment_plan_stays_within_scratch(monkeypatch, nq, p, b, cap):
    """The scoring scratch of every segment — (B + ceil(B/128)) fp32 per
    (query, slot) — stays within SCRATCH_BYTES (one slot of one query when
    even that does not fit); the segments cover every (query, slot) once,
    query groups outer and slot segments inner, with the first sorted entry
    of each."""
    if cap is not None:
        monkeypatch.setattr(bops, "SCRATCH_BYTES", cap)
    q = torch.zeros((nq, 8))
    data = torch.zeros((3, b, 8))
    ids = torch.zeros((3, b), dtype=torch.int32)
    probes = torch.zeros((nq, p), dtype=torch.int32)
    call = bops.V1Call(q, data, ids, probes, k=10)
    per = (b + -(-b // 128)) * 4
    covered = np.zeros((nq, p), np.int64)
    e0 = 0
    for t0, nt, s0, ns, e in call.segments:
        assert e == e0 and nt >= 1 and ns >= 1
        assert nt * ns * per <= max(bops.SCRATCH_BYTES, per)
        assert nt * ns <= call.tiles * call.slots
        covered[t0:t0 + nt, s0:s0 + ns] += 1
        e0 += nt * ns
    assert np.all(covered == 1)
    assert call.scores.numel() == call.tiles * call.slots * b
    if cap is None:
        assert len(call.segments) == 1


def test_v1_smem_mirror_fits_four_ctas_an_sm():
    """The v1 scoring CTA's shared memory (the Python mirror of the CUDA
    source's score_smem_bytes; the card test holds it to the source) does
    not grow with D, B or k: 41.9 / 46.0 / 54.2 KB for fp32 / bf16 / int8,
    so four CTAs fit an H100 SM's 228 KB."""
    sizes = [bops.v1_smem_bytes(i) for i in (4, 2, 1)]
    assert sizes == [41_920, 46_016, 54_208]
    assert all(4 * (s + 1024) <= 228 * 1024 for s in sizes)


# ------------------------------------------ topk_score, tensor-core core
@pytest.mark.parametrize("dtype,d,k,aligned,want", [
    (torch.float32, 4096, 10, True, "fma"),
    (torch.float32, 8, 1, True, "fma"),
    (torch.bfloat16, 4096, 10, True, "tc"),
    (torch.bfloat16, 300, 10, True, "fma"),
    (torch.bfloat16, 8, 10, True, "tc"),
    (torch.bfloat16, 4096, 10, False, "fma"),
    (torch.bfloat16, 4096, 1, True, "tc"),
    (torch.bfloat16, 4096, 32, True, "tc"),
    (torch.bfloat16, 4096, 33, True, "fma"),
])
def test_topk_core_routing(dtype, d, k, aligned, want):
    """The tensor-core core takes bf16 rows TMA can read (D % 8 == 0,
    16-byte aligned) and lists of 1..32 entries; fp32 and the rest keep
    the CUDA-core core."""
    assert tops._core(dtype, d, k, aligned) == want


@pytest.mark.parametrize("n", [1, 1000, 390_624])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 256, 300])
def test_topk_tc_plan_covers_the_docs_and_queries(nq, n):
    """At most one persistent CTA an SM, in whole clusters; 256-query tiles
    over the queries; contiguous non-empty ranges of units (a cluster's
    tiles, one a CTA) that cover the 128-row tiles once, a CTA's tile past
    the last one masked; every (query tile, range) item taken by one
    cluster; no more lists than the merge launch takes."""
    q_tiles, ranges, grid = tops._tc_plan(nq, n, N_SMS)
    cl = tops._TC_CLUSTER
    assert 1 <= grid <= N_SMS and grid % cl == 0
    assert grid // cl <= q_tiles * ranges
    assert (q_tiles - 1) * 256 < nq <= q_tiles * 256
    n_tiles = -(-n // 128)
    units = -(-n_tiles // cl)
    spans = [tops._tc_range(r, ranges, units) for r in range(ranges)]
    assert spans[0][0] == 0 and spans[-1][1] == units
    assert all(b > a for a, b in spans)
    assert all(spans[r][1] == spans[r + 1][0] for r in range(ranges - 1))
    tiles = [u * cl + rank for a, b in spans for u in range(a, b)
             for rank in range(cl)]
    assert tiles == list(range(units * cl)) and units * cl - n_tiles < cl
    assert cl * ranges <= tops._MAX_SPLITS
    clusters = grid // cl
    items = sorted(w for c in range(clusters)
                   for w in range(c, q_tiles * ranges, clusters))
    assert items == list(range(q_tiles * ranges))


def test_topk_tc_plan_follows_the_cards_co_resident_ctas():
    """The grid never exceeds the CTAs the card holds at once (a card whose
    clusters leave SMs idle gets fewer), and one cluster still runs."""
    for n_ctas in (132, 130, 8, 2):
        _, ranges, grid = tops._tc_plan(256, 390_624, n_ctas)
        assert grid == max(tops._TC_CLUSTER,
                           n_ctas // tops._TC_CLUSTER * tops._TC_CLUSTER)
        assert grid // tops._TC_CLUSTER == ranges


def test_topk_tc_smem_fits_a_block_for_every_k():
    """The stage ring, the lists, the candidate buffers and the staging
    slots fit a block for k = 1..32, with at least 3 candidate and 3
    staging slots a query, and room to seed the first tile (16 candidate
    slots) at the paper's k = 10."""
    for k in range(1, tops._TC_MAX_K + 1):
        assert tops._tc_smem_bytes(k) <= SMEM_BYTES_PER_BLOCK
        assert 3 <= tops._tc_cap(k) <= 32 and 3 <= tops._tc_staged(k) <= 8
    assert (tops._tc_cap(10), tops._tc_staged(10)) == (20, 8)
    assert (tops._tc_cap(32), tops._tc_staged(32)) == (3, 3)


@pytest.mark.parametrize("core", [None, "tc", "fma"])
def test_topk_core_keyword_leaves_the_cpu_path_alone(core):
    """``core=`` picks a CUDA core only; on CPU tensors the plain version
    answers whatever it says, and an unknown core raises."""
    from repro_torch.kernels import topk_score, topk_score_ref

    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.normal(size=(3, 16)), dtype=torch.bfloat16)
    docs = torch.as_tensor(rng.normal(size=(40, 16)), dtype=torch.bfloat16)
    got = topk_score(q, docs, k=4, round_bf16=True, core=core)
    want = topk_score_ref(q, docs, k=4, round_bf16=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="core must be"):
        topk_score(q, docs, k=4, core="wgmma")
