"""PyTorch port, the plans of the ``fpf_iter`` and ``topk_score`` CUDA
kernels (pure Python, so they are checked here without a card): the
cooperative FPF grid, the 64-query split of the brute-force scoring, and
the packed (value, row) key whose atomic minimum picks each FPF center,
against ``torch.argmin`` and the reference's ``jnp.argmin``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.common import SMEM_BYTES_PER_BLOCK  # noqa: E402
from repro_torch.kernels.fpf_iter import ops as fops  # noqa: E402
from repro_torch.kernels.topk_score import ops as tops  # noqa: E402

N_SMS = 132   # an H100 SXM


@pytest.mark.parametrize("d", [37, 300, 2048])
@pytest.mark.parametrize("m", [1, 2, 1001, 5622, 200_000])
def test_fpf_plan_covers_every_row_once(m, d):
    """Each CTA owns a contiguous, non-empty range of rows; the ranges
    cover the m rows once; the grid fits one CTA per SM; the CTA's shared
    memory fits a block, and holds as many rows as fit."""
    grid, rows, cached, c_smem, ms_smem = fops._plan(m, d, N_SMS)
    assert 1 <= grid <= N_SMS
    owned = np.minimum(rows, m - np.arange(grid) * rows)
    assert owned.min() >= 1 and owned.sum() == m
    assert 1 <= cached <= rows and c_smem and ms_smem
    smem = fops._smem_bytes(rows, cached, d, c_smem, ms_smem)
    assert smem <= SMEM_BYTES_PER_BLOCK
    if cached < rows:
        assert smem + 4 * fops.pad_to(d, 4) > SMEM_BYTES_PER_BLOCK


def test_fpf_plan_keeps_maxsim_in_global_past_a_quarter_of_smem():
    m = 40 * SMEM_BYTES_PER_BLOCK
    grid, rows, cached, c_smem, ms_smem = fops._plan(m, 4, N_SMS)
    assert grid == N_SMS and c_smem and not ms_smem
    assert (fops._smem_bytes(rows, cached, 4, c_smem, ms_smem)
            <= SMEM_BYTES_PER_BLOCK)


def test_fpf_plan_reads_a_center_wider_than_half_of_smem_from_l2():
    d = SMEM_BYTES_PER_BLOCK // 4
    grid, rows, cached, c_smem, ms_smem = fops._plan(1001, d, N_SMS)
    assert not c_smem and cached == 0
    assert (fops._smem_bytes(rows, cached, d, c_smem, ms_smem)
            <= SMEM_BYTES_PER_BLOCK)


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
