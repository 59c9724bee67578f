"""Triton kernel for one Gonzalez (FPF) round on Hopper.

Replaces ``fpf_iter_kernel`` (``src/repro/kernels/fpf_iter/kernel.py:25``,
launched by ``pallas_call`` at ``src/repro/kernels/fpf_iter/ops.py:36``).

What bounds it on the H100: memory. A round reads the ``(m, D)`` sample
once (``m·D·4`` bytes), reads and writes ``maxsim`` (``2·m·4``), and does
``2·m·D`` flops — a quarter-flop per byte, far below the card's ridge, so
the round can be no faster than ``(m·D + 2m)·4 B / 3.35 TB/s``. Tensor
cores would not help; what matters is reading each row once, in long
coalesced runs, with enough programs in flight to cover the card.

Design. The TPU kernel walked the rows in order and carried the running
``(min value, index)`` in SMEM from one grid step to the next. Blocks on
Hopper run in no order and carry nothing, so the round is two launches:

* stage 1 — each program takes ``BLOCK_M`` rows, accumulates ``x·c`` over
  ``D`` in ``BLOCK_D`` chunks (fp32), writes ``max(maxsim, sim)`` back IN
  PLACE (each element is read and written by the same program), and emits
  its partial ``(min value, first index)`` over its valid rows; padded rows
  count as ``+inf``;
* stage 2 — one program reduces the partials lexicographically by
  ``(value, index)``, so ties go to the lowest global index, which is the
  reference's rule (the strict ``tile_min < run_val`` fold at
  kernel.py:57, ``jnp.argmin`` in ``cluster.fpf_centers``). It writes the
  winner into ``centers[i]`` and its value into ``out_val``.

The newest center is not passed as a vector: stage 1 reads its row index
from ``centers[i - 1]`` on the device and loads ``x[cur]`` itself, so the
``k - 1`` rounds of :func:`~repro_torch.kernels.fpf_iter.ops.fpf_centers_fused`
run back to back with no host synchronisation.

``triton`` is imported inside :func:`kernels`, never at module import: the
CPU tests import this module on machines without Triton.
"""

from __future__ import annotations

import functools

__all__ = ["kernels", "BLOCK_M", "BLOCK_D", "MAX_PARTS"]

BLOCK_M = 32        # rows per stage-1 program (176 programs at m = 5622)
BLOCK_D = 128       # columns per inner step: 512 contiguous bytes per row
MAX_PARTS = 8192    # stage 2 reduces the partials in one block


@functools.cache
def kernels():
    """Compile-on-first-use handles ``(stage1, stage2)``."""
    import triton
    import triton.language as tl

    @triton.jit
    def fpf_round_stage1(
        x_ptr, centers_ptr, round_i, maxsim_ptr, part_val_ptr, part_idx_ptr,
        m, d, stride_x,
        BLOCK_M: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        pid = tl.program_id(0)
        rows = pid * BLOCK_M + tl.arange(0, BLOCK_M)
        rmask = rows < m
        cur = tl.load(centers_ptr + round_i - 1).to(tl.int64)
        row_off = rows.to(tl.int64) * stride_x
        acc = tl.zeros([BLOCK_M], dtype=tl.float32)
        for d0 in range(0, d, BLOCK_D):
            cols = d0 + tl.arange(0, BLOCK_D)
            cmask = cols < d
            c = tl.load(x_ptr + cur * stride_x + cols, mask=cmask, other=0.0)
            xt = tl.load(
                x_ptr + row_off[:, None] + cols[None, :],
                mask=rmask[:, None] & cmask[None, :], other=0.0,
            )
            acc += tl.sum(xt * c[None, :], axis=1)
        ms = tl.load(maxsim_ptr + rows, mask=rmask, other=0.0)
        new = tl.maximum(ms, acc)
        tl.store(maxsim_ptr + rows, new, mask=rmask)
        masked = tl.where(rmask, new, float("inf"))
        vmin = tl.min(masked, axis=0)
        imin = tl.min(tl.where(masked == vmin, rows, 2147483647), axis=0)
        tl.store(part_val_ptr + pid, vmin)
        tl.store(part_idx_ptr + pid, imin)

    @triton.jit
    def fpf_round_stage2(
        part_val_ptr, part_idx_ptr, n_parts, centers_ptr, round_i,
        out_val_ptr, BLOCK_P: tl.constexpr,
    ):
        offs = tl.arange(0, BLOCK_P)
        pm = offs < n_parts
        v = tl.load(part_val_ptr + offs, mask=pm, other=float("inf"))
        ix = tl.load(part_idx_ptr + offs, mask=pm, other=2147483647)
        vmin = tl.min(v, axis=0)
        imin = tl.min(tl.where(v == vmin, ix, 2147483647), axis=0)
        tl.store(centers_ptr + round_i, imin)
        tl.store(out_val_ptr, vmin)

    return fpf_round_stage1, fpf_round_stage2
