"""Wrappers for the fused FPF round and the full FPF loop built on it.

Counterpart of :mod:`repro.kernels.fpf_iter.ops`. A CPU tensor goes to the
plain version (:mod:`.ref`); a CUDA tensor goes to the hand-written CUDA
kernel ``csrc/fpf_iter.cu`` (built with ``nvcc`` for ``sm_90a`` on first
use, bound with ``ctypes``) or the call raises — there is no fallback, and
a grid the card cannot hold at once is refused, never run round by round.
The kernel runs every round of one FPF run in one cooperative launch, and
holds a CTA's rows in shared memory in compacted (value, column) form where
that holds more of them than the dense form (sparse rows).
``fpf_iter.launches`` counts launches and ``fpf_iter.rounds`` the rounds
they ran; while a profiler records, the trace counters ``fpf_iter.rows`` and
``fpf_iter.compact_rows`` count the rows of every launch and those held
compacted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...runtime import trace
from ..common import (SMEM_BYTES_PER_BLOCK, check_status, count_launch,
                      cuda_function, launch_on, on_cuda, pad_to)
from .ref import fpf_iter_ref

__all__ = ["fpf_iter", "fpf_centers_fused"]
_WARPS = 16        # kWarps in the CUDA source: 512 threads per CTA
_KEY_BYTES = 8 * _WARPS + 16   # each warp's key and the CTA's state
_COUNT_BYTES = 64              # a compacted row's 32 lane counts (uint16)


def _check(x: torch.Tensor, maxsim: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous (m, D) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype}"
        )
    m = x.shape[0]
    if (maxsim.shape != (m,) or maxsim.dtype != torch.float32
            or not maxsim.is_contiguous()):
        raise ValueError(
            f"maxsim must be a contiguous ({m},) float32 tensor, got "
            f"{tuple(maxsim.shape)} {maxsim.dtype}"
        )


class Plan(NamedTuple):
    """A launch's grid and each CTA's shared memory (see :func:`_plan`)."""
    grid: int
    rows: int
    cached: int
    center_in_smem: bool
    ms_in_smem: bool
    compact_bytes: int


def _plan(m: int, d: int, n_sms: int) -> Plan:
    """The cooperative grid and each CTA's shared memory.

    At most one CTA per SM (a CTA takes most of an SM's shared memory) and
    at least a row per warp; CTA ``b`` owns rows ``[b R, (b + 1) R)``, the
    last possibly fewer, none empty. The center's row is copied into shared
    memory each round when it takes at most half of it, the CTA's maxsim
    values stay there when they take at most a quarter, and the rest holds
    ``cached`` dense rows or, in ``compact_bytes``, compacted rows
    (``run_smem_bytes`` in the CUDA source; the center's row is padded to
    whole 128-column blocks). Each CTA picks, in its prologue, the form
    that holds more of its rows, from their nonzero counts. Compacting is
    planned only where it can hold more: some rows would stream, the center
    is in shared memory (so ``d`` < 65,536 and uint16 columns do), and a
    dense row is larger than the least compacted one."""
    grid = max(1, min(n_sms, -(-m // _WARPS)))
    rows = -(-m // grid)
    grid = -(-m // rows)
    row_bytes = 4 * pad_to(d, 4)
    center_in_smem = row_bytes <= SMEM_BYTES_PER_BLOCK // 2
    ms_in_smem = 4 * rows <= SMEM_BYTES_PER_BLOCK // 4
    free = SMEM_BYTES_PER_BLOCK - _smem_bytes(rows, 0, d, center_in_smem,
                                              ms_in_smem)
    cached = min(rows, free // row_bytes)
    compact = (cached < rows and center_in_smem
               and row_bytes > _compact_row_bytes(1))
    return Plan(grid, rows, cached, center_in_smem, ms_in_smem,
                free // 16 * 16 if compact else 0)


def _smem_bytes(rows: int, cached: int, d: int, center_in_smem: bool,
                ms_in_smem: bool, compact_bytes: int = 0) -> int:
    """Shared memory of one CTA (``run_smem_bytes`` in the CUDA source)."""
    return (max(cached * 4 * pad_to(d, 4), compact_bytes)
            + (4 * pad_to(d, 128) if center_in_smem else 0) + _KEY_BYTES
            + (4 * rows if ms_in_smem else 0))


def _compact_row_bytes(nnz: int) -> int:
    """Bytes of a compacted row with ``nnz`` nonzeros: the lane counts, the
    uint16 columns padded to 4 bytes, the fp32 values."""
    return _COUNT_BYTES + -(-2 * nnz // 4) * 4 + 4 * nnz


def _pack_key(value: float, row: int) -> int:
    """Python mirror of ``pack_key`` in the CUDA source: the 64-bit key whose
    unsigned order is (value, row) order — the float's bits mapped to an
    order-preserving uint32 (-0.0 first made +0.0) above the row index. The
    least key is ``torch.argmin``'s first minimum."""
    u = int(np.float32(value).view(np.uint32))
    if (u << 1) & 0xFFFFFFFF == 0:
        u = 0
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (u << 32) | (row & 0xFFFFFFFF)


def _key_value(key: int) -> float:
    """The value a key holds (``key_value`` in the CUDA source)."""
    u = key >> 32
    u = u & 0x7FFFFFFF if u & 0x80000000 else ~u & 0xFFFFFFFF
    return float(np.uint32(u).view(np.float32))


def _launch(x, ms_in, ms_out, centers, vals, k: int,
            plan: Plan | None = None) -> None:
    """Rounds ``1 .. k - 1`` in one launch: ``centers[0]`` holds the first
    center; writes ``centers[1:]``, ``vals[1:]`` and the final maxsim into
    ``ms_out``. ``plan`` defaults to :func:`_plan`'s. Counts one launch and
    ``k - 1`` rounds. Returns the kernel's count of the rows its CTAs held
    compacted, a 0-d int32 tensor on the device (no sync)."""
    m, d = x.shape
    dev = x.device
    if plan is None:
        plan = _plan(
            m, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    best = torch.full((k,), -1, dtype=torch.int64, device=dev)  # all ones
    # each round's arrivals, then the rows held compacted
    arrive = torch.zeros((k + 1,), dtype=torch.int32, device=dev)
    status = launch_on(
        dev, cuda_function("fpf_iter", "fpf_iter_launch", 8, 10),
        x.data_ptr(), None if ms_in is None else ms_in.data_ptr(),
        ms_out.data_ptr(), centers.data_ptr(), vals.data_ptr(),
        best.data_ptr(), arrive.data_ptr(), arrive[k:].data_ptr(), m, d,
        plan.grid, plan.rows, plan.cached, int(plan.center_in_smem),
        int(plan.ms_in_smem), plan.compact_bytes, 1, k,
    )
    check_status("fpf_iter", status)
    count_launch(fpf_iter)
    count_launch(fpf_iter, "rounds", k - 1)
    if trace.profiling():
        trace.count("fpf_iter.rows", m)
        trace.count_device("fpf_iter.compact_rows", arrive[k])
    return arrive[k]


def fpf_iter(x: torch.Tensor, cur: torch.Tensor, maxsim: torch.Tensor):
    """One fused FPF round: ``(new_maxsim (m,), next_idx () i32,
    next_val () f32)``.

    ``cur`` is an integer tensor holding the row of the newest center in
    ``x`` (the reference takes the center vector; the kernel reads the row
    itself). ``maxsim`` is not modified.
    """
    _check(x, maxsim)
    cur = torch.as_tensor(cur, device=x.device)
    if not on_cuda(x, cur, maxsim):
        return fpf_iter_ref(x, cur, maxsim)
    new = torch.empty_like(maxsim)
    centers = torch.empty((2,), dtype=torch.int32, device=x.device)
    centers[0] = cur.reshape(()).to(torch.int32)
    vals = torch.empty((2,), dtype=torch.float32, device=x.device)
    _launch(x, maxsim, new, centers, vals, 2)
    return new, centers[1], vals[1]


fpf_iter.launches = 0
fpf_iter.rounds = 0


def fpf_centers_fused(x: torch.Tensor, k: int, first) -> torch.Tensor:
    """Full Gonzalez FPF through the fpf_iter kernel.

    ``first`` is the index of the first center (the caller draws it; the
    reference draws it from a JAX key). Returns ``(k,)`` int32 row indices
    of ``x``. On the card all ``k - 1`` rounds run in ONE launch, each
    round reading the center the previous one chose on the device.
    """
    with trace.span("kernels.fpf_iter"):
        m = x.shape[0]
        maxsim = torch.full((m,), float("-inf"), dtype=torch.float32,
                            device=x.device)
        _check(x, maxsim)
        first = torch.as_tensor(first, device=x.device).reshape(()).to(
            torch.int32)
        if not on_cuda(x):
            idxs = [first]
            cur = first
            for _ in range(k - 1):
                maxsim, cur, _ = fpf_iter_ref(x, cur, maxsim)
                idxs.append(cur)
            return torch.stack(idxs)
        centers = torch.empty((k,), dtype=torch.int32, device=x.device)
        centers[0] = first
        if k > 1:
            vals = torch.empty((k,), dtype=torch.float32, device=x.device)
            _launch(x, None, maxsim, centers, vals, k)
        return centers
