"""Wrappers for the fused FPF round and the full FPF loop built on it.

Counterpart of :mod:`repro.kernels.fpf_iter.ops`. A CPU tensor goes to the
plain version (:mod:`.ref`); a CUDA tensor goes to the hand-written CUDA
kernel ``csrc/fpf_iter.cu`` (built with ``nvcc`` for ``sm_90a`` on first
use, bound with ``ctypes``) or the call raises — there is no fallback, and
a grid the card cannot hold at once is refused, never run round by round.
The kernel runs every round of one FPF run in one cooperative launch.
``fpf_iter.launches`` counts launches and ``fpf_iter.rounds`` the rounds
they ran.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import (SMEM_BYTES_PER_BLOCK, check_status, count_launch,
                      cuda_function, launch_on, on_cuda, pad_to)
from .ref import fpf_iter_ref

__all__ = ["fpf_iter", "fpf_centers_fused"]
_WARPS = 16        # kWarps in the CUDA source: 512 threads per CTA
_KEY_BYTES = 8 * _WARPS + 16   # each warp's key and the current center


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


def _plan(m: int, d: int, n_sms: int):
    """The cooperative grid: ``(grid, rows_per_cta, cached, center_in_smem,
    ms_in_smem)``.

    At most one CTA per SM (a CTA takes most of an SM's shared memory) and
    at least a row per warp; CTA ``b`` owns rows ``[b R, (b + 1) R)``, the
    last possibly fewer, none empty. The center's row is copied into shared
    memory each round when it takes at most half of it, the CTA's maxsim
    values stay there when they take at most a quarter, and as many of its
    rows as the rest holds are cached there (``run_smem_bytes`` in the CUDA
    source)."""
    grid = max(1, min(n_sms, -(-m // _WARPS)))
    rows = -(-m // grid)
    grid = -(-m // rows)
    row_bytes = 4 * pad_to(d, 4)
    center_in_smem = row_bytes <= SMEM_BYTES_PER_BLOCK // 2
    ms_in_smem = 4 * rows <= SMEM_BYTES_PER_BLOCK // 4
    fixed = _smem_bytes(rows, 0, d, center_in_smem, ms_in_smem)
    cached = min(rows, (SMEM_BYTES_PER_BLOCK - fixed) // row_bytes)
    return grid, rows, cached, center_in_smem, ms_in_smem


def _smem_bytes(rows: int, cached: int, d: int, center_in_smem: bool,
                ms_in_smem: bool) -> int:
    """Shared memory of one CTA (``run_smem_bytes`` in the CUDA source)."""
    return (4 * (cached + center_in_smem) * pad_to(d, 4) + _KEY_BYTES
            + (4 * rows if ms_in_smem else 0))


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


def _launch(x, ms_in, ms_out, centers, vals, k: int) -> None:
    """Rounds ``1 .. k - 1`` in one launch: ``centers[0]`` holds the first
    center; writes ``centers[1:]``, ``vals[1:]`` and the final maxsim into
    ``ms_out``. Counts one launch and ``k - 1`` rounds."""
    m, d = x.shape
    dev = x.device
    grid, rows, cached, center_in_smem, ms_in_smem = _plan(
        m, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    best = torch.full((k,), -1, dtype=torch.int64, device=dev)  # all ones
    arrive = torch.zeros((k,), dtype=torch.int32, device=dev)
    status = launch_on(
        dev, cuda_function("fpf_iter", "fpf_iter_launch", 7, 9),
        x.data_ptr(), None if ms_in is None else ms_in.data_ptr(),
        ms_out.data_ptr(), centers.data_ptr(), vals.data_ptr(),
        best.data_ptr(), arrive.data_ptr(), m, d, grid, rows, cached,
        int(center_in_smem), int(ms_in_smem), 1, k,
    )
    check_status("fpf_iter", status)
    count_launch(fpf_iter)
    count_launch(fpf_iter, "rounds", k - 1)


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
    m = x.shape[0]
    maxsim = torch.full((m,), float("-inf"), dtype=torch.float32,
                        device=x.device)
    _check(x, maxsim)
    first = torch.as_tensor(first, device=x.device).reshape(()).to(torch.int32)
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
