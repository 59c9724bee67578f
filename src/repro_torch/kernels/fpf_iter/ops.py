"""Wrappers for the fused FPF round and the full FPF loop built on it.

Counterpart of :mod:`repro.kernels.fpf_iter.ops`. A CPU tensor goes to the
plain version (:mod:`.ref`); a CUDA tensor goes to the Triton kernel
(:mod:`.kernel`) or the call raises — there is no fallback. ``fpf_iter``
counts its kernel launches in ``fpf_iter.launches`` (one per round).
"""

from __future__ import annotations

import torch

from ..common import on_cuda
from . import kernel as _k
from .ref import fpf_iter_ref

__all__ = ["fpf_iter", "fpf_centers_fused"]


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


def _blocks(m: int) -> tuple[int, int]:
    """Stage-1 block shape: BLOCK_M rows, doubled until stage 2 can reduce
    every partial in one block; the tile stays at BLOCK_M·BLOCK_D values."""
    block_m = _k.BLOCK_M
    while -(-m // block_m) > _k.MAX_PARTS:
        block_m *= 2
    block_d = max(16, (_k.BLOCK_M * _k.BLOCK_D) // block_m)
    return block_m, block_d


def _launch_round(x, centers, round_i, maxsim, part_val, part_idx, out_val):
    """One round on the card: updates ``maxsim`` in place and writes the
    next center's row into ``centers[round_i]`` (reading the newest center
    from ``centers[round_i - 1]``). Counts one launch."""
    stage1, stage2 = _k.kernels()
    m, d = x.shape
    block_m, block_d = _blocks(m)
    n_parts = -(-m // block_m)
    stage1[(n_parts,)](
        x, centers, round_i, maxsim, part_val, part_idx, m, d, x.stride(0),
        BLOCK_M=block_m, BLOCK_D=block_d, num_warps=4,
    )
    stage2[(1,)](
        part_val, part_idx, n_parts, centers, round_i, out_val,
        BLOCK_P=max(16, 1 << (n_parts - 1).bit_length()), num_warps=4,
    )
    fpf_iter.launches += 1


def _scratch(x):
    m = x.shape[0]
    n_parts = -(-m // _blocks(m)[0])
    dev = x.device
    return (
        torch.empty((n_parts,), dtype=torch.float32, device=dev),
        torch.empty((n_parts,), dtype=torch.int32, device=dev),
        torch.empty((1,), dtype=torch.float32, device=dev),
    )


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
    new = maxsim.clone()
    centers = torch.empty((2,), dtype=torch.int32, device=x.device)
    centers[0] = cur.reshape(()).to(torch.int32)
    part_val, part_idx, out_val = _scratch(x)
    _launch_round(x, centers, 1, new, part_val, part_idx, out_val)
    return new, centers[1], out_val[0]


fpf_iter.launches = 0


def fpf_centers_fused(x: torch.Tensor, k: int, first) -> torch.Tensor:
    """Full Gonzalez FPF driven round by round through the fpf_iter kernel.

    ``first`` is the index of the first center (the caller draws it; the
    reference draws it from a JAX key). Returns ``(k,)`` int32 row indices
    of ``x``. On the card the ``k - 1`` rounds launch back to back: each
    round reads its center from the ``centers`` buffer the previous round
    wrote, and ``maxsim`` is updated in place, so the loop has no host
    synchronisation and allocates nothing per round.
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
    part_val, part_idx, out_val = _scratch(x)
    for i in range(1, k):
        _launch_round(x, centers, i, maxsim, part_val, part_idx, out_val)
    return centers
