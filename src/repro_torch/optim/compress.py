"""Gradient compression for the data-parallel all-reduce (port of
:mod:`repro.optim.compress`), over name -> tensor mappings.

* **error-feedback top-k**: keep the top-k magnitude entries per tensor,
  carry the residual and add it back next step;
* **int8 quantisation with a per-tensor scale**: ``torch.round`` rounds
  half to even, as ``jnp.round`` does, so ``q`` is the reference's.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["ef_topk_compress", "int8_compress", "int8_decompress"]


def ef_topk_compress(grads: Mapping[str, torch.Tensor],
                     residual: Mapping[str, torch.Tensor],
                     k_frac: float = 0.01):
    """Error-feedback top-k sparsification -> ``(sparse_grads,
    new_residual)``; ``sparse_grads`` is dense with zeros off the top-k
    support. The threshold is the k-th largest magnitude, a value, so every
    entry tied with it is kept whichever tie ``topk`` picked."""
    sparse, new_res = {}, {}
    for name, g in grads.items():
        g = g.to(torch.float32) + residual[name]
        flat = g.reshape(-1)
        k = max(1, int(flat.shape[0] * k_frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        sparse[name] = torch.where(torch.abs(g) >= thresh, g, 0.0)
        new_res[name] = g - sparse[name]
    return sparse, new_res


def int8_compress(grads: Mapping[str, torch.Tensor]):
    """Per-tensor symmetric int8 quantisation: ``(q, scale)`` mappings."""
    qs, scales = {}, {}
    for name, g in grads.items():
        g = g.to(torch.float32)
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        qs[name] = torch.clamp(torch.round(g / scale), -127, 127).to(
            torch.int8)
        scales[name] = scale
    return qs, scales


def int8_decompress(q: Mapping[str, torch.Tensor],
                    scale: Mapping[str, torch.Tensor]):
    return {n: q[n].to(torch.float32) * scale[n] for n in q}
