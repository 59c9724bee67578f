"""Adafactor [Shazeer & Stern, arXiv:1804.04235] — factored second moment
(port of :mod:`repro.optim.adafactor`).

For a ``(..., n, m)`` tensor with ``n, m >= 128`` the second-moment
estimate is a rank-1 outer product of row and column means: O(n + m) state
instead of O(n m). Smaller tensors keep a full fp32 second moment.
``beta2 = 1 - t ** -decay``, RMS update clipping at ``clip_threshold``, no
momentum, as the reference; slots and parameters are updated in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .adamw import Optimizer

__all__ = ["adafactor", "FactoredSlot", "FullSlot", "AdafactorState"]


class FactoredSlot(NamedTuple):
    vr: torch.Tensor   # row second moment (..., n)
    vc: torch.Tensor   # col second moment (..., m)


class FullSlot(NamedTuple):
    v: torch.Tensor


class AdafactorState(NamedTuple):
    step: int
    slots: dict[str, Any]


def _is_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,       # t^-decay second-moment schedule
    eps1: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        def slot(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _is_factored(p.shape):
                return FactoredSlot(
                    vr=torch.zeros(p.shape[:-1], **f32),
                    vc=torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                )
            return FullSlot(v=torch.zeros(p.shape, **f32))

        return AdafactorState(step=0, slots={n: slot(p)
                                             for n, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        # fp32, as the reference's step.astype(float32) ** -decay
        beta2 = float(np.float32(1.0)
                      - np.float32(step) ** np.float32(-decay))
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            g2 = torch.square(g) + eps1
            s = state.slots[name]
            if isinstance(s, FactoredSlot):
                s.vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
                s.vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
                denom = torch.clamp(torch.mean(s.vr, dim=-1, keepdim=True),
                                    min=eps1)
                u = (g * torch.rsqrt(s.vr[..., None] / denom[..., None])
                     * torch.rsqrt(s.vc[..., None, :]))
            else:
                s.v.mul_(beta2).add_((1 - beta2) * g2)
                u = g * torch.rsqrt(s.v)
            # update clipping by RMS
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps1)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p32 = p.to(torch.float32)
            if weight_decay:
                u = u + weight_decay * p32
            p.copy_(p32 - lr * u)
        return params, AdafactorState(step=step, slots=state.slots)

    return Optimizer(init=init, update=update)
