"""AdamW (decoupled weight decay) over a name -> tensor mapping (port of
:mod:`repro.optim.adamw`).

The reference's arithmetic, in its order: every gradient cast to fp32,
scaled by the global-norm clip, then the moments, the bias corrections
``1 - b ** step`` in fp32, and ``p - lr * (m_hat / (sqrt(v_hat) + eps) +
wd * p)``. Unlike the reference, which makes new arrays, the port updates
the parameters and the moments in place under ``torch.no_grad()``: at
DLRM's scale one copy of the parameters or of the gradients is 6.7 GB. The
clip's norm is a sum of per-tensor fp32 norms, so no second fp32 copy of
the gradients is made; it differs from the reference's sum of squares in
the order of the fp32 sums only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

__all__ = ["adamw", "Optimizer", "AdamWState", "global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Minimal optimizer protocol shared by adamw/sgd/adafactor:
    ``state = init(params)``; ``params, state = update(grads, state,
    params)``, with ``params`` and ``grads`` name -> tensor mappings."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


class AdamWState(NamedTuple):
    step: int                            # updates taken (the host's count)
    mu: dict[str, torch.Tensor]          # fp32 first moments, by name
    nu: dict[str, torch.Tensor]          # fp32 second moments, by name


def fp32_pow_complement(b: float, step: int) -> float:
    """``1 - b ** step`` in fp32, as the reference computes it on device."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(step))


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum_t |g_t|^2)`` over every gradient, a 0-dim fp32 tensor on
    the gradients' device: per-tensor fp32 norms, squared and summed."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads.values()]
    return torch.stack(norms).square().sum().sqrt()


def adamw(
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: float | None = 1.0,
) -> Optimizer:
    def init(params):
        zeros = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in params.items()}
        return AdamWState(step=0, mu=zeros,
                          nu={n: z.clone() for n, z in zeros.items()})

    @torch.no_grad()
    def update(grads, state, params):
        scale = None
        if grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        step = state.step + 1
        bc1 = fp32_pow_complement(b1, step)
        bc2 = fp32_pow_complement(b2, step)
        for name, p in params.items():
            g32 = grads[name].to(torch.float32)
            g32 = g32 * scale if scale is not None else g32
            m, v = state.mu[name], state.nu[name]
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            del g32
            u = torch.div(m, bc1)
            u.div_(torch.div(v, bc2).sqrt_().add_(eps))
            if p.dtype == torch.float32:
                u.add_(p, alpha=weight_decay)
                p.sub_(u, alpha=lr)
            else:
                p32 = p.to(torch.float32)
                u.add_(p32, alpha=weight_decay)
                p.copy_(p32.sub_(u, alpha=lr))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update)
