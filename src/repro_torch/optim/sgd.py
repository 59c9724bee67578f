"""SGD with (Nesterov) momentum (port of :mod:`repro.optim.sgd`): the
reference's arithmetic, updating the parameters and the fp32 momentum in
place."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .adamw import Optimizer

__all__ = ["sgd", "SGDState"]


class SGDState(NamedTuple):
    momentum: dict[str, torch.Tensor]    # fp32, by parameter name


def sgd(
    lr: float = 0.1, momentum: float = 0.9, nesterov: bool = True,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return SGDState(momentum={
            n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()})

    @torch.no_grad()
    def update(grads, state, params):
        for name, p in params.items():
            p32 = p.to(torch.float32)
            g = grads[name].to(torch.float32) + weight_decay * p32
            m = state.momentum[name]
            m.mul_(momentum).add_(g)
            step = g.add_(m, alpha=momentum) if nesterov else m
            p.copy_(p32 - lr * step)
        return params, state

    return Optimizer(init=init, update=update)
