"""Microbatched gradient accumulation — activation-memory control (port of
:mod:`repro.optim.grad_accum`).

``accumulate_gradients(loss_fn, params, batch, n_micro)`` splits the
leading batch axis into ``n_micro`` microbatches, runs one backward per
microbatch and averages, so activations live for one microbatch at a time.
The reference's ``grad_specs`` (sharding constraints on the accumulator)
has no counterpart here: sharding waits for the dry-run slice.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

__all__ = ["accumulate_gradients"]


def _value_and_grad(loss_fn, params, batch):
    loss, aux = loss_fn(params, batch)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    # a parameter the loss does not reach gets zeros, as jax.grad gives
    return loss.detach(), {
        n: torch.zeros_like(params[n]) if g is None else g
        for n, g in zip(names, grads)}, aux


def accumulate_gradients(
    loss_fn: Callable[..., Any],
    params: Mapping[str, torch.Tensor],
    batch: Mapping[str, torch.Tensor],
    n_micro: int,
):
    """Returns ``(mean_loss, mean_grads, aux_of_last_micro)``.

    ``loss_fn(params, microbatch) -> (loss, aux)``, with ``params`` a name
    -> tensor mapping whose tensors require grad; every tensor in ``batch``
    must have a leading axis divisible by ``n_micro``. With ``n_micro > 1``
    the loss and the gradients are fp32 sums of ``x / n_micro`` taken in
    microbatch order, as the reference's scan."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch[{k!r}] has leading axis {x.shape[0]}, "
                             f"not divisible by n_micro={n_micro}")
    loss_acc = 0.0
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    aux = None
    for i in range(n_micro):
        mb = {k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])[i]
              for k, x in batch.items()}
        loss, grads, aux = _value_and_grad(loss_fn, params, mb)
        for n, g in grads.items():
            g_acc[n].add_(g.to(torch.float32) / n_micro)
        loss_acc = loss_acc + loss.to(torch.float32) / n_micro
    return loss_acc, g_acc, aux
