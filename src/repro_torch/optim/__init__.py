"""Optimizers and distributed-training tricks (port of :mod:`repro.optim`).

adamw       AdamW with decoupled weight decay
sgd         SGD with Nesterov momentum
adafactor   factored second moment
grad_accum  microbatched gradient accumulation
compress    error-feedback top-k / int8 gradient compression

Every optimizer follows the reference's protocol over name -> tensor
mappings (``dict(model.p)``): ``state = opt.init(params)``; ``params,
state = opt.update(grads, state, params)``. The parameters and the state's
tensors are updated in place and returned. :func:`from_reference_state`
carries the reference's optimizer state across, as
``repro_torch.models.recsys.from_reference_params`` carries weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .adafactor import AdafactorState, FactoredSlot, FullSlot, adafactor
from .adamw import AdamWState, adamw
from .compress import ef_topk_compress, int8_compress, int8_decompress
from .grad_accum import accumulate_gradients
from .sgd import SGDState, sgd

__all__ = [
    "adamw", "sgd", "adafactor", "accumulate_gradients",
    "ef_topk_compress", "int8_compress", "int8_decompress",
    "from_reference_state",
]


def from_reference_state(state, like):
    """The port's counterpart of a reference optimizer state.

    ``state`` is the reference's ``AdamWState`` / ``SGDState`` /
    ``AdafactorState`` with numpy (or array-like) leaves in name ->
    array mappings; ``like`` is the port's state of the same optimizer
    (``opt.init(params)``), which fixes the type, devices and dtypes.
    Returns a new port state holding the reference's values."""
    def carry(ref: Mapping, mine: Mapping) -> dict:
        if set(ref) != set(mine):
            raise KeyError(f"state names differ: {sorted(set(ref) ^ set(mine))}")
        out = {}
        for n, t in mine.items():
            a = np.asarray(ref[n])
            if a.shape != tuple(t.shape):
                raise ValueError(f"{n}: shape {a.shape}, expected "
                                 f"{tuple(t.shape)}")
            out[n] = torch.tensor(a).to(t.device, t.dtype)
        return out

    if isinstance(like, AdamWState):
        return AdamWState(step=int(np.asarray(state.step)),
                          mu=carry(state.mu, like.mu),
                          nu=carry(state.nu, like.nu))
    if isinstance(like, SGDState):
        return SGDState(momentum=carry(state.momentum, like.momentum))
    if isinstance(like, AdafactorState):
        if set(state.slots) != set(like.slots):
            raise KeyError(f"state names differ: "
                           f"{sorted(set(state.slots) ^ set(like.slots))}")
        slots = {}
        for n, s in like.slots.items():
            r = state.slots[n]
            kind = FactoredSlot if isinstance(s, FactoredSlot) else FullSlot
            if type(r).__name__ != kind.__name__:
                raise ValueError(f"{n}: reference slot {type(r).__name__}, "
                                 f"expected {kind.__name__}")
            slots[n] = kind(**carry(r._asdict(), s._asdict()))
        return AdafactorState(step=int(np.asarray(state.step)), slots=slots)
    raise TypeError(f"not an optimizer state of this package: "
                    f"{type(like).__name__}")
