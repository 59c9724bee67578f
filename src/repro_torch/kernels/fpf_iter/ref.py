"""Plain PyTorch version of one fused FPF round (the kernel's twin).

Same function as :func:`repro.kernels.fpf_iter.ref.fpf_iter_ref`, except
that the newest center is named by its row index ``cur`` in ``x`` (the
Hopper kernel reads ``x[cur]`` itself, so the round loop never needs the
index on the host).
"""

from __future__ import annotations

import torch

__all__ = ["fpf_iter_ref"]


def fpf_iter_ref(
    x: torch.Tensor,        # (m, D) unit points, float32
    cur: torch.Tensor,      # int tensor with one element: row of the newest center
    maxsim: torch.Tensor,   # (m,) running max-similarity to the center set
):
    """Returns ``(new_maxsim (m,), next_idx () int32, next_val () f32)``.

    ``torch.argmin`` returns the first index among equal minima, which is
    the reference's rule (``jnp.argmin``; the kernel's strict ``<`` fold).
    """
    c = x.index_select(0, cur.reshape(1).long()).reshape(-1)
    sim = torch.mv(x, c)
    new = torch.maximum(maxsim, sim)
    idx = torch.argmin(new)
    return new, idx.to(torch.int32), new[idx]
