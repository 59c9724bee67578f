"""The roofline yardstick: the published peaks of one NVIDIA H100 SXM
(``peaks.json``, NVIDIA's data sheet, dense rates at the 700 W limit) and
the least time a piece of work can take on it."""

from __future__ import annotations

import functools
import json
import os

_PEAKS = os.path.join(os.path.dirname(__file__), "peaks.json")


@functools.cache
def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def bound_s(nbytes: float, flops: dict) -> float:
    """The least seconds the chip needs for ``nbytes`` of HBM traffic and
    ``flops`` (``{dtype: operations}``, each at that dtype's peak): the
    larger of the byte time and the summed operation times."""
    p = peaks()
    t_bytes = nbytes / p["hbm_bytes_per_s"]
    t_ops = sum(n / p["flops_per_s"][dt] for dt, n in flops.items())
    return max(t_bytes, t_ops)


def share_pct(work: dict | None, seconds: float | None) -> float | None:
    """``work`` (``{"bytes": .., "flops": {dtype: ..}}``) over ``seconds``
    measured, as a percentage of the roofline; None when either is
    missing."""
    if not work or not seconds or seconds <= 0:
        return None
    return 100.0 * bound_s(work["bytes"], work["flops"]) / seconds
