"""Architecture registry: ``get_arch(<id>)`` -> config module (counterpart
of :mod:`repro.configs`).

Every module exposes ``ARCH_ID``, ``make_config()`` and
``make_smoke_config()`` under the reference's ids. The recsys family is
ported; the dry-run units (``cells()``) and the other families come with
later slices, and asking for them raises ``KeyError``.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "get_arch"]

_MODULES = {
    "bst": ".bst",
    "dlrm-mlperf": ".dlrm_mlperf",
    "autoint": ".autoint",
    "mind": ".mind",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"arch {arch_id!r} is unknown or not ported yet; ported: "
            f"{', '.join(ARCH_IDS)}"
        )
    return importlib.import_module(_MODULES[arch_id], __package__)
