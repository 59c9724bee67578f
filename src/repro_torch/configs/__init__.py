"""Architecture registry: ``get_arch(<id>)`` -> config module (counterpart
of :mod:`repro.configs`).

Every module exposes ``ARCH_ID``, ``make_config()`` and
``make_smoke_config()`` under the reference's ids. The recsys family and
the five LM configurations are ported; the dry-run units (``cells()``),
the GNN family and ``paper-retrieval`` come with later slices, and asking
for them raises ``KeyError``.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "get_arch"]

_MODULES = {
    "bst": ".bst",
    "dlrm-mlperf": ".dlrm_mlperf",
    "autoint": ".autoint",
    "mind": ".mind",
    "llama4-maverick-400b-a17b": ".llama4_maverick_400b_a17b",
    "qwen2-moe-a2.7b": ".qwen2_moe_a2_7b",
    "mistral-large-123b": ".mistral_large_123b",
    "minitron-8b": ".minitron_8b",
    "qwen3-8b": ".qwen3_8b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"arch {arch_id!r} is unknown or not ported yet; ported: "
            f"{', '.join(ARCH_IDS)}"
        )
    return importlib.import_module(_MODULES[arch_id], __package__)
