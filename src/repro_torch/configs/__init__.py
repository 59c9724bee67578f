"""Architecture registry: ``get_arch(<id>)`` -> config module (counterpart
of :mod:`repro.configs`).

Every module exposes ``ARCH_ID``, ``make_config()``, ``make_smoke_config()``
and ``cells() -> list[Cell]`` (the dry-run units) under the reference's
ids: the 10 assigned archs plus the paper's own retrieval system.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "ASSIGNED_ARCH_IDS", "get_arch", "all_cells"]

_MODULES = {
    "llama4-maverick-400b-a17b": ".llama4_maverick_400b_a17b",
    "qwen2-moe-a2.7b": ".qwen2_moe_a2_7b",
    "mistral-large-123b": ".mistral_large_123b",
    "minitron-8b": ".minitron_8b",
    "qwen3-8b": ".qwen3_8b",
    "gcn-cora": ".gcn_cora",
    "bst": ".bst",
    "dlrm-mlperf": ".dlrm_mlperf",
    "autoint": ".autoint",
    "mind": ".mind",
    "paper-retrieval": ".paper_retrieval",
}

ARCH_IDS = tuple(_MODULES)
ASSIGNED_ARCH_IDS = tuple(a for a in ARCH_IDS if a != "paper-retrieval")


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}"
        )
    return importlib.import_module(_MODULES[arch_id], __package__)


def all_cells(archs=None):
    out = []
    for a in archs or ARCH_IDS:
        out.extend(get_arch(a).cells())
    return out
