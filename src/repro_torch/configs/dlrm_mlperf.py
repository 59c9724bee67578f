"""dlrm-mlperf [arXiv:1906.00091] — the MLPerf DLRM benchmark config (port
of :mod:`repro.configs.dlrm_mlperf`).

13 dense features, 26 categorical features with the Criteo-Terabyte
(max_ind_range = 40M) vocabulary sizes from the MLPerf reference
implementation (~188M embedding rows x dim 128 = ~96 GB fp32), bottom MLP
13-512-256-128, dot interaction, top MLP (479)-1024-1024-512-256-1.
"""

from __future__ import annotations

from ..models.recsys import DLRMConfig
from .common import recsys_retrieval_cell, recsys_serve_cell, recsys_train_cell

ARCH_ID = "dlrm-mlperf"


def _pad512(v: int) -> int:
    """Pad a vocab to a 512 multiple (the reference pads so tables shard
    over any mesh axis combination)."""
    return -(-v // 512) * 512


# MLPerf DLRM / Criteo Terabyte, day-based preprocessing, max_ind_range=40M
CRITEO_TB_VOCABS = (
    39_884_406, 39_043, 17_289, 7_420, 20_263, 3, 7_120, 1_543, 63,
    38_532_951, 2_953_546, 403_346, 10, 2_208, 11_938, 155, 4, 976, 14,
    39_979_771, 25_641_295, 39_664_984, 585_935, 12_972, 108, 36,
)


def make_config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID,
        vocab_sizes=tuple(_pad512(v) for v in CRITEO_TB_VOCABS),
    )


def make_smoke_config() -> DLRMConfig:
    return DLRMConfig(
        name=ARCH_ID + "-smoke",
        vocab_sizes=(1000, 50, 3000, 7, 120, 4000) + (64,) * 20,
        embed_dim=16,
        bot_mlp=(13, 32, 16),
        top_mlp_hidden=(64, 32, 1),
    )


def cells():
    cfg = make_config()
    return [
        recsys_train_cell(ARCH_ID, cfg, batch=65_536, shape_name="train_batch"),
        recsys_serve_cell(ARCH_ID, cfg, batch=512, shape_name="serve_p99"),
        recsys_serve_cell(ARCH_ID, cfg, batch=262_144, shape_name="serve_bulk"),
        recsys_retrieval_cell(ARCH_ID, cfg, n_candidates=1_000_000,
                              shape_name="retrieval_cand"),
    ]
