"""autoint [arXiv:1810.11921] — self-attention feature interaction (port of
:mod:`repro.configs.autoint`).

39 categorical fields (Criteo protocol: 26 raw categorical fields with the
public Criteo-Kaggle vocabularies + 13 bucketised dense fields of 100
buckets), embedding dim 16, 3 stacked interacting layers (2 heads,
d_attn 32) with residuals.
"""

from __future__ import annotations

from ..models.recsys import AutoIntConfig
from .common import recsys_retrieval_cell, recsys_serve_cell, recsys_train_cell

ARCH_ID = "autoint"


def _pad512(v: int) -> int:
    """Pad a vocab to a 512 multiple (the reference pads so tables shard
    over any mesh axis combination)."""
    return -(-v // 512) * 512


CRITEO_KAGGLE_VOCABS = (
    1_460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145,
    5_683, 8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4,
    7_046_547, 18, 15, 286_181, 105, 142_572,
)


def make_config() -> AutoIntConfig:
    return AutoIntConfig(
        name=ARCH_ID,
        vocab_sizes=tuple(_pad512(v) for v in CRITEO_KAGGLE_VOCABS)
        + (100,) * 13,
        embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32,
    )


def make_smoke_config() -> AutoIntConfig:
    return AutoIntConfig(
        name=ARCH_ID + "-smoke",
        vocab_sizes=(500,) * 8 + (50,) * 4,
        embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32,
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
