"""bst [arXiv:1905.06874] — Behavior Sequence Transformer (port of
:mod:`repro.configs.bst`).

Item embedding dim 32 over a Taobao-scale 4M-item vocabulary, user history
length 20 (+ target item = sequence 21), ONE transformer block with 8 heads,
head MLP 1024-512-256.
"""

from __future__ import annotations

from ..models.recsys import BSTConfig
from .common import recsys_retrieval_cell, recsys_serve_cell, recsys_train_cell

ARCH_ID = "bst"


def make_config() -> BSTConfig:
    return BSTConfig(
        name=ARCH_ID,
        n_items=4_000_256,            # 4M padded to a 512 multiple
        embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
        mlp=(1024, 512, 256),
    )


def make_smoke_config() -> BSTConfig:
    return BSTConfig(
        name=ARCH_ID + "-smoke", n_items=2_000, embed_dim=32, seq_len=20,
        n_blocks=1, n_heads=8, mlp=(64, 32),
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
