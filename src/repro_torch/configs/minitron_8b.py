"""minitron-8b [arXiv:2407.14679] — pruned Nemotron-4
(port of :mod:`repro.configs.minitron_8b`).

32L, d_model 4096, 32 heads (GQA kv=8, d_head 128), d_ff 16384,
vocab 256000. Nemotron lineage: squared-ReLU MLP (two matrices, no gate).
"""

from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "minitron-8b"


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=16_384,
        vocab=256_000,
        mlp_type="relu2",
        dtype=torch.bfloat16,
        attn_q_chunk=512,
        attn_kv_chunk=1024,
    )


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=256,
        vocab=257,
        mlp_type="relu2",
        dtype=torch.float32,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        max_seq_len=64,
    )

