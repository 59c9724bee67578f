"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
(port of :mod:`repro.configs.mistral_large_123b`).

88L, d_model 12288, 96 heads (GQA kv=8, d_head 128), d_ff 28672 (SwiGLU),
vocab 32768. Dense — the deepest/widest assigned arch; the reference
trains it under Adafactor (factored second moment).
"""

from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig
from .common import lm_decode_cell, lm_prefill_cell, lm_train_cell

ARCH_ID = "mistral-large-123b"


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=88,
        d_model=12_288,
        n_heads=96,
        n_kv_heads=8,
        d_head=128,
        d_ff=28_672,
        vocab=32_768,
        dtype=torch.bfloat16,
        attn_q_chunk=512,
        attn_kv_chunk=1024,
    )


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_head=16,
        d_ff=224,
        vocab=301,
        dtype=torch.float32,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        max_seq_len=64,
    )


def cells():
    cfg = make_config()
    return [
        lm_train_cell(ARCH_ID, cfg, global_batch=256, seq_len=4096, n_micro=8),
        lm_prefill_cell(ARCH_ID, cfg, global_batch=32, seq_len=32_768),
        lm_decode_cell(ARCH_ID, cfg, global_batch=128, seq_len=32_768,
                       shape_name="decode_32k"),
        lm_decode_cell(ARCH_ID, cfg, global_batch=1, seq_len=524_288,
                       shape_name="long_500k"),
    ]
