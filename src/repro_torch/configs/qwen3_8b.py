"""qwen3-8b [hf:Qwen/Qwen3-8B] (port of :mod:`repro.configs.qwen3_8b`).

36L, d_model 4096, 32 heads (GQA kv=8, d_head 128), d_ff 12288,
vocab 151936, **qk-norm** (per-head RMS norm on q and k — the Qwen3
signature), SwiGLU.
"""

from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig

ARCH_ID = "qwen3-8b"


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12_288,
        vocab=151_936,
        qk_norm=True,
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
        n_kv_heads=2,
        d_head=16,
        d_ff=192,
        vocab=353,
        qk_norm=True,
        dtype=torch.float32,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        max_seq_len=64,
    )

