"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]
(port of :mod:`repro.configs.qwen2_moe_a2_7b`).

24L, d_model 2048, 16 heads (kv=16 — MHA), per-expert d_ff 1408,
vocab 151936; 60 routed experts top-4 + 4 shared experts (shared width
4x1408 = 5632). The routed-expert count is PADDED 60 -> 64 so the expert
dim divides the 16-way model axis (4 padding experts; the router can route
to them — capacity identical, FLOPs +6.7%).
"""

from __future__ import annotations

import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .common import lm_decode_cell, lm_prefill_cell, lm_train_cell

ARCH_ID = "qwen2-moe-a2.7b"


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab=151_936,
        moe=MoEConfig(
            n_experts=64,            # 60 routed, padded to 64 (mesh divisibility)
            top_k=4,
            d_expert=1408,
            n_shared=4,              # 4 shared experts = 5632 shared width
            moe_every=1,
        ),
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
        n_kv_heads=4,
        d_head=16,
        d_ff=96,
        vocab=401,
        moe=MoEConfig(n_experts=8, top_k=4, d_expert=96, n_shared=2,
                      moe_every=1),
        dtype=torch.float32,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        max_seq_len=64,
    )


def cells():
    cfg = make_config()
    return [
        lm_train_cell(ARCH_ID, cfg, global_batch=256, seq_len=4096, n_micro=4),
        lm_prefill_cell(ARCH_ID, cfg, global_batch=32, seq_len=32_768),
        lm_decode_cell(ARCH_ID, cfg, global_batch=128, seq_len=32_768,
                       shape_name="decode_32k"),
        lm_decode_cell(ARCH_ID, cfg, global_batch=1, seq_len=524_288,
                       shape_name="long_500k"),
    ]
