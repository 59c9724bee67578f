"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family; unverified]
(port of :mod:`repro.configs.llama4_maverick_400b_a17b`).

48L, d_model 5120, 40 q heads (GQA kv=8, d_head 128), d_ff 8192,
vocab 202048, MoE 128 routed experts top-1 + 1 shared expert, MoE every
second layer (the Llama-4 interleave — this is what lands total params at
~400B with ~17B active). Early-fusion multimodal frontend
is a stub: token ids (text) enter the stream; precomputed patch
embeddings would enter the same stream.
"""

from __future__ import annotations

import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .common import lm_decode_cell, lm_prefill_cell, lm_train_cell

ARCH_ID = "llama4-maverick-400b-a17b"


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202_048,
        moe=MoEConfig(
            n_experts=128, top_k=1, d_expert=8192, n_shared=1, moe_every=2,
        ),
        dtype=torch.bfloat16,
        attn_q_chunk=512,
        attn_kv_chunk=1024,
    )


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID + "-smoke",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_head=8,
        d_ff=128,
        vocab=503,
        moe=MoEConfig(n_experts=8, top_k=1, d_expert=128, n_shared=1,
                      moe_every=2),
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
