"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``bucket_score_tiled``, ``bucket_score`` (v1), ``topk_score``,
``embed_bag`` and ``fpf_iter``, all CUDA C++ (``csrc/``). Importing this
package compiles nothing."""

from .bucket_score import (
    bucket_score,
    bucket_score_ref,
    bucket_score_tiled,
    bucket_score_tiled_ref,
    build_probe_schedule,
    build_probe_schedule_device,
    dequantize_bucket_major,
    pack_bucket_major,
    pick_query_tile,
    quantize_bucket_major,
    schedule_block_reads,
    schedule_length,
)
from .common import pad_to, resolve_device
from .embed_bag import embed_bag, embed_bag_ref
from .fpf_iter import fpf_centers_fused, fpf_iter, fpf_iter_ref
from .topk_score import topk_score, topk_score_ref

__all__ = [
    "bucket_score",
    "bucket_score_ref",
    "bucket_score_tiled",
    "bucket_score_tiled_ref",
    "build_probe_schedule",
    "build_probe_schedule_device",
    "dequantize_bucket_major",
    "embed_bag",
    "embed_bag_ref",
    "fpf_centers_fused",
    "fpf_iter",
    "fpf_iter_ref",
    "pack_bucket_major",
    "pad_to",
    "pick_query_tile",
    "quantize_bucket_major",
    "resolve_device",
    "schedule_block_reads",
    "schedule_length",
    "topk_score",
    "topk_score_ref",
]
