"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``bucket_score_tiled`` (CUDA C++, ``csrc/``) and ``fpf_iter``
(Triton). Importing this package compiles nothing."""

from .bucket_score import (
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
from .fpf_iter import fpf_centers_fused, fpf_iter, fpf_iter_ref

__all__ = [
    "bucket_score_tiled",
    "bucket_score_tiled_ref",
    "build_probe_schedule",
    "build_probe_schedule_device",
    "dequantize_bucket_major",
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
]
