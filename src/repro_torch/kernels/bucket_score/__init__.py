from .ops import (
    bucket_score_tiled,
    build_probe_schedule,
    build_probe_schedule_device,
    dequantize_bucket_major,
    pack_bucket_major,
    pick_query_tile,
    quantize_bucket_major,
    schedule_block_reads,
    schedule_length,
)
from .ref import bucket_score_tiled_ref

__all__ = [
    "bucket_score_tiled",
    "bucket_score_tiled_ref",
    "build_probe_schedule",
    "build_probe_schedule_device",
    "dequantize_bucket_major",
    "pack_bucket_major",
    "pick_query_tile",
    "quantize_bucket_major",
    "schedule_block_reads",
    "schedule_length",
]
