"""span_host_ms.kernels: host self ms a window step in the program's
``repro_torch.kernels.*`` spans: the kernels' host wrappers (``bucket_score_tiled``, ``topk_score``, ``fpf_centers_fused``: checks, buffers, launches). A span's self time is its duration
less its child spans' (``perfbench/program_trace.py``)."""

from perfbench.program_trace import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "kernels")
