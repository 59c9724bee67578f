"""span_host_ms.build: host self ms a window step in the program's
``repro_torch.build.*`` spans: the index build (FPF sample and centres, assignment and medoid passes, bucket packing, the bucket-major pack). A span's self time is its duration
less its child spans' (``perfbench/program_trace.py``)."""

from perfbench.program_trace import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "build")
