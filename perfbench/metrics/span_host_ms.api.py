"""span_host_ms.api: host self ms a window step in the program's
``repro_torch.api.*`` spans: the typed API (``Retriever.search``'s cache lookups and each request's query and weights, planning and grouping, the per-field decomposition, the copies to the host and the hits). A span's self time is its duration
less its child spans' (``perfbench/program_trace.py``)."""

from perfbench.program_trace import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "api")
