"""span_host_ms.model: host self ms a window step in the program's
``repro_torch.model.*`` spans: the model that makes the queries (``MIND.forward``, the query encoder). A span's self time is its duration
less its child spans' (``perfbench/program_trace.py``)."""

from perfbench.program_trace import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "model")
