"""span_host_ms.engine: host self ms a window step in the program's
``repro_torch.engine.*`` spans: the engine (``FusedEngine``'s prepare, schedule and finish, ``navigate``). A span's self time is its duration
less its child spans' (``perfbench/program_trace.py``)."""

from perfbench.program_trace import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "engine")
