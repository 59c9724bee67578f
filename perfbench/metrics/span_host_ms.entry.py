"""span_host_ms.entry: host self ms a window step in the program's
``repro_torch.entry.*`` spans: the search entry and the rank program (``weighted_query``, ``serve_online_rank``'s gather and dedup, ``serve_brute_rank``, ``gather_merge``). A span's self time is its duration
less its child spans' (``perfbench/program_trace.py``)."""

from perfbench.program_trace import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "entry")
