"""resolve_sync_pct: the batch validity checks the API made for the raw
query vectors it resolved, as a share of those vectors: the program's
``api.resolve_syncs`` over ``api.raw_queries`` counters over the window
(100 when each request is resolved alone, 100 / n when a batch of n is
resolved at once). The program counts one check for each resolution that
has raw vectors, so this reads how the resolution was grouped, not syncs
measured on the device: a sync added elsewhere in the path does not show
here."""

from perfbench.program_trace import ratio_pct


def read(ctx):
    return ratio_pct(ctx, "api.resolve_syncs", "api.raw_queries")
