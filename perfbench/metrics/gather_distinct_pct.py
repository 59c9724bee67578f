"""gather_distinct_pct: of the candidate rows that ``serve_online_rank``
gathers (every probed bucket's ``bucket_pad`` slots, sentinels and rows
repeated across clusterings included), the share that are live and left
after its dedup: the program's ``online.distinct`` over ``online.gathered``
counters over the window."""

from perfbench.program_trace import ratio_pct


def read(ctx):
    return ratio_pct(ctx, "online.distinct", "online.gathered")
