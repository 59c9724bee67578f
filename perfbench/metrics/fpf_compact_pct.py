"""fpf_compact_pct: of the rows that ``fpf_iter``'s launches scored, the
share its CTAs held in shared memory in compacted (value, column) form: the
program's ``fpf_iter.compact_rows`` over ``fpf_iter.rows`` counters over
the window."""

from perfbench.program_trace import ratio_pct


def read(ctx):
    return ratio_pct(ctx, "fpf_iter.compact_rows", "fpf_iter.rows")
