"""tile_fill_pct: of the (query row, slot) pairs that
``bucket_score_tiled``'s scoring launches compute (each live sub-tile and
slot of the probe schedule, times the sub-tile's rows), the share whose
query probes the slot's bucket: the program's ``tile_fill.marked`` over
``tile_fill.computed`` counters over the window."""

from perfbench.program_trace import ratio_pct


def read(ctx):
    return ratio_pct(ctx, "tile_fill.marked", "tile_fill.computed")
