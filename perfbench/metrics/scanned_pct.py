"""scanned_pct: of the live rows that every request of the window could
have been scored against, the share its search scored (the members of
every probed bucket, rows probed in two clusterings counted twice, and
the leaders): the program's ``api.scored`` (the responses' ``n_scored``)
over ``api.candidates`` (requests times live rows) counters over the
window."""

from perfbench.program_trace import ratio_pct


def read(ctx):
    return ratio_pct(ctx, "api.scored", "api.candidates")
