"""topk_score_roofline: the least time the chip needs for the exhaustive
top-k (the shard read once, the queries and outputs; 2 nq n D operations at
the bf16 peak) over the device time of ``topk_score``'s kernels."""

from perfbench.roofline import share_pct


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or not work or "topk_score" not in work["kernel"]:
        return None
    return share_pct(work["kernel"]["topk_score"], tr.kernel_s("topk_score"))
