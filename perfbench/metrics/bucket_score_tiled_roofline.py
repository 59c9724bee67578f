"""bucket_score_tiled_roofline: the least time the chip needs for a
batch's bucket scoring over the device time of ``bucket_score_tiled``'s
launches (scoring and merge kernels, by the port's kernel names in the
trace). Work (counted by the system module from the reference's
navigation): each distinct live pack row of the probed buckets read once,
the queries, the outputs written once; 2 D operations a distinct (query,
candidate) pair at the fp32 peak."""

from perfbench.roofline import share_pct


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or not work or "bucket_score_tiled" not in work["kernel"]:
        return None
    return share_pct(work["kernel"]["bucket_score_tiled"],
                     tr.kernel_s("bucket_score_tiled", "slot_merge"))
