"""fpf_iter_roofline: the least time the chip needs for the FPF rounds of
every build in the window (each clustering's sample read once; 2 m D
operations a round, K - 1 rounds, at the fp32 peak) over the device time of
the ``fpf_iter`` kernel."""

from perfbench.roofline import share_pct


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if tr is None or not work or "fpf_iter" not in work["kernel"]:
        return None
    return share_pct(work["kernel"]["fpf_iter"], tr.kernel_s("fpf_"))
