"""step_roofline.<suffix>: the least time the chip needs for the window's
steps over the window's host seconds; the whole step's share, which still
bounds a gain once a kernel has left the path. The system driver counts
the step's work from the algorithm and the inputs (``work()["step"]``):

* ``.search``: navigation over every leader and the scoring of each
  distinct candidate, each at the peak of its dtype; the leaders, the
  distinct candidate rows, the queries and the outputs once a batch.
* ``.build``: the FPF rounds and every assignment pass at the fp32 peak;
  the corpus read once and the pack's live rows written once a build.
"""

from perfbench.roofline import share_pct


def read(ctx):
    if not ctx["work"] or ctx["n_steps"] == 0:
        return None
    return share_pct(ctx["work"]["step"], ctx["window_s"])
