"""search_p95_ms: the 95th percentile over every query of the window of
the time from its batch's dispatch until its results are on the host
(host clock). All queries of a batch share its latency and every batch has
as many, so it is the 95th percentile of the batch latencies."""

import numpy as np


def read(ctx):
    lat = ctx["latencies_s"]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
