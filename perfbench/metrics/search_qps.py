"""search_qps: every query answered in the window over the window's
seconds (host clock); a query counts when its batch's ids and scores are on
the host."""


def read(ctx):
    if ctx["n_steps"] == 0:
        return None
    return ctx["queries"] / ctx["window_s"]
