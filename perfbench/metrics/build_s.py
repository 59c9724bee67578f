"""build_s: the window's seconds over the builds it completed (host
clock); a build is a whole index, ready to serve, built from the corpus."""


def read(ctx):
    if ctx["n_steps"] == 0:
        return None
    return ctx["window_s"] / ctx["n_steps"]
