"""setup_s: process start to the first timed step (host clock): imports,
data from the seed, the program's set-up and builds, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
