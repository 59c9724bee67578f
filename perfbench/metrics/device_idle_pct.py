"""device_idle_pct.<suffix> (``.search``, ``.build``): the share of the
traced window in which no operation runs on the device (the profiler's
timeline). The suffix names the end-to-end metric it moves."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
