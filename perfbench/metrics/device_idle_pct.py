"""The share of the traced window in which no kernel, copy or set ran (%)."""

from perfbench.trace import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
