"""Window time in which the device ran nothing, per image (ms): the host
path's time that the device does not hide."""

from perfbench.trace import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or not ctx.get("images"):
        return None
    return 1e3 * (tr.window_s - tr.busy_s) / ctx["images"]
