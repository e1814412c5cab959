"""Device time launched by the autograd engine (the backward, with any
recompute), per step (ms)."""

from perfbench.trace import BACKWARD, traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or not ctx.get("steps"):
        return None
    evs = tr.launched_in(BACKWARD)
    if not evs:
        return None
    return 1e3 * tr.seconds(evs) / ctx["steps"]
