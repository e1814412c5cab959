"""The window's model FLOPs (the driver's count from `perfbench.flops`)
over its length, as a share of the bf16 dense peak (%)."""

from perfbench import flops
from perfbench.trace import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None:
        return None
    work = ctx.get("flops")
    if work is None and ctx.get("images"):
        work = ctx["flops_per_image"] * ctx["images"]
    if not work:
        return None
    return 100.0 * work / tr.window_s / flops.PEAK_BF16_FLOPS
