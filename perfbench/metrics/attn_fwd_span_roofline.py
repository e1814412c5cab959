"""Least time of the window's attention forward calls (counted by the
driver from its steps' shapes, `ctx["attn_fwd_least_s"]`) over the device
time launched inside the program's span
`s3od.kernel.flash_attention_online` (K7), whatever its kernels are named
(%)."""

from perfbench.spans import device_ms_per_step, steps
from perfbench.trace import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or not ctx.get("attn_fwd_least_s"):
        return None
    per_step = device_ms_per_step(ctx, "s3od.kernel.flash_attention_online")
    if not per_step:
        return None
    return 100.0 * ctx["attn_fwd_least_s"] / (per_step * steps(tr) / 1e3)
