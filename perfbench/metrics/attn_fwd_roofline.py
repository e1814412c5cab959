"""Least time of the attention forward calls over their kernels' device
time (%); a call is one kernel of `kernels/attention_fwd.json`, at the
cell's one shape."""

from perfbench import flops
from perfbench.trace import kernel_map, traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or "attn_call" not in ctx:
        return None
    evs = tr.kernels(kernel_map("attention_fwd"))
    if not evs:
        return None
    least = len(evs) * flops.attention_fwd_least_s(*ctx["attn_call"])
    return 100.0 * least / tr.seconds(evs)
