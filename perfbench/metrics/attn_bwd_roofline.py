"""Least time of the window's attention backward calls (counted by the
driver from its steps' shapes) over the device time of the kernels of
`kernels/attention_bwd.json` (%)."""

from perfbench.trace import kernel_map, traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or not ctx.get("attn_bwd_least_s"):
        return None
    evs = tr.kernels(kernel_map("attention_bwd"))
    if not evs:
        return None
    return 100.0 * ctx["attn_bwd_least_s"] / tr.seconds(evs)
