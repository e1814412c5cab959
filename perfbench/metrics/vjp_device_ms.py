"""Device time launched inside the program's spans `s3od.vjp.<op>` (the
written-out backwards of K2, K4 and K5, on the autograd engine's thread),
summed over the three ops, per step (ms). A program without the spans
reads None."""

from perfbench.spans import device_ms_per_step

SPANS = ("s3od.vjp.qkv_project_rope", "s3od.vjp.attn_epilogue",
         "s3od.vjp.mlp_fused")


def read(ctx):
    parts = [device_ms_per_step(ctx, name) for name in SPANS]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
