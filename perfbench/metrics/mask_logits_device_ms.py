"""Device time launched on the same thread inside the program's spans
`s3od.kernel.mask_logits` (the DPT mask heads' logits tail pass, in the
forward) and `s3od.kernel.mask_logits_bwd` (its backward, on the autograd
engine's thread), summed, per step (ms). A program without the spans
reads None."""

from perfbench.spans import device_ms_per_step

SPANS = ("s3od.kernel.mask_logits", "s3od.kernel.mask_logits_bwd")


def read(ctx):
    parts = [device_ms_per_step(ctx, name) for name in SPANS]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
