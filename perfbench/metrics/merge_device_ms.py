"""Device time (kernels, copies, sets) launched on the same thread inside
the program's spans `s3od.lora.merge` (the adapters merged into each
targeted block's weights), per step (ms)."""

from perfbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "s3od.lora.merge")
