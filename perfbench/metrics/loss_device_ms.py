"""Device time (kernels, copies, sets) launched on the same thread inside
the program's span `s3od.train.loss`, per step (ms)."""

from perfbench.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, "s3od.train.loss")
