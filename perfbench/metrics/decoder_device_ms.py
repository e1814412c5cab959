"""Device time launched inside the DPT head's forward (the range
`perfbench.decoder`), per image (ms)."""

from perfbench.trace import ranged_device_ms


def read(ctx):
    return ranged_device_ms(ctx, "perfbench.decoder")
