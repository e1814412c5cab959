"""Device time launched inside the encoder's forward (the range
`perfbench.encoder`), per image (ms)."""

from perfbench.trace import ranged_device_ms


def read(ctx):
    return ranged_device_ms(ctx, "perfbench.encoder")
