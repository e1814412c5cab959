"""Device time launched on the same thread inside the program's spans
`s3od.mmdit.single_block` (the forward of each single-stream block), less
what its `s3od.lora.merge` spans launched, per step (ms): the reader of
`dual_block_device_ms` on the other span."""

from perfbench import core

_DUAL = core.load_module(core.BENCH / "metrics" / "dual_block_device_ms.py",
                         "perfbench_metric_dual_block_device_ms")


def read(ctx):
    return _DUAL.read(ctx, "s3od.mmdit.single_block")
