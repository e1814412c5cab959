"""Timing for the port's experiments: `slope_time`, the port's own copy of
the JAX package's (`s3od_tpu/profiling.py`), which it may not import.

`fn()` enqueues one call and returns its output; `readback(out)` reads a
scalar of that output back to the host. The difference of two runs of
n_small and n_large in-order calls, each ended by one readback, over
n_large - n_small is the time of one call with the fixed costs cancelled.
On a CUDA `device` each run is timed between CUDA events around its calls
(the card's clock; the readback after them synchronises the stream), else
on the host's clock.
"""

from __future__ import annotations

import time
from typing import Callable


def slope_time(
    fn: Callable[[], object],
    readback: Callable[[object], float],
    *,
    n_small: int = 3,
    n_large: int = 13,
    repeats: int = 2,
    device=None,
) -> float:
    """Seconds per invocation of `fn`, overhead-cancelled."""
    out = fn()
    readback(out)
    cuda = device is not None and str(device).startswith("cuda")

    def run(n):
        if cuda:
            import torch

            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        if cuda:
            end.record()
        readback(out)
        if cuda:
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    run(2)  # warm
    t1 = min(run(n_small) for _ in range(repeats))
    t2 = min(run(n_large) for _ in range(repeats))
    return (t2 - t1) / (n_large - n_small)
