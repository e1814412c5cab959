"""The benchmark's arithmetic: the percentile over all requests, the
spread, and the reduction of a trace to busy time, idle share, exposed
host time and kernel time inside host ranges."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import core
from perfbench.trace import Trace, family


def test_p95_is_over_all_requests():
    vals = [float(i) for i in range(1, 201)]
    assert core.percentile(vals, 95) == pytest.approx(np.percentile(vals, 95))
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=333))
    assert core.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert core.percentile([5.0], 95) == 5.0


def synthetic():
    """A 1000 us window: kernels at [100, 300], [250, 400] (overlapping),
    [600, 700]; two launched inside an `perfbench.encoder` range on thread
    1, one launched by thread 2 outside any range."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
         "ts": 0, "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.encoder",
         "ts": 10, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20,
         "dur": 2, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 30,
         "dur": 2, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40,
         "dur": 2, "tid": 2, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "void flash_ws_fwd_kernel<64, true, 3>(x)",
         "ts": 100, "dur": 200, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 250,
         "dur": 150, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 600,
         "dur": 100, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 450,
         "dur": 100, "tid": 1},
    ]
    return Trace(ev)


def read(name, ctx):
    return core.metric_reader(name).read(ctx)


def test_busy_idle_and_exposed_host_time():
    tr = synthetic()
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(400e-6)  # [100, 400] and [600, 700]
    ctx = {"trace": tr, "images": 2}
    assert read("device_idle_pct.serve", ctx) == pytest.approx(60.0)
    assert read("exposed_host_ms.serve", ctx) == pytest.approx(0.3)  # 600 us / 2


def test_kernel_time_inside_ranges():
    tr = synthetic()
    ctx = {"trace": tr, "images": 1}
    assert read("encoder_device_ms.serve", ctx) == pytest.approx(0.35)
    assert read("decoder_device_ms.serve", ctx) is None
    assert family("void flash_ws_fwd_kernel<64, true, 3>(x)") == "flash_ws_fwd_kernel"


def test_idle_gaps_name_the_host_range():
    gaps = dict(synthetic().idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(200e-6)  # the gap [400, 600]


def test_readers_read_nothing_as_none():
    empty = Trace([])
    for name in ("device_idle_pct.train", "mfu.train", "attn_fwd_roofline.serve",
                 "attn_bwd_roofline.train", "exposed_host_ms.serve",
                 "backward_device_ms.train", "encoder_device_ms.latency"):
        assert read(name, {"trace": empty, "images": 1, "steps": 1}) is None
        assert read(name, {"trace": None}) is None


def test_roofline_share():
    tr = synthetic()
    ctx = {"trace": tr, "attn_call": (1, 64, 64)}
    from perfbench import flops
    least = flops.attention_fwd_least_s(1, 64, 64)
    assert read("attn_fwd_roofline.serve", ctx) == pytest.approx(100 * least / 200e-6)


def test_annotate_finds_the_module_by_path_or_nothing():
    import torch
    from perfbench.trace import annotate

    root = torch.nn.Module()
    root.model = torch.nn.Module()
    root.model.encoder = torch.nn.Linear(2, 2)
    hooks = annotate(root, "model.encoder", "perfbench.encoder")
    assert len(hooks) == 2
    for h in hooks:
        h.remove()
    assert annotate(root, "model.seg_head", "perfbench.decoder") == []
    assert annotate(root, "renamed.encoder", "perfbench.encoder") == []
