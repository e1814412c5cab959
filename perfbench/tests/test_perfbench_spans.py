"""The readers of the program's spans (`perfbench/spans.py` and the
metrics on it) on small synthetic Chrome traces: device time by exact span
name on the launching thread, the host's synchronizing calls inside the
steps (not the waits between them), the host's issue time net of them,
idle time by the innermost span, and None where the spans are absent."""

from __future__ import annotations

import pytest

from perfbench import core, spans
from perfbench.trace import Trace


def x(name, cat, ts, dur, tid=None, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if tid is not None:
        e["tid"] = tid
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur, tid=1):
    return x(name, "user_annotation", ts, dur, tid)


def launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return x(name, "cuda_runtime", ts, 2, tid, corr)


def kernel(name, ts, dur, corr, cat="kernel"):
    return x(name, cat, ts, dur, corr=corr)


def two_steps():
    """Two steps in a 1000 us window on thread 1. Step A [10, 400] holds
    forward [20, 100] (with the RoPE tables [25, 45] and a forward kernel
    span), loss, backward [120, 300] (K8's span on the engine's thread 2),
    metrics, optimizer; step B [450, 900] one forward. One stream sync in
    the tables (10 us), one on thread 2 inside step B (10 us), one event
    sync between the steps."""
    return Trace([
        span("perfbench.window", 0, 1000),
        span("s3od.train.step", 10, 390),
        span("s3od.train.forward", 20, 80),
        span("s3od.encoder.rope_tables", 25, 20),
        x("cudaStreamSynchronize", "cuda_runtime", 30, 10, 1, 100),
        launch(42, 1),
        span("s3od.kernel.flash_attention", 50, 10),
        launch(55, 6),
        launch(80, 8, tid=2),  # another thread: not the forward's
        span("s3od.train.loss", 100, 20),
        launch(110, 2),
        span("s3od.train.backward", 120, 180),
        span("s3od.kernel.flash_attention_bwd", 150, 50, tid=2),
        launch(160, 5, tid=2, name="cuLaunchKernelEx"),
        span("s3od.train.metrics", 300, 10),
        span("s3od.train.optimizer", 310, 80),
        launch(320, 3),
        x("cudaEventSynchronize", "cuda_runtime", 400, 50, 1, 101),
        span("s3od.train.step", 450, 450),
        span("s3od.train.forward", 460, 40),
        launch(470, 7),
        x("cuStreamSynchronize", "cuda_driver", 600, 10, 2, 102),
        kernel("fwd_elementwise", 100, 50, 1),
        kernel("flash_ws_fwd_kernel", 150, 40, 6),
        kernel("other_thread_kernel", 190, 30, 8),
        kernel("loss_kernel", 220, 10, 2),
        kernel("bwd_dkv_kernel", 300, 100, 5),
        kernel("Memset (Device)", 400, 20, 3, cat="gpu_memset"),
        kernel("fwd_elementwise", 500, 60, 7),
    ])


def read(name, ctx):
    return core.metric_reader(name).read(ctx)


def test_device_time_by_exact_span_on_the_launching_thread():
    ctx = {"trace": two_steps(), "steps": 2}
    # forward: 50 + 40 (the kernel span nested in it) + 60, over two steps;
    # the launch of thread 2 at 80 us is left out
    assert read("forward_device_ms.train", ctx) == pytest.approx(0.075)
    assert read("loss_device_ms.train", ctx) == pytest.approx(0.005)
    assert read("optimizer_device_ms.train", ctx) == pytest.approx(0.010)
    assert spans.device_ms_per_step(ctx, "s3od.kernel.flash_attention") == pytest.approx(0.020)
    # `s3od.kernel.flash_attention` is a prefix of the K8 span's name:
    # only K8's own kernel counts for it
    assert spans.device_ms_per_step(ctx, "s3od.kernel.flash_attention_bwd") == pytest.approx(0.050)


def test_span_roofline_reads_the_kernel_span_whatever_its_kernels():
    ctx = {"trace": two_steps(), "steps": 2, "attn_bwd_least_s": 50e-6}
    assert read("attn_bwd_span_roofline.train", ctx) == pytest.approx(50.0)
    assert read("attn_bwd_span_roofline.train", {**ctx, "attn_bwd_least_s": 0}) is None


def test_syncs_inside_steps_on_any_thread_not_between_them():
    ctx = {"trace": two_steps(), "steps": 2}
    # the tables' stream sync (thread 1) and the driver sync of thread 2
    # inside step B; the event sync between the steps is the window's
    assert read("host_syncs.train", ctx) == pytest.approx(1.0)


def test_host_issue_time_is_net_of_the_syncs():
    ctx = {"trace": two_steps(), "steps": 2}
    # (390 - 10) and (450 - 10) us
    assert read("host_issue_ms.train", ctx) == pytest.approx(0.41)


def test_steps_without_syncs_read_zero_syncs():
    tr = Trace([span("perfbench.window", 0, 100), span("s3od.train.step", 0, 50),
                launch(10, 1), kernel("k", 20, 10, 1)])
    assert read("host_syncs.train", {"trace": tr}) == 0
    assert read("host_issue_ms.train", {"trace": tr}) == pytest.approx(0.05)
    assert read("loss_device_ms.train", {"trace": tr}) is None


def test_idle_by_span_names_the_innermost_span_or_between_steps():
    tr = Trace([
        span("perfbench.window", 0, 1000),
        span("s3od.train.step", 0, 600),
        span("s3od.train.forward", 0, 300),
        span("s3od.encoder.rope_tables", 50, 110),
        span("s3od.kernel.flash_attention_bwd", 400, 100, tid=2),
        x("aten::copy_", "cpu_op", 140, 20, 1),  # not a span of the program
        kernel("a", 0, 100, 1), kernel("b", 200, 220, 2), kernel("c", 480, 120, 3),
    ])
    idle = dict(spans.idle_by_span(tr))
    assert idle == pytest.approx({"s3od.encoder.rope_tables": 100e-6,
                                  "s3od.kernel.flash_attention_bwd": 60e-6,
                                  spans.BETWEEN: 400e-6})
    assert spans.idle_by_span(Trace([])) == []


@pytest.mark.parametrize("name", ["forward_device_ms.train", "loss_device_ms.train",
                                  "optimizer_device_ms.train", "host_issue_ms.train",
                                  "host_syncs.train", "attn_bwd_span_roofline.train"])
def test_readers_without_the_spans_read_none(name):
    """A program that opens no spans (a version before them): a trace
    with device work and host ranges, none of them the program's, reads
    None, never 0."""
    plain = Trace([span("perfbench.window", 0, 100), launch(10, 1),
                   x("cudaStreamSynchronize", "cuda_runtime", 30, 10, 1, 2),
                   span("autograd::engine::evaluate_function: X", 5, 50),
                   kernel("bwd_dkv_kernel", 20, 30, 1)])
    ctx = {"trace": plain, "steps": 1, "images": 4, "attn_bwd_least_s": 1e-5}
    assert read(name, ctx) is None
    assert read(name, {**ctx, "trace": Trace([])}) is None
    assert read(name, {"trace": None}) is None


def test_idle_after_a_span_runs_to_the_next_device_work():
    tr = Trace([span("perfbench.window", 0, 1000), span("s3od.train.step", 0, 900),
                span("s3od.encoder.rope_tables", 50, 50),
                kernel("a", 0, 60, 1), kernel("b", 180, 100, 2)])
    # the tables end at 100, the card idles from 60 to 180: 80 us after them
    assert spans.idle_after(tr, "s3od.encoder.rope_tables") == pytest.approx(0.08)
    assert spans.idle_after(tr, "s3od.train.loss") is None
