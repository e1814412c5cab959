"""The reader of `qk_norm_rope_device_ms.lora` on small synthetic Chrome
traces: the device time launched inside the `s3od.kernel.qk_norm_rope`
and `s3od.kernel.qk_norm_rope_bwd` spans on the launching thread, summed,
per step; None where the spans are absent (a program before them)."""

from __future__ import annotations

import pytest

from perfbench import core
from perfbench.trace import Trace


def _x(name, cat, ts, dur, tid=None, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if tid is not None:
        e["tid"] = tid
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid, corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, corr=corr)


def _read(trace):
    return core.metric_reader("qk_norm_rope_device_ms.lora").read(
        {"trace": trace, "steps": 2})


def test_both_passes_summed_on_the_launching_thread():
    """Two steps: the forward pass inside a single block's span on the
    main thread 1, the backward pass on the engine's thread 2; K7's span
    and a launch of thread 2 inside the forward span's interval are left
    out, and the `s3od.kernel.qk_norm_rope` span does not take in the
    `_bwd` span by its prefix."""
    tr = Trace([
        _x("perfbench.window", "user_annotation", 0, 1000, 1),
        _x("s3od.train.step", "user_annotation", 10, 400, 1),
        _x("s3od.train.step", "user_annotation", 450, 500, 1),
        _x("s3od.mmdit.single_block", "user_annotation", 20, 100, 1),
        _x("s3od.kernel.qk_norm_rope", "user_annotation", 30, 20, 1),
        _launch(35, 1, 1),
        _launch(40, 2, 2),
        _x("s3od.kernel.flash_attention_online", "user_annotation", 60, 20, 1),
        _launch(65, 3, 1),
        _x("s3od.kernel.qk_norm_rope_bwd", "user_annotation", 500, 20, 2),
        _launch(505, 4, 2),
        _x("s3od.kernel.qk_norm_rope", "user_annotation", 600, 20, 1),
        _launch(605, 5, 1),
        _kernel("_fwd", 100, 40, 1),
        _kernel("cutlass_gemm", 140, 30, 2),
        _kernel("flash_ws_fwd_kernel", 170, 50, 3),
        _kernel("_bwd", 520, 60, 4),
        _kernel("_fwd", 640, 40, 5),
    ])
    # (40 + 60 + 40) us over two steps
    assert _read(tr) == pytest.approx(0.070)


def test_only_the_forward_span_reads_it_alone():
    """A trace with the forward pass's span and no backward's (a step
    under no_grad) reads the forward's time alone."""
    tr = Trace([_x("perfbench.window", "user_annotation", 0, 100, 1),
                _x("s3od.train.step", "user_annotation", 0, 100, 1),
                _x("s3od.kernel.qk_norm_rope", "user_annotation", 10, 20, 1),
                _launch(12, 1, 1), _kernel("_fwd", 30, 30, 1)])
    assert _read(tr) == pytest.approx(0.030)


def test_without_the_spans_reads_none():
    """A program that opens neither span (the eager chain) reads None,
    never 0, whatever else its trace holds."""
    tr = Trace([_x("perfbench.window", "user_annotation", 0, 100, 1),
                _x("s3od.train.step", "user_annotation", 0, 100, 1),
                _x("s3od.mmdit.dual_block", "user_annotation", 10, 50, 1),
                _launch(20, 1, 1), _kernel("elementwise_kernel", 30, 30, 1)])
    assert _read(tr) is None
    assert _read(Trace([])) is None
