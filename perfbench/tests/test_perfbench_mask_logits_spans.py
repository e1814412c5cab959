"""The reader of `mask_logits_device_ms.train` on small synthetic Chrome
traces: the device time launched inside the `s3od.kernel.mask_logits`
and `s3od.kernel.mask_logits_bwd` spans on the launching thread, summed,
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
    return core.metric_reader("mask_logits_device_ms.train").read(
        {"trace": trace, "steps": 2})


def test_both_passes_summed_on_the_launching_thread():
    """Two steps: the forward pass inside the forward's span on the main
    thread 1, the backward pass on the engine's thread 2; the fused 3x3's
    conv before it, a launch of thread 2 inside the forward span's
    interval and the dgrad after the backward's span are left out, and
    the `s3od.kernel.mask_logits` span does not take in the `_bwd` span
    by its prefix."""
    tr = Trace([
        _x("perfbench.window", "user_annotation", 0, 1000, 1),
        _x("s3od.train.step", "user_annotation", 10, 400, 1),
        _x("s3od.train.step", "user_annotation", 450, 500, 1),
        _x("s3od.train.forward", "user_annotation", 20, 100, 1),
        _launch(25, 1, 1),
        _x("s3od.kernel.mask_logits", "user_annotation", 30, 20, 1),
        _launch(35, 2, 1),
        _launch(40, 3, 2),
        _x("s3od.kernel.mask_logits_bwd", "user_annotation", 500, 20, 2),
        _launch(505, 4, 2),
        _launch(530, 5, 2),
        _x("s3od.kernel.mask_logits", "user_annotation", 600, 20, 1),
        _launch(605, 6, 1),
        _kernel("sm90_xmma_fprop_implicit_gemm", 60, 30, 1),
        _kernel("_fwd", 100, 40, 2),
        _kernel("cutlass_gemm", 140, 30, 3),
        _kernel("_bwd", 540, 80, 4),
        _kernel("sm90_xmma_dgrad_implicit_gemm", 620, 50, 5),
        _kernel("_fwd", 700, 40, 6),
    ])
    # (40 + 80 + 40) us over two steps
    assert _read(tr) == pytest.approx(0.080)


def test_only_the_forward_span_reads_it_alone():
    """A trace with the forward pass's span and no backward's (a step
    under no_grad) reads the forward's time alone."""
    tr = Trace([_x("perfbench.window", "user_annotation", 0, 100, 1),
                _x("s3od.train.step", "user_annotation", 0, 100, 1),
                _x("s3od.kernel.mask_logits", "user_annotation", 10, 20, 1),
                _launch(12, 1, 1), _kernel("_fwd", 30, 30, 1)])
    assert _read(tr) == pytest.approx(0.030)


def test_without_the_spans_reads_none():
    """A program that opens neither span (the eager chain: cuDNN's grouped
    conv and its dgrad) reads None, never 0, whatever else its trace
    holds."""
    tr = Trace([_x("perfbench.window", "user_annotation", 0, 100, 1),
                _x("s3od.train.step", "user_annotation", 0, 100, 1),
                _x("s3od.train.backward", "user_annotation", 10, 50, 2),
                _launch(20, 1, 2),
                _kernel("dgrad2d_grouped_direct_kernel", 30, 30, 1)])
    assert _read(tr) is None
    assert _read(Trace([])) is None
