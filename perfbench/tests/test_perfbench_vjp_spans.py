"""The reader of `vjp_device_ms.train` on small synthetic Chrome traces:
the device time launched inside the three `s3od.vjp.<op>` spans on the
launching thread, summed, per step; None where the spans are absent."""

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


def _launch(ts, corr, tid=2):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid, corr)


def _kernel(name, ts, dur, corr):
    return _x(name, "kernel", ts, dur, corr=corr)


def _read(trace):
    return core.metric_reader("vjp_device_ms.train").read(
        {"trace": trace, "steps": 2})


def test_vjp_spans_summed_on_the_launching_thread():
    """Two steps; the backward's spans on the engine's thread 2: K5's
    (two kernels, one inside its pass's kernel span), K4's, K2's, and
    K8's, which is not a vjp span. A launch of thread 1 inside K5's
    interval is left out."""
    tr = Trace([
        _x("perfbench.window", "user_annotation", 0, 1000, 1),
        _x("s3od.train.step", "user_annotation", 10, 400, 1),
        _x("s3od.train.step", "user_annotation", 450, 500, 1),
        _x("s3od.vjp.mlp_fused", "user_annotation", 100, 50, 2),
        _launch(105, 1),
        _x("s3od.kernel.gelu_bwd", "user_annotation", 110, 10, 2),
        _launch(112, 2),
        _launch(120, 3, tid=1),
        _x("s3od.vjp.attn_epilogue", "user_annotation", 160, 20, 2),
        _launch(165, 4),
        _x("s3od.kernel.flash_attention_bwd", "user_annotation", 190, 20, 2),
        _launch(195, 5),
        _x("s3od.vjp.qkv_project_rope", "user_annotation", 500, 20, 2),
        _launch(505, 6),
        _kernel("Kernel2", 200, 40, 1),
        _kernel("gelu_bwd", 240, 10, 2),
        _kernel("forward_kernel", 250, 30, 3),
        _kernel("cutlass_gemm", 280, 20, 4),
        _kernel("bwd_dkv_kernel", 300, 100, 5),
        _kernel("rope_bwd", 600, 30, 6),
    ])
    # (40 + 10 + 20 + 30) us over two steps
    assert _read(tr) == pytest.approx(0.050)


def test_without_the_vjp_spans_reads_none():
    """A program that opens no `s3od.vjp.` spans (a version before them)
    reads None, never 0, whatever else its trace holds."""
    tr = Trace([_x("perfbench.window", "user_annotation", 0, 100, 1),
                _x("s3od.train.step", "user_annotation", 0, 100, 1),
                _x("s3od.kernel.flash_attention_bwd", "user_annotation",
                   10, 50, 2),
                _launch(20, 1), _kernel("bwd_dkv_kernel", 30, 30, 1)])
    assert _read(tr) is None
    assert _read(Trace([])) is None
