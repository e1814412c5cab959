"""Timing and trace summaries (the port's counterpart of
`s3od_tpu/profiling.py`, which it may not import).

`slope_time`: `fn()` enqueues one call and returns its output;
`readback(out)` reads a scalar of that output back to the host. The
difference of two runs of n_small and n_large in-order calls, each ended
by one readback, over n_large - n_small is the time of one call with the
fixed costs cancelled. On a CUDA `device` each run is timed between CUDA
events around its calls (the card's clock; the readback after them
synchronises the stream), else on the host's clock.

`capture_trace` runs a callable under `torch.profiler` and writes a
Chrome trace; `summarize_trace` aggregates its device-kernel durations
by kernel family, by kernel and by the port's spans (on a trace without
device work, the outermost host operators instead), and `print_summary`
prints the tables, as the JAX package's helpers do for a `jax.profiler`
trace.

`span(name)` marks a phase of the port (`s3od.train.forward`,
`s3od.kernel.flash_attention_bwd`, ...) as a `record_function` range
while a profiler records, so that it lands in the same trace as the
device's kernels, on their clock; with no profiler running it opens
nothing (one flag read).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import gzip
import json
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "s3od."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that opens the profiler range `name` while a
    profiler records (`torch.autograd.profiler._is_profiler_enabled`;
    where a torch lacks that flag, always), and does nothing otherwise or
    while `torch.export` traces (a range would enter the graph)."""
    if (not getattr(_autograd_profiler, "_is_profiler_enabled", True)
            or torch.compiler.is_exporting()):
        return _NO_SPAN
    return _autograd_profiler.record_function(name)


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


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_description(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (its name alone where
    nvidia-smi cannot be run), or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def capture_trace(fn: Callable[[], object], trace_dir: str, iters: int = 3) -> str:
    """Run `fn` `iters` times under `torch.profiler` (CPU, and CUDA when a
    card is present; the card is synchronised before the trace closes) and
    write a Chrome trace; returns its `.json.gz` path."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json.gz"
    prof.export_chrome_trace(str(path))
    return str(path)


def _family(name: str) -> str:
    """A kernel's family: its name without `void `, template arguments and
    parameters, namespaces dropped."""
    base = re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0]
    return base.rsplit("::", 1)[-1].strip() or name


def _outermost(events):
    """The events no other event of their thread encloses."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        end = -1.0
        for e in sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0))):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e.get("dur", 0)
    return out


def summarize_trace(trace_path: str, *, iters: int = 3, top_k: int = 15) -> Dict:
    """Aggregate the durations of a `capture_trace` trace.

    Device work (CUDA kernels, copies and sets) when the trace holds any;
    else the outermost host operators ("cpu_op"). Returns {"source":
    "device" | "host", "total_ms": per-iteration sum, "by_category":
    [(family, ms, count per iteration)], "top_ops": [(ms, name)],
    "by_span": [(span name, ms, count per iteration)]}: `by_span` is the
    work launched inside each `span` of the port (device work by the
    runtime or driver call that launched it, host operators by their own
    start) on the same thread."""
    opener = gzip.open if str(trace_path).endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    picked = [e for e in events if e.get("cat") in DEVICE_CATS]
    source = "device"
    if not picked:
        picked = _outermost([e for e in events if e.get("cat") == "cpu_op"])
        source = "host"
    cat: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    durs: Dict[str, float] = collections.defaultdict(float)
    for e in picked:
        name = e["name"]
        fam = _family(name)
        cat[fam] += e.get("dur", 0)
        count[fam] += 1
        durs[name[:120]] += e.get("dur", 0)
    total = sum(cat.values()) / iters / 1e3
    by_category = sorted(
        ((k, v / iters / 1e3, count[k] // iters) for k, v in cat.items()),
        key=lambda kv: -kv[1])
    top_ops = sorted(((v / iters / 1e3, n) for n, v in durs.items()),
                     key=lambda kv: -kv[0])[:top_k]
    return {"source": source, "total_ms": total, "by_category": by_category,
            "top_ops": top_ops, "by_span": _by_span(events, picked, iters)}


def _by_span(events, picked, iters: int):
    """[(span name, ms, count per iteration)] of the `picked` events
    launched inside the `SPAN_PREFIX` ranges of each name, on the same
    thread (a range nested in one of its own name counts once)."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    origins = []
    for e in picked:
        at = e
        if e.get("cat") in DEVICE_CATS:
            at = launches.get(e.get("args", {}).get("correlation"))
        if at is not None:
            origins.append(((at.get("pid"), at.get("tid")), at["ts"], e.get("dur", 0)))
    ranges = collections.defaultdict(lambda: collections.defaultdict(list))
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            ranges[e["name"]][(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    out = []
    for name, by_thread in ranges.items():
        merged = {}
        for thread, spans in by_thread.items():
            merged[thread] = []
            for a, b in sorted(spans):
                if merged[thread] and a <= merged[thread][-1][1]:
                    merged[thread][-1][1] = max(merged[thread][-1][1], b)
                else:
                    merged[thread].append([a, b])
        dur, count = 0.0, 0
        for thread, t, d in origins:
            spans = merged.get(thread)
            if not spans:
                continue
            i = bisect.bisect_right(spans, [t, float("inf")]) - 1
            if i >= 0 and t <= spans[i][1]:
                dur += d
                count += 1
        out.append((name, dur / iters / 1e3, count // iters))
    return sorted(out, key=lambda kv: -kv[1])


def print_summary(summary: Dict) -> None:
    print(f"{summary['source']} total: {summary['total_ms']:.3f} ms/step")
    print("by category:")
    for name, ms, cnt in summary["by_category"][:10]:
        print(f"  {ms:8.3f} ms  x{cnt:4d}  {name}")
    print("top ops:")
    for ms, name in summary["top_ops"]:
        print(f"  {ms:8.3f} ms  {name}")
    if summary.get("by_span"):
        print("by span:")
        for name, ms, cnt in summary["by_span"]:
            print(f"  {ms:8.3f} ms  x{cnt:4d}  {name}")
