"""The program's own spans in a `--trace 1` run's trace: the ranges that
`s3od_torch.profiling.span` opens while the profiler records
(`s3od.train.step` and its phases, `s3od.encoder.rope_tables`,
`s3od.kernel.<wrapper>`), on the device trace's clock.

A span is matched by its exact name (`s3od.kernel.flash_attention` is a
prefix of `s3od.kernel.flash_attention_bwd`). Device work belongs to a
span when the runtime or driver call that launched it lies inside the
span on the same thread (`Trace._inside`). A program without the spans
reads None from every function here, never 0.

    python3 -m perfbench.spans --workload <cell> --seed <n>

runs the cell once with `--trace 1` on the card and prints, per step,
the device time launched inside each span and the window's idle time by
the innermost span open at each gap (`idle_by_span`), as JSON.
"""

from __future__ import annotations

import bisect
import collections
import heapq
import json
from typing import Dict, List, Optional

from perfbench.core import BENCH
from perfbench.trace import Trace, traced

PREFIX = "s3od."
STEP = "s3od.train.step"
BETWEEN = "between steps"


def named(tr: Trace, name: str) -> List[dict]:
    """The host ranges called exactly `name`."""
    return [e for e in tr.host if e["name"] == name]


def steps(tr: Trace) -> int:
    return len(named(tr, STEP))


def device_ms_per_step(ctx: dict, name: str) -> Optional[float]:
    """Device time (kernels, copies, sets) launched on the same thread
    inside the spans `name`, per `s3od.train.step` span (ms)."""
    tr = traced(ctx)
    if tr is None:
        return None
    spans, n = named(tr, name), steps(tr)
    if not spans or not n:
        return None
    return 1e3 * tr.seconds(tr._inside(spans)) / n


def sync_calls(tr: Trace) -> List[dict]:
    """The runtime and driver calls that make the host wait for the card
    (`kernels/host_syncs.json`)."""
    with open(BENCH / "kernels" / "host_syncs.json") as f:
        names = set(json.load(f)["calls"])
    return [e for e in tr.launches.values() if e["name"] in names]


def _starts_inside(events: List[dict], spans: List[dict]) -> List[dict]:
    """The events that start inside one of `spans`' intervals [start,
    end), on any thread."""
    merged: List[List[float]] = []
    for a, b in sorted((s["ts"], s["ts"] + s["dur"]) for s in spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    out = []
    for e in events:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] < merged[i][1]:
            out.append(e)
    return out


def host_syncs_per_step(ctx: dict) -> Optional[float]:
    """Synchronizing calls made inside a step span's interval, on any
    thread, per step (the window's waits between steps are left out)."""
    tr = traced(ctx)
    if tr is None:
        return None
    spans = named(tr, STEP)
    if not spans:
        return None
    return len(_starts_inside(sync_calls(tr), spans)) / len(spans)


def host_issue_ms_per_step(ctx: dict) -> Optional[float]:
    """Each step span's host time on its thread, less the time inside it
    that synchronizing calls (on any thread) cover: the host's own cost to
    issue a step, per step (ms)."""
    tr = traced(ctx)
    if tr is None:
        return None
    spans = named(tr, STEP)
    if not spans:
        return None
    waits = sorted((e["ts"], e["ts"] + e["dur"]) for e in sync_calls(tr))
    total = 0.0
    for s in spans:
        a, b = s["ts"], s["ts"] + s["dur"]
        covered, end = 0.0, a
        for wa, wb in waits:
            lo, hi = max(wa, end), min(wb, b)
            if hi > lo:
                covered += hi - lo
                end = hi
        total += s["dur"] - covered
    return total / len(spans) / 1e3


def idle_by_span(tr: Trace) -> List[list]:
    """The window's idle time (s), each gap put down to the innermost
    (shortest) `s3od.` span open at its middle on any thread, else to
    "between steps"; [[name, seconds]], largest first."""
    busy = tr.busy_intervals()
    gaps, prev = [], tr.t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < tr.t1:
        gaps.append((prev, tr.t1))
    spans = sorted((e for e in tr.host if e["name"].startswith(PREFIX)),
                   key=lambda e: e["ts"])
    tot: Dict[str, float] = collections.defaultdict(float)
    active: List[tuple] = []  # (end, dur, name) of spans begun so far
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i]["ts"] <= mid:
            e = spans[i]
            heapq.heappush(active, (e["ts"] + e["dur"], e["dur"], e["name"]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda s: s[1])[2] if active else BETWEEN
        tot[name] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])]


def idle_after(tr: Trace, name: str) -> Optional[float]:
    """The device idle time from each span `name`'s end to the next device
    work, summed, per step (ms): the wait a span that drained the stream
    leaves behind it."""
    ends = sorted(e["ts"] + e["dur"] for e in named(tr, name))
    if not ends or not steps(tr):
        return None
    busy = tr.busy_intervals()
    starts = [a for a, _ in busy]
    idle = 0.0
    for t in ends:
        i = bisect.bisect_right(starts, t)
        if i < len(busy) and (i == 0 or busy[i - 1][1] <= t):
            idle += busy[i][0] - t
    return idle / steps(tr) / 1e3


def table(tr: Trace) -> Dict[str, float]:
    """Device ms launched inside each `s3od.` span name, per step."""
    names = sorted({e["name"] for e in tr.host if e["name"].startswith(PREFIX)})
    ctx = {"trace": tr}
    return {n: device_ms_per_step(ctx, n) for n in names}


def _api_time(tr: Trace) -> Dict[str, float]:
    """Microseconds in each runtime or driver call that starts inside a
    step span."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for e in _starts_inside(list(tr.launches.values()), named(tr, STEP)):
        tot[e["name"]] += e["dur"]
    return tot


def main(argv=None) -> int:
    import argparse
    import os
    import time

    import torch

    from perfbench import core

    # the caches where `run.py` keeps them
    os.environ["S3OD_TORCH_BUILD_DIR"] = str(core.ROOT / "build" / "s3od_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(core.ROOT / "build" / "perfbench" / "triton")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        core.log("needs a CUDA card")
        return 2
    spec = core.cell(args.workload)
    drv = core.load_module(BENCH / "drivers" / f"{spec['workload']['driver']}.py",
                           "perfbench_driver")
    out = drv.run(spec, seed=args.seed, seconds=0, trace=True, device="cuda",
                  t_start=time.perf_counter())
    tr = out["ctx"]["trace"]
    ctx = out["ctx"]
    print(json.dumps({
        "steps": steps(tr), "window_s": tr.window_s, "busy_s": tr.busy_s,
        "device_ms_per_step": table(tr),
        "host_issue_ms": host_issue_ms_per_step(ctx),
        "host_syncs": host_syncs_per_step(ctx),
        "syncs_by_name": collections.Counter(
            e["name"] for e in _starts_inside(sync_calls(tr), named(tr, STEP))),
        "syncs_by_span": {n: len(_starts_inside(sync_calls(tr), named(tr, n)))
                          / max(1, steps(tr)) for n in table(tr)},
        "idle_after_rope_tables_ms": idle_after(tr, "s3od.encoder.rope_tables"),
        # host time inside runtime and driver calls within the steps: a
        # launch blocks where the card's queue is full
        "api_ms_by_name": {
            k: v / max(1, steps(tr)) / 1e3 for k, v in sorted(
                _api_time(tr).items(), key=lambda kv: -kv[1])[:8]},
        "idle_by_span": idle_by_span(tr)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
