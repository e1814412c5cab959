"""Driver of the one-at-a-time cells: one closed-loop client sends the
seeded image pool, pass after seeded pass, through
`BackgroundRemoval.remove_background` (the workload's canvas and payload),
each request after the previous one returned.

Set-up ends after `warmup` requests (the forward at the cell's one shape
has run and every kernel is built). The window holds every request sent
within `--seconds`; `latency_p95_ms` is the 95th percentile of their
latencies, call to returned `RemovalResult`, over all of them. With
`--trace 1` the window runs `trace_seconds` under the profiler, with the
encoder and the DPT head wrapped in host ranges.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import core, flops, inputs, serving, trace as tracing
from perfbench.core import ROOT


def run(spec, *, seed, seconds, trace, device, t_start):
    cfg, w = spec["config"], spec["workload"]
    tr = w["traffic"]
    pred, pool = serving.build(spec, seed, device)
    core.log(f"phases: built at {time.perf_counter() - t_start:.2f} s")
    largest = int(np.argmax([im.shape[0] * im.shape[1] for im in pool]))
    sample = serving.Sample(w["check"]["sample"], seed, largest)
    requests = inputs.passes(len(pool), seed)
    for _ in range(tr["warmup"]):
        pred.remove_background(pool[next(requests)], payload=tr["payload"])
    hooks, cap = [], None
    if trace:
        hooks = (tracing.annotate(pred, "model.encoder", "perfbench.encoder")
                 + tracing.annotate(pred, "model.seg_head", "perfbench.decoder"))
        seconds = w["trace_seconds"]
        cap = tracing.Capture(ROOT / "build" / "perfbench" / "trace.json")
    setup_s = time.perf_counter() - t_start
    if cap is not None:
        cap.__enter__()
    deadline = time.perf_counter() + seconds
    lat = []
    while time.perf_counter() < deadline:
        idx = next(requests)
        a = time.perf_counter()
        res = pred.remove_background(pool[idx], payload=tr["payload"])
        lat.append(time.perf_counter() - a)
        sample.offer(idx, res)
    if cap is not None:
        cap.__exit__(None, None, None)
    for h in hooks:
        h.remove()
    dev = serving.device_block(device)
    del pred, res
    serving.release()

    t_ref = time.perf_counter()
    numbers, compared = serving.compare(spec, seed, device, pool, sample)
    core.log(f"phases: setup {setup_s:.2f} s, window {seconds} s, reference "
             f"{time.perf_counter() - t_ref:.2f} s for {compared} answers")
    canvas = tr["canvas"]
    ctx = {"trace": cap.trace if cap else None, "images": len(lat),
           "flops_per_image": flops.forward_flops(cfg, canvas, canvas),
           "attn_call": flops.attention_calls(cfg, canvas, canvas, 1)[0]}
    return {"e2e": {"latency_p95_ms": 1e3 * core.percentile(lat, 95),
                    "setup_s": setup_s,
                    "peak_mem_gib": dev["memory_peak_bytes"] / 2**30},
            "ctx": ctx, "numbers": numbers, "attempted": len(lat), "failed": 0,
            "device": dev,
            "complete": compared == len(sample.all()) and compared > 0}
