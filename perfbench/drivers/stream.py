"""Driver of the batch-job cells: one closed-loop client pushes the seeded
image pool, pass after seeded pass, through
`BackgroundRemoval.remove_background_stream` (the workload's batch,
payload, upload, depth and workers) and takes every result as it comes.

Set-up ends when the first `warmup_batches` device steps have returned:
the forward at the cell's one shape has run and every kernel is built.
The window then counts the results returned within `--seconds`; at its
end the client stops feeding and the stream drains (drained results are
not counted). `serve_img_s` is the results of the window over its
length. With `--trace 1` the window runs `trace_seconds`, under the
profiler through the drain, and the encoder and the DPT head are wrapped
in host ranges.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench import core, flops, inputs, serving, trace as tracing
from perfbench.core import ROOT


def run(spec, *, seed, seconds, trace, device, t_start):
    cfg, w = spec["config"], spec["workload"]
    tr = w["traffic"]
    batch = tr["batch"]
    pred, pool = serving.build(spec, seed, device)
    core.log(f"phases: built at {time.perf_counter() - t_start:.2f} s")
    largest = int(np.argmax([im.shape[0] * im.shape[1] for im in pool]))
    sample = serving.Sample(w["check"]["sample"], seed, largest)
    warm = tr["warmup_batches"] * batch
    state = {"stop": False, "fed": []}

    def feed():
        for idx in inputs.passes(len(pool), seed):
            if state["stop"]:
                return
            state["fed"].append(idx)
            yield pool[idx]

    hooks, cap = [], None
    if trace:
        hooks = (tracing.annotate(pred, "model.encoder", "perfbench.encoder")
                 + tracing.annotate(pred, "model.seg_head", "perfbench.decoder"))
        seconds = w["trace_seconds"]
    stream = pred.remove_background_stream(
        feed(), batch=batch, payload=tr["payload"], upload=tr["upload"],
        depth=tr["depth"], pre_workers=tr["pre_workers"],
        post_workers=tr["post_workers"])
    done = in_window = 0
    deadline = None
    for res in stream:
        i = done
        done += 1
        if i < warm:
            if done == warm:
                setup_s = time.perf_counter() - t_start
                if trace:
                    cap = tracing.Capture(ROOT / "build" / "perfbench" / "trace.json")
                    cap.__enter__()
                t0 = time.perf_counter()
                deadline = t0 + seconds
            continue
        if time.perf_counter() <= deadline:
            in_window += 1
            sample.offer(state["fed"][i], res)
        else:
            state["stop"] = True
    if cap is not None:
        cap.__exit__(None, None, None)
    for h in hooks:
        h.remove()
    attempted = len(state["fed"]) - warm
    failed = attempted - (done - warm)
    dev = serving.device_block(device)
    peak = dev["memory_peak_bytes"]
    del stream, pred
    serving.release()

    t_ref = time.perf_counter()
    numbers, compared = serving.compare(spec, seed, device, pool, sample)
    core.log(f"phases: setup {setup_s:.2f} s, window {seconds} s, reference "
             f"{time.perf_counter() - t_ref:.2f} s for {compared} answers")
    canvas = tr["canvas"]
    ctx = {"trace": cap.trace if cap else None, "images": done - warm,
           "flops_per_image": flops.forward_flops(cfg, canvas, canvas),
           "attn_call": flops.attention_calls(cfg, canvas, canvas, batch)[0]}
    return {"e2e": {"serve_img_s": in_window / seconds, "setup_s": setup_s,
                    "peak_mem_gib": peak / 2**30},
            "ctx": ctx, "numbers": numbers, "attempted": attempted,
            "failed": failed, "device": dev,
            "complete": compared == len(sample.all()) and compared > 0 and failed == 0}
