#!/usr/bin/env python3
"""Runs one benchmark cell once on the card and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: `perfbench/workloads/<cell>.json`
(its configuration, traffic, driver, compared sample and limits), the
configuration's file named in `BENCHMARK.json`, the driver
`perfbench/drivers/<driver>.py`, and for `--trace 1` each per-layer
metric's reader `perfbench/metrics/<metric>.py`, or where there is none
the reader of its stem (`metrics/mfu.py` for `mfu.train`). A run builds
everything from `--seed`, warms up (set-up), measures for `--seconds`,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output; the compared numbers with
their limits are the last lines on standard error and the line's last
key.

It refuses to run (exit 2, no result) without as many CUDA cards as the
cell asks for, and fails (exit 3, no result) if JAX or the JAX package
was loaded. Build and compile caches live in the checkout's `build/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Fixed cache paths inside the checkout; nothing the program imports may
# pull in JAX.
os.environ["S3OD_TORCH_BUILD_DIR"] = str(ROOT / "build" / "s3od_torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["USE_TF"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = None) -> dict:
    """Drive the cell and assemble its result line (a dict, `checks` last).
    `t_start`: the process's start on the `time.perf_counter` clock (set-up
    is timed from it)."""
    import time

    from perfbench import core

    if t_start is None:
        t_start = time.perf_counter()

    drv = core.load_module(core.BENCH / "drivers" / f"{spec['workload']['driver']}.py",
                           f"perfbench_driver_{spec['workload']['driver']}")
    out = drv.run(spec, seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=t_start)
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            value = core.metric_reader(m["name"]).read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = spec["workload"]["check"]["limits"]
    numbers = out["numbers"]
    core.log("readings: " + json.dumps(numbers))
    from perfbench.checks import judge

    correct = bool(out["complete"]) and judge(numbers, limits)
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace and out["ctx"].get("trace") is not None:
        tr = out["ctx"]["trace"]
        line["device"]["busy_s"] = tr.busy_s
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {k: {"value": numbers.get(k), "limit": v}
                      for k, v in limits.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import core

    t_start = time.perf_counter() - core.process_age_s()
    import torch

    spec = core.cell(args.workload)
    core.log(f"phases: torch imported at {time.perf_counter() - t_start:.2f} s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        core.log(f"needs {spec['chips']} CUDA card(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    for line in core.describe_host():
        core.log(line)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = core.forbidden_loaded()
    if bad:
        core.log(f"loaded modules that must not be: {', '.join(bad)}")
        return 3
    for k, v in result["checks"].items():
        core.log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
