#!/usr/bin/env python3
"""Readings that the LoRA cell's limits are set from, beside the program's
own (`calibrate.py --seeds`, which runs any cell's driver), in one process
on the card:

- the control's readings: the plain reference computed with float8 e4m3
  products (`Numerics(fp8=True)`), the step below the bfloat16 the
  configuration states, put in the program's place and compared with the
  float32 reference exactly as the program is, from the initial adapters
  that the driver's runs start from (`inputs_mmdit.lora_init`);
- the planted fault's: whole runs of the driver with the port's
  single-stream blocks run without their adapters once the step is built
  (`program_lora.single_adapters_dropped`), a short window each.

    python3 perfbench/calibrate_lora.py --workload flux1dev-lora-1024-b1 \
        --control-seeds 7,8,9 --fault-seeds 5 [--seconds 3] [--out <file.jsonl>]

Each reading is one JSON line (on standard output, and appended to
`--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["S3OD_TORCH_BUILD_DIR"] = str(ROOT / "build" / "s3od_torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import core, inputs_mmdit, program_lora, serving  # noqa: E402
from perfbench.reference import mmdit as ref_mmdit  # noqa: E402


def control(spec, drv, seed: int, device, nm) -> dict:
    """The numbers of the reference under `nm` against the float32
    reference over the three compared steps."""
    cfg = spec["config"]
    pool = inputs_mmdit.samples(cfg, spec["workload"]["traffic"], seed, device)
    lora0 = {k: v.cpu() for k, v in inputs_mmdit.lora_init(cfg, seed, device).items()}
    ref = drv.reference_steps(spec, seed, device, pool, lora0)
    other = drv.reference_steps(spec, seed, device, pool, lora0, nm)
    cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}
    return drv.lora_numbers(cfg, other["losses"], other["first"][0].cpu(),
                            cpu(other["grads1"]), cpu(other["params"]), lora0, ref)[0]


def fault_run(spec, drv, seed: int, seconds: float, device) -> dict:
    """A whole run of the driver with the single blocks' adapters dropped
    after the build."""
    with program_lora.single_adapters_dropped():
        return drv.run(spec, seed=seed, seconds=seconds, trace=False, device=device,
                       t_start=time.perf_counter())["numbers"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    spec = core.cell(args.workload)
    name = spec["workload"]["driver"]
    drv = core.load_module(core.BENCH / "drivers" / f"{name}.py", f"perfbench_driver_{name}")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    seeds = lambda s: [int(x) for x in s.split(",") if x]
    fp8 = ref_mmdit.Numerics(fp8=True)
    for s in seeds(args.control_seeds):
        t = time.perf_counter()
        emit({"cell": args.workload, "kind": "control_fp8", "seed": s,
              "numbers": control(spec, drv, s, "cuda", fp8), "s": time.perf_counter() - t})
        serving.release()
    for s in seeds(args.fault_seeds):
        t = time.perf_counter()
        emit({"cell": args.workload, "kind": "fault_single_adapters_dropped", "seed": s,
              "numbers": fault_run(spec, drv, s, args.seconds, "cuda"),
              "s": time.perf_counter() - t})
        serving.release()
    bad = core.forbidden_loaded()
    if bad:
        print(f"loaded modules that must not be: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
