#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process on the card:

- the program's readings of the compared numbers over many seeds (each a
  whole run of the cell's driver, with a short window): the lower reading
  is their largest;
- the control's readings on a few seeds: the plain reference computed with
  float8 e4m3 products (`Numerics(fp8=True)`), the step below the bfloat16
  the configurations state, put in the program's place and compared with
  the float32 reference exactly as the program is;
- with `--faults`, the readings of the faults a training cell can have
  that need a run: half of the batch left out (the loss's mean over the
  other half), planted in the reference in the program's place. A state
  left unchanged reads about 1 on `update_group_med` by its measure and
  needs no run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 7,8,9 [--faults] [--seconds 3] [--out <file.jsonl>]

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

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from perfbench import checks, core, inputs, serving  # noqa: E402
from perfbench.reference import model as ref_model  # noqa: E402
from perfbench.reference import serve as ref_serve  # noqa: E402


class Answer:
    """A reference's answer in the shape of the API's `RemovalResult`."""

    def __init__(self, image, masks, ious, payload):
        choice = int(np.argmax(ious))
        self.all_ious = ious
        self.all_masks = masks if payload == "full" else masks[choice: choice + 1]
        self.predicted_mask = masks[choice]
        alpha = (masks[choice] * 255).astype(np.uint8)
        self.rgba_image = Image.fromarray(np.dstack([image, alpha]), mode="RGBA")


def serving_control(spec, seed, device, nm):
    """The control's numbers over a seeded sample of the pool's
    requests (as many as a run compares, the largest image among them)."""
    w, cfg = spec["workload"], spec["config"]
    tr = w["traffic"]
    pool = inputs.image_pool(tr, seed, device)
    largest = int(np.argmax([im.shape[0] * im.shape[1] for im in pool]))
    rng = np.random.default_rng(inputs.mix(seed, 10))
    idxs = [largest] + [int(i) for i in rng.choice(
        [i for i in range(len(pool)) if i != largest], w["check"]["sample"],
        replace=False)]
    sd = inputs.state_dict(cfg, seed, device)
    chunk = w["check"].get("chunk_elems", 1 << 28)
    rows = []
    with ref_model.exact_float32():
        for i in idxs:
            ref = ref_serve.request(pool[i], sd, cfg, tr["canvas"], device,
                                    ref_model.PLAIN, chunk)
            ctl = ref_serve.request(pool[i], sd, cfg, tr["canvas"], device, nm, chunk)
            ans = Answer(pool[i], ctl["masks"].cpu().numpy(),
                         ctl["ious"].cpu().numpy(), tr["payload"])
            rows.append(checks.serving_numbers(ans, pool[i], ref, tr["payload"]))
    return checks.serving_summary(rows)


def training_control(spec, seed, device, nm, half=False):
    """The control's (or, `half`, the half-batch fault's) numbers against
    the float32 reference over the three compared steps."""
    drv = core.load_module(core.BENCH / "drivers" / "train.py", "perfbench_driver_train")
    pool = drv.batches_for(spec, seed, device)
    ref = drv.reference_steps(spec, seed, device, pool)
    if half:
        b = pool[0]["images"].shape[0] // 2
        pool = [{k: v[:b] for k, v in p.items()} for p in pool]
    other = drv.reference_steps(spec, seed, device, pool, nm)
    return checks.training_numbers(*drv.readings(other), ref, other["grads1"],
                                   other["first"])[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    spec = core.cell(args.workload)
    drv_name = spec["workload"]["driver"]
    drv = core.load_module(core.BENCH / "drivers" / f"{drv_name}.py",
                           f"perfbench_driver_{drv_name}")
    serving_cell = drv_name != "train"

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.perf_counter()
        out = drv.run(spec, seed=s, seconds=args.seconds, trace=False,
                      device="cuda", t_start=time.perf_counter())
        emit({"cell": args.workload, "kind": "program", "seed": s,
              "numbers": out["numbers"], "e2e": out["e2e"],
              "s": time.perf_counter() - t})
        serving.release()
    fp8 = ref_model.Numerics(fp8=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        nums = (serving_control(spec, s, "cuda", fp8) if serving_cell
                else training_control(spec, s, "cuda", fp8))
        emit({"cell": args.workload, "kind": "control_fp8", "seed": s,
              "numbers": nums, "s": time.perf_counter() - t})
        if args.faults and not serving_cell:
            nums = training_control(spec, s, "cuda", ref_model.PLAIN, half=True)
            emit({"cell": args.workload, "kind": "fault_half_batch", "seed": s,
                  "numbers": nums})
        serving.release()
    bad = core.forbidden_loaded()
    if bad:
        print(f"loaded modules that must not be: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
