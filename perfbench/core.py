"""Shared pieces of the harness: finding a cell's files by name, the
percentile, the process's age, the description of the host and card, and
the guard against JAX."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "s3od_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file (metric readers' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """The cell's workload file, with its configuration and the metrics
    `BENCHMARK.json` asks of it: {"name", "workload", "config",
    "end_to_end": [...], "per_layer": [...]}."""
    bench = load_json(ROOT / "BENCHMARK.json")
    path = BENCH / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no workload file {path.relative_to(ROOT)}")
    work = load_json(path)
    # A cell that BENCHMARK.json does not list yet runs from its workload
    # file's configuration (`configs/<name>.json` where that is not listed
    # either) and chips, with the metrics every cell reports.
    entry = next((w for w in bench["workloads"] if w["name"] == name), work)
    cfg_entry = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                     {"file": f"perfbench/configs/{entry['config']}.json"})
    cfg = load_json(ROOT / cfg_entry["file"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "workload": work, "config": cfg, "chips": entry["chips"],
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def metric_reader(name: str):
    """The reader of per-layer metric `name`: `metrics/<name>.py` where it
    exists, else the one of its stem, the part before the first dot
    (`mfu.serve` and `mfu.train` are both read by `metrics/mfu.py`)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.', 1)[0]}.py"
    return load_module(path, "perfbench_metric_" + path.stem.replace(".", "_"))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile of all values, linear between order statistics
    (numpy's default rule)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat against /proc/uptime); 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def describe_host() -> List[str]:
    """The host's CPU model, then the card's name and power limit as
    `nvidia-smi` gives them (where it runs)."""
    lines = []
    import platform

    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((l.split(":", 1)[1].strip() for l in f
                          if l.lower().startswith(("model name", "cpu model"))), model)
    except OSError:
        pass
    lines.append(f"host cpu: {model}, {os.cpu_count()} cores")
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
        lines.append(f"card: {out}")
    except (OSError, subprocess.SubprocessError):
        pass
    return lines


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
