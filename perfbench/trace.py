"""The device trace of a `--trace 1` run and its reduction: `torch.profiler`
(host and CUDA activities) over the measured window, its Chrome trace
read back and reduced to device busy time, kernel time by name, kernel
time launched inside named host ranges, and the breakdown the result
line carries.

Host ranges: `annotate(root, path, name)` wraps a module's forward in a
`record_function` range from forward pre- and post-hooks; a kernel
belongs to a range when the runtime or driver call that launched it
(joined by CUPTI's correlation id) lies inside the range on the same
thread. The autograd engine's own ranges
(`autograd::engine::evaluate_function: ...`) mark the backward.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import re
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from perfbench.core import BENCH

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"


def family(name: str) -> str:
    """A kernel's name without `void `, template arguments, parameters and
    namespaces."""
    base = re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0]
    return base.rsplit("::", 1)[-1].strip() or name


class Capture:
    """`with Capture(path) as cap:` profiles the block, whose host span is
    the range `perfbench.window`; the trace is written to `path`, read
    back and deleted on exit (`cap.trace`)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.trace: Optional["Trace"] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:  # host ranges of the serving pipeline's worker threads too
            extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except (AttributeError, TypeError):
            extra = {}
        self.prof = profile(activities=acts, **extra)
        self.prof.__enter__()
        self.rf = torch.autograd.profiler.record_function(WINDOW)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rf.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
            try:
                self.trace = Trace.load(self.path)
            finally:
                self.path.unlink(missing_ok=True)
        return False


def annotate(root, path: str, name: str):
    """Open a `record_function(name)` range around every forward of the
    submodule at the dotted attribute `path` of `root` (per thread);
    returns the hook handles, none where there is no such module (its
    metric then reads as absent)."""
    module = root
    for attr in path.split("."):
        module = getattr(module, attr, None)
    if not isinstance(module, torch.nn.Module):
        return []
    local = threading.local()

    def pre(mod, args):
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        stack.append(rf)

    def post(mod, args, out):
        local.stack.pop().__exit__(None, None, None)

    return [module.register_forward_pre_hook(pre),
            module.register_forward_hook(post)]


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """A Chrome trace of `torch.profiler`, in microseconds."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.launches = {e["args"]["correlation"]: e for e in xs
                         if e.get("cat") in LAUNCH_CATS
                         and "correlation" in e.get("args", {})}
        self.host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
        win = [e for e in self.host if e["name"] == WINDOW]
        if win:
            w = max(win, key=lambda e: e["dur"])
            self.t0, self.t1 = w["ts"], w["ts"] + w["dur"]
        elif self.device:
            self.t0 = min(e["ts"] for e in self.device)
            self.t1 = max(e["ts"] + e["dur"] for e in self.device)
        else:
            self.t0 = self.t1 = 0.0

    @classmethod
    def load(cls, path: Path) -> "Trace":
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            return cls(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _union((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                      for e in self.device
                      if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, patterns: Iterable[str]) -> List[dict]:
        pats = list(patterns)
        return [e for e in self.device if e.get("cat") == "kernel"
                and any(p in family(e["name"]) for p in pats)]

    def _inside(self, ranges: List[dict]) -> List[dict]:
        """Device events launched from inside one of `ranges` (same
        thread, launch call within the range)."""
        by_tid = collections.defaultdict(list)
        for r in ranges:
            by_tid[r.get("tid")].append((r["ts"], r["ts"] + r["dur"]))
        merged = {tid: _union(v) for tid, v in by_tid.items()}
        starts = {tid: [a for a, _ in v] for tid, v in merged.items()}
        out = []
        for e in self.device:
            launch = self.launches.get(e.get("args", {}).get("correlation"))
            if launch is None or launch.get("tid") not in merged:
                continue
            tid, t = launch.get("tid"), launch["ts"]
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t <= merged[tid][i][1]:
                out.append(e)
        return out

    def ranges(self, prefix: str) -> List[dict]:
        return [e for e in self.host if e["name"].startswith(prefix)]

    def launched_in(self, prefix: str) -> List[dict]:
        """Device events launched inside host ranges named `prefix`..."""
        return self._inside(self.ranges(prefix))

    @staticmethod
    def seconds(events: Iterable[dict]) -> float:
        return sum(e["dur"] for e in events) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for e in self.device:
            tot[family(e["name"])[:80]] += e["dur"] / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Device idle time inside the window, by the innermost (shortest)
        host range open at each gap's middle, on any thread."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if prev < self.t1:
            gaps.append((prev, self.t1))
        host = sorted((e for e in self.host if e["name"] != WINDOW),
                      key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        tot: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for e in host[max(0, i - 400): i]:
                if e["ts"] <= mid <= e["ts"] + e["dur"]:
                    if best is None or e["dur"] < best["dur"]:
                        best = e
            name = best["name"][:80] if best else "no host range open"
            tot[name] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


# --- what the per-layer readers share ----------------------------------------

def traced(ctx: dict) -> Optional[Trace]:
    """The run's trace, where it holds a window and device work."""
    tr = ctx.get("trace")
    return tr if tr is not None and tr.window_s > 0 and tr.device else None


def kernel_map(function: str) -> List[str]:
    """The kernel names that compute `function` (`kernels/<function>.json`)."""
    with open(BENCH / "kernels" / f"{function}.json") as f:
        return json.load(f)["kernels"]


def ranged_device_ms(ctx: dict, range_name: str) -> Optional[float]:
    """Device time launched inside the host ranges `range_name`, per image
    (ms); None where no such range launched anything."""
    tr = traced(ctx)
    if tr is None or not ctx.get("images"):
        return None
    evs = tr.launched_in(range_name)
    if not evs:
        return None
    return 1e3 * tr.seconds(evs) / ctx["images"]
