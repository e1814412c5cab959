"""Driver of the LoRA cells: the port's LoRA fine-tuning step on its MMDiT
(`perfbench.program_lora`: `make_lora_train_step` with
`init_lora_params` and `lora_optimizer`, as `flux_finetune.run` builds
it), on seeded weights, driven step after step over a seeded pool of
cached samples already on the card; step i on pool entry i mod the pool,
its draws (t, then the noise) from a generator seeded by (seed, i).

The contract of `drivers/train.py`: set-up builds everything and runs the
first `warmup_steps` steps through the same object and call; the first
three are the compared ones (their losses; the first step's velocity, as
the model returned it, and its gradients, as the optimizer takes them;
the adapters after the third). The window runs steps for `--seconds` with
at most two in flight; `train_img_s` is its samples over its length, to
the last step's end. With `--trace 1` the window runs `trace_seconds`
under the profiler. After the window the program is dropped and the plain
reference (`reference/mmdit.py`) runs the three compared steps from the
same seeded weights, initial adapters, samples and draws. Both sides start
from the benchmark's initial adapters (`inputs_mmdit.lora_init`, the
recipe's law), copied into the port's leaves once the step is built, as a
checkpoint of adapters would be loaded: the port's own draw does not reach
the comparison.

The compared numbers (`lora_numbers`), over the adapters' leaves:
- `fwd_rel`: ||v - v_ref|| / ||v_ref - mean(v_ref)|| of the first step's
  velocity;
- `grad_diff_med`: the median leaf's ||g - g_ref|| of the first gradient,
  over its leaves whose reference gradient is at least a thousandth of
  the median nonzero leaf's (every A reads 0 there: B starts at 0);
- `update_group_med`: each leaf's gap between the norms of the program's
  and the reference's change after three steps (`checks._leaf_gaps`),
  the median in each group of adapters (the dual blocks', the single
  blocks'), the larger of the two: a group left unmoved reads about 1.
Read, not compared: `loss_rel`, `grad_rel` and `update_rel` (the worst
leaf's gaps).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Mapping

import numpy as np
import torch

from perfbench import checks, core, flops, flops_mmdit, inputs_mmdit, program_lora
from perfbench import serving, trace as tracing
from perfbench.core import ROOT
from perfbench.drivers.train import Fence
from perfbench.reference import mmdit as ref_mmdit

COMPARED = 3


class FirstGradients:
    """The leaves' gradients as the optimizer takes them at its next step,
    copied to the host (a global optimizer step pre-hook, removed at
    `close`); a leaf with no gradient reads zero."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        self.leaves, self.grads = leaves, None
        self.handle = register_optimizer_step_pre_hook(self._keep)

    def _keep(self, optimizer, args, kwargs):
        if self.grads is None:
            self.grads = {n: (p.grad.detach().to("cpu", copy=True) if p.grad is not None
                              else torch.zeros(p.shape)) for n, p in self.leaves.items()}

    def close(self) -> Dict[str, torch.Tensor]:
        self.handle.remove()
        return self.grads or {}


def host_copy(leaves: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}


def start_from(leaves: Mapping[str, torch.Tensor], init: Mapping[str, torch.Tensor]):
    """Copy the benchmark's initial adapters `init` into the program's
    leaves of the same name and shape, in place (the optimizer holds the
    leaves). A leaf of another name or shape keeps the port's value and
    fails the comparison."""
    with torch.no_grad():
        for k, v in leaves.items():
            if k in init and init[k].shape == v.shape:
                v.copy_(init[k])


def run(spec, *, seed, seconds, trace, device, t_start):
    cfg, w = spec["config"], spec["workload"]
    tr = w["traffic"]
    sd = inputs_mmdit.weights(cfg, seed, device)
    model = program_lora.build_model(cfg, sd)
    del sd
    trainer = program_lora.trainer(cfg, model, w["recipe"], seed, device)
    pool = inputs_mmdit.samples(cfg, tr, seed, device)
    core.log(f"phases: built at {time.perf_counter() - t_start:.2f} s")

    leaves = trainer.leaves()
    init = host_copy(inputs_mmdit.lora_init(cfg, seed, device))  # not held on the card
    start_from(leaves, init)
    lora0 = host_copy(leaves)
    first: List[torch.Tensor] = []
    hook = model.register_forward_hook(
        lambda mod, args, out: first.append(out["output"].detach().to("cpu", copy=True)))
    capture = FirstGradients(leaves)
    losses = []
    for i in range(max(COMPARED, tr["warmup_steps"])):
        loss = trainer.step(pool[i % len(pool)], inputs_mmdit.step_generator(seed, i, device))
        if i < COMPARED:
            losses.append(loss.item())
        if i == 0:
            hook.remove()
            grads1 = capture.close()
        if i == COMPARED - 1:
            after = host_copy(leaves)
    step = max(COMPARED, tr["warmup_steps"])
    core.log(f"phases: warm at {time.perf_counter() - t_start:.2f} s; losses {losses}")
    fence = Fence(device)
    fence.drain()
    cap = None
    if trace:
        seconds = w["trace_seconds"]
        cap = tracing.Capture(ROOT / "build" / "perfbench" / "trace.json")
    setup_s = time.perf_counter() - t_start
    counts0 = program_lora.counts()
    if cap is not None:
        cap.__enter__()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    first_step = step
    while time.perf_counter() < deadline:
        fence.before()
        trainer.step(pool[step % len(pool)], inputs_mmdit.step_generator(seed, step, device))
        fence.after()
        step += 1
    fence.drain()
    window = time.perf_counter() - t0
    if cap is not None:
        cap.__exit__(None, None, None)
    steps = step - first_step
    per_step = [None if a is None else (b - a) / max(steps, 1)
                for a, b in zip(counts0, program_lora.counts())]
    core.log(f"K7, K8 launches and merges a step: {per_step}")
    dev = serving.device_block(device)
    del trainer, model, leaves, loss
    serving.release()

    t_ref = time.perf_counter()
    numbers, worst = compare(spec, seed, device, pool, init, lora0, losses, first[0],
                             grads1, after)
    core.log("worst leaves: " + json.dumps(worst, default=str))
    core.log(f"phases: setup {setup_s:.2f} s, window {window:.2f} s, reference "
             f"{time.perf_counter() - t_ref:.2f} s")
    n_img, n_txt = flops_mmdit.tokens(cfg, tr["size"])
    calls = flops_mmdit.attention_calls(cfg, n_img, n_txt, tr["batch"])
    ctx = {"trace": cap.trace if cap else None, "steps": steps,
           "images": steps * tr["batch"],
           "flops": steps * flops_mmdit.lora_step_flops(cfg, n_img, n_txt, tr["batch"]),
           "attn_fwd_least_s": steps * sum(flops.attention_fwd_least_s(*c) for c in calls),
           "attn_bwd_least_s": steps * sum(flops.attention_bwd_least_s(*c) for c in calls)}
    return {"e2e": {"train_img_s": steps * tr["batch"] / window, "setup_s": setup_s,
                    "peak_mem_gib": dev["memory_peak_bytes"] / 2**30},
            "ctx": ctx, "numbers": numbers, "attempted": steps, "failed": 0,
            "device": dev, "complete": steps > 0}


def reference_steps(spec, seed, device, pool, lora0, nm=ref_mmdit.PLAIN) -> dict:
    """The reference's three compared steps from the seeded weights and
    the initial adapters `lora0` (the benchmark's, `inputs_mmdit.lora_init`)."""
    cfg, w = spec["config"], spec["workload"]
    sd = inputs_mmdit.weights(cfg, seed, device)
    batches = [pool[i % len(pool)] for i in range(COMPARED)]
    draws = [inputs_mmdit.draws(inputs_mmdit.step_generator(seed, i, device),
                                b["latents"]) for i, b in enumerate(batches)]
    with ref_mmdit.exact_float32():
        return ref_mmdit.lora_steps(sd, cfg, w["recipe"],
                                    {k: v.to(device) for k, v in lora0.items()},
                                    batches, draws, nm)


def group_of(name: str) -> str:
    return name.split(".", 1)[0]


def lora_numbers(cfg: dict, losses, first, grads1, after, lora0, ref) -> tuple:
    """(numbers, the three worst leaves of each gap): the program's first
    three `losses`, first velocity `first`, first gradients `grads1`,
    adapters `after` the third step and initial adapters `lora0`, all by
    leaf name, against `ref` from `reference_steps` (the module's
    numbers)."""
    inf = float("inf")
    names = ("loss_rel", "fwd_rel", "grad_rel", "grad_diff_med", "update_rel",
             "update_group_med")
    expected = {f"{a}.{leaf}" for a in inputs_mmdit.adapter_shapes(cfg) for leaf in "AB"}
    if (len(losses) != len(ref["losses"])
            or not set(grads1) == set(after) == set(lora0) == expected
            or any(lora0[k].shape != v.shape for k, v in ref["initial"].items())):
        return {k: inf for k in names}, {}
    cpu = lambda tree: {k: v.detach().to("cpu").double() for k, v in tree.items()}
    g_ref, p_ref, p0 = cpu(ref["grads1"]), cpu(ref["params"]), cpu(ref["initial"])
    gn_ref = {k: float(v.norm()) for k, v in g_ref.items()}
    med = float(np.median([v for v in gn_ref.values() if v > 0] or [0.0]))
    moving = [k for k, v in gn_ref.items() if v > 0 and v >= checks.MEDIAN_FLOOR * med]
    gn = {k: float(grads1[k].double().norm()) for k in moving}
    floor = float(np.median([gn_ref[k] for k in moving])) if moving else 0.0
    diff = [float((grads1[k].double() - g_ref[k]).norm()) / max(gn_ref[k], floor, 1e-30)
            for k in moving]
    d_ref = {k: float((p_ref[k] - p0[k]).norm()) for k in p_ref}
    d = {k: float((after[k].double() - lora0[k].double()).norm()) for k in p_ref}
    med_d = float(np.median(list(d_ref.values())))
    moved = [k for k, v in d_ref.items() if v > 0 and v >= checks.MEDIAN_FLOOR * med_d]
    g = checks._leaf_gaps(gn, gn_ref, moving)
    u = checks._leaf_gaps(d, d_ref, moved)
    groups: Dict[str, List[float]] = {}
    for gap, k in zip(u, moved):
        groups.setdefault(group_of(k), []).append(gap)
    out = {"loss_rel": max(checks._rel(a, b) for a, b in zip(losses, ref["losses"])),
           "fwd_rel": checks.forward_rel((first,), ref["first"]),
           "grad_rel": max(g), "grad_diff_med": float(np.median(diff)) if diff else inf,
           "update_rel": max(u),
           "update_group_med": max(float(np.median(v)) for v in groups.values())
           if groups else inf}
    order = lambda gaps, keys: sorted(zip(gaps, keys), reverse=True)[:3]
    return out, {"grad": order(g, moving), "grad_diff": order(diff, moving),
                 "update": order(u, moved)}


def compare(spec, seed, device, pool, init, lora0, losses, first, grads1, after) -> tuple:
    """The reference run from the benchmark's adapters `init`, against the
    program's run from its leaves `lora0` as its first step took them."""
    ref = reference_steps(spec, seed, device, pool, init)
    return lora_numbers(spec["config"], losses, first, grads1, after, lora0, ref)
