"""Driver of the training cells: the port's `train_step` (its model,
AdamW and loss built once from the seed, `perfbench.program.Trainer`)
driven step after step over a seeded pool of batches already on the card:
the segmentation model on normalized (B, S, S, 3) batches, or the FluxDPT
teacher at batch 1 on one sample per FLUX bucket (uint8 images, masks,
FLUX features and concept maps), step i on pool entry i mod the pool.

Set-up runs the first `warmup_steps` steps through the same object and
call (every bucket's shape once, so nothing builds in the window); the
first three are the compared ones: their losses, the first step's
forward outputs and gradient (as its optimizer takes it) and the
parameters after the third are kept. The window then runs steps for `--seconds` with at most
two steps in flight; `train_img_s` is its images over its length, to the
last step's end. With `--trace 1` the window runs `trace_seconds` under
the profiler.

After the window the program is dropped and the plain reference runs the
three compared steps from the same seeded weights and batches.
"""

from __future__ import annotations

import collections
import json
import time

import torch

from perfbench import checks, core, flops, inputs, program, serving, trace as tracing
from perfbench.core import ROOT
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

COMPARED = 3


def rope_seed(seed: int, step: int) -> int:
    return inputs.mix(seed, 100 + step)


def batches_for(spec, seed, device):
    cfg, tr = spec["config"], spec["workload"]["traffic"]
    if cfg.get("flux_dim"):
        return inputs.teacher_samples(tr, cfg, seed, device)
    return inputs.train_batches(tr, seed, device)


def reference_batch(b: dict) -> dict:
    """A pool entry as the reference reads it: images normalized fp32."""
    x = b["images"]
    if x.dtype == torch.uint8:
        mean = torch.tensor(inputs.IMAGENET_MEAN, device=x.device)
        std = torch.tensor(inputs.IMAGENET_STD, device=x.device)
        x = (x.float() / 255.0 - mean) / std
    return {**b, "images": x}


def norms(tree) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


class FirstGradients:
    """Each parameter's gradient as the optimizer takes it at its next
    step, copied to the host: read from a global optimizer step pre-hook
    (public torch API; it leaves nothing behind once removed). A
    parameter that the step does not hold, or that has no gradient, reads
    zero."""

    def __init__(self, model: torch.nn.Module):
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        self.named = dict(model.named_parameters())
        self.grads = None
        self.handle = register_optimizer_step_pre_hook(self._keep)

    def _keep(self, optimizer, args, kwargs):
        if self.grads is not None:
            return
        held = {id(p) for g in optimizer.param_groups for p in g["params"]}
        self.grads = {n: p.grad.detach().to("cpu", copy=True)
                      for n, p in self.named.items()
                      if id(p) in held and p.grad is not None}

    def close(self) -> dict:
        """Remove the hook; {parameter name: its gradient}."""
        self.handle.remove()
        grads = self.grads or {}
        return {n: grads[n] if n in grads else torch.zeros(p.shape, dtype=p.dtype)
                for n, p in self.named.items()}


class Fence:
    """At most `depth` steps in flight on the card (no-op on the CPU)."""

    def __init__(self, device, depth: int = 2):
        self.cuda = torch.device(device).type == "cuda"
        self.depth = depth
        self.events = collections.deque()

    def before(self):
        while self.cuda and len(self.events) >= self.depth:
            self.events.popleft().synchronize()

    def after(self):
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.events.append(ev)

    def drain(self):
        if self.cuda:
            torch.cuda.synchronize()


def run(spec, *, seed, seconds, trace, device, t_start):
    cfg, w = spec["config"], spec["workload"]
    tr = w["traffic"]
    sd = inputs.state_dict(cfg, seed, device)
    model = program.build_model(cfg, sd, device)
    del sd
    trainer = program.trainer(cfg, model, w["recipe"], cfg["dtype"])
    pool = batches_for(spec, seed, device)

    def shape(i):
        x = pool[i % len(pool)]["images"]
        return x.shape[0], x.shape[1], x.shape[2]

    core.log(f"phases: built at {time.perf_counter() - t_start:.2f} s")
    losses, outputs1 = [], []
    # The first step's forward outputs, as the step computes them, and its
    # gradients, as its optimizer takes them.
    hook = trainer.model.register_forward_hook(
        lambda mod, args, out: outputs1.append(
            (out["pred_masks"].detach().to("cpu", copy=True),
             out["pred_iou"].detach().to("cpu", copy=True))))
    capture = FirstGradients(trainer.model)
    for i in range(max(COMPARED, tr["warmup_steps"])):
        out = trainer.step(pool[i % len(pool)], i, rope_seed(seed, i))
        if i < COMPARED:
            losses.append(out["loss"].item())
        if i == 0:
            hook.remove()
            g1 = program.split_qkv(capture.close())
            grads1 = {k: float(v.double().norm()) for k, v in g1.items()}
        if i == COMPARED - 1:
            after = program.split_qkv(
                {n: p.detach().to("cpu", copy=True)
                 for n, p in trainer.model.named_parameters()})
    step = max(COMPARED, tr["warmup_steps"])
    core.log(f"phases: warm at {time.perf_counter() - t_start:.2f} s")
    fence = Fence(device)
    fence.drain()
    cap = None
    if trace:
        seconds = w["trace_seconds"]
        cap = tracing.Capture(ROOT / "build" / "perfbench" / "trace.json")
    setup_s = time.perf_counter() - t_start
    if cap is not None:
        cap.__enter__()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    first = step
    while time.perf_counter() < deadline:
        fence.before()
        trainer.step(pool[step % len(pool)], step, rope_seed(seed, step))
        fence.after()
        step += 1
    fence.drain()
    window = time.perf_counter() - t0
    if cap is not None:
        cap.__exit__(None, None, None)
    steps = step - first
    images = sum(shape(i)[0] for i in range(first, step))
    dev = serving.device_block(device)
    del trainer, model, out
    serving.release()

    t_ref = time.perf_counter()
    numbers, worst = compare(spec, seed, device, pool, losses, grads1, after, g1,
                             outputs1[0])
    core.log("worst leaves: " + json.dumps(worst, default=str))
    core.log(f"phases: setup {setup_s:.2f} s, window {window:.2f} s, reference "
             f"{time.perf_counter() - t_ref:.2f} s")
    step_flops = [flops.train_step_flops(cfg, *shape(i)[1:], shape(i)[0])
                  for i in range(first, step)]
    bwd_least = [sum(flops.attention_bwd_least_s(*c)
                     for c in flops.attention_calls(cfg, shape(i)[1], shape(i)[2],
                                                    shape(i)[0]))
                 for i in range(first, step)]
    ctx = {"trace": cap.trace if cap else None, "steps": steps, "images": images,
           "flops": sum(step_flops), "attn_bwd_least_s": sum(bwd_least)}
    return {"e2e": {"train_img_s": images / window, "setup_s": setup_s,
                    "peak_mem_gib": dev["memory_peak_bytes"] / 2**30},
            "ctx": ctx, "numbers": numbers, "attempted": steps, "failed": 0,
            "device": dev, "complete": steps > 0}


def reference_steps(spec, seed, device, pool, nm=ref_model.PLAIN) -> dict:
    """The reference's three compared steps from the seeded weights."""
    cfg, w = spec["config"], spec["workload"]
    sd = inputs.state_dict(cfg, seed, device)
    with ref_model.exact_float32():
        return ref_train.train_steps(
            sd, cfg, w["recipe"], [reference_batch(pool[i % len(pool)])
                                   for i in range(COMPARED)],
            [rope_seed(seed, i) for i in range(COMPARED)], nm)


def readings(ref: dict) -> tuple:
    """(losses, first-gradient norms, change norms) of a reference run, as
    the program's are read: the control's side of the comparison."""
    return (ref["losses"], norms(ref["grads1"]),
            {k: float((ref["params"][k].double() - ref["initial"][k].double()).norm())
             for k in ref["params"]})


def compare(spec, seed, device, pool, losses, grads1, after, g1=None,
            first=None) -> dict:
    ref = reference_steps(spec, seed, device, pool)
    updates = {k: float((after[k].to(device).double() - ref["initial"][k].double()).norm())
               for k in ref["initial"] if k in after}
    return checks.training_numbers(losses, grads1, updates, ref, g1, first)
