"""Optimizer and LR schedule (counterpart of `s3od_tpu/training/optim.py`).

Reference recipe: AdamW (weight decay 0.05, betas 0.9/0.999, eps 1e-8) over
two groups — the encoder at the base lr, the segmentation head at
`head_lr_mult` x — each under its own hold-then-cosine schedule evaluated
per step, an optional linear warmup, and the key-bias freeze.

What the JAX chain does, step by step, and how it is kept here:
1. `freeze_qkv_key_bias` zeroes the key segment [C, 2C) of every fused
   qkv bias gradient, so the parameter stays exactly zero (weight decay of
   zero is zero) and the reference `.pt` export stays lossless.
2. `multi_transform` gives each group its own chain, and `grad_clip` sits
   INSIDE each chain (`clip_by_global_norm` before `adamw`): each group is
   clipped by its own global norm, with optax's rule (unchanged below the
   bound, else scaled by bound / norm). One `clip_grad_norm_` over all
   parameters would compute something else.
3. optax's `adamw` and `torch.optim.AdamW` apply the same update
   (decoupled decay lr * wd * p, bias-corrected moments, eps outside the
   square root); they agree up to float32 rounding.
The schedule of step i is evaluated at optax's count i (0 for the first
update).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def hold_cosine_schedule(
    base_lr: float,
    *,
    steps_per_epoch: int,
    max_epochs: int = 200,
    hold_epochs: int = 30,
    eta_min: float = 1e-6,
    warmup_epochs: float = 0.0,
) -> Callable[[int], float]:
    """Constant for `hold_epochs`, then cosine from base_lr to eta_min, at
    (whole) epoch = step // steps_per_epoch; `warmup_epochs` prepends a
    linear 0 -> base_lr ramp per step."""

    def fn(step: int) -> float:
        epoch = math.floor(step / steps_per_epoch)
        t = min(max((epoch - hold_epochs) / max(1, max_epochs - hold_epochs),
                    0.0), 1.0)
        cos = eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t))
        lr = base_lr if epoch < hold_epochs else cos
        if warmup_epochs > 0:
            warm_steps = warmup_epochs * steps_per_epoch
            lr = lr * min(max((step + 1.0) / warm_steps, 0.0), 1.0)
        return lr

    return fn


class Optimizer:
    """Two-group AdamW with per-group schedules and per-group clipping,
    over a model with `encoder` and `seg_head` submodules.

        opt = Optimizer(model, lr=1e-5, steps_per_epoch=100)
        loss.backward(); opt.step(step)     # step = updates so far
    """

    def __init__(
        self,
        model: torch.nn.Module,
        lr: float = 1e-5,
        *,
        head_lr_mult: float = 10.0,
        weight_decay: float = 0.05,
        steps_per_epoch: int = 1000,
        max_epochs: int = 200,
        hold_epochs: int = 30,
        eta_min: float = 1e-6,
        grad_clip: Optional[float] = None,
        warmup_epochs: float = 0.0,
    ):
        self.model = model
        self.grad_clip = grad_clip
        sched = dict(steps_per_epoch=steps_per_epoch, max_epochs=max_epochs,
                     hold_epochs=hold_epochs, eta_min=eta_min,
                     warmup_epochs=warmup_epochs)
        self.schedules = [hold_cosine_schedule(lr, **sched),
                          hold_cosine_schedule(lr * head_lr_mult, **sched)]
        groups = [list(model.encoder.parameters()),
                  list(model.seg_head.parameters())]
        self.torch_optimizer = torch.optim.AdamW(
            [{"params": g} for g in groups], lr=lr, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=weight_decay)

    def lrs(self, step: int):
        """(encoder lr, head lr) of update `step`."""
        return [s(step) for s in self.schedules]

    @torch.no_grad()
    def step(self, step: int) -> None:
        """One update. A parameter without gradient (the dead last
        encoder block) gets a zero one, so it decays as in optax."""
        for group in self.torch_optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        for blk in self.model.encoder.layer:
            grad = blk.attention.qkv.bias.grad
            c = grad.shape[0] // 3
            grad[c: 2 * c] = 0
        groups = self.torch_optimizer.param_groups
        for group, lr in zip(groups, self.lrs(step)):
            group["lr"] = lr
            if self.grad_clip is not None:
                clip_by_global_norm_(group["params"], self.grad_clip)
        self.torch_optimizer.step()

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return self.torch_optimizer.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        self.torch_optimizer.load_state_dict(state)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's `clip_by_global_norm` in place over `params`' gradients:
    unchanged while the global norm is below `max_norm`, else each
    gradient g becomes (g / norm) * max_norm."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if float(norm) >= max_norm:
        for g in grads:
            g.div_(norm.to(g.dtype)).mul_(max_norm)
