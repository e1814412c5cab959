"""Optimizer and LR schedule (counterpart of `s3od_tpu/training/optim.py`).

Reference recipe: AdamW (weight decay 0.05, betas 0.9/0.999, eps 1e-8) over
two groups — the encoder at the base lr, the segmentation head (and the
FLUX teacher's fusion levels) at `head_lr_mult` x — each under its own
hold-then-cosine schedule evaluated per step, an optional linear warmup,
and the key-bias freeze.

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

Under FSDP2 the parameters and gradients are DTensors sharded along rows:
the freeze zeroes the key rows that fall in this rank's shard, the clip
reduces the shards' squares over the ranks before it reads the norm, and
`load_state_dict` shards whole moments as their parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from s3od_torch.parallel.mesh import (
    distribute_like,
    is_dtensor,
    local_rows,
    shard_groups,
)


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
    over a model with an `encoder` submodule: the encoder at `lr`, the
    rest (the segmentation head; the teacher's head and fusion levels) at
    `lr * head_lr_mult`.

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
        # The encoder, then every other parameter (the JAX "head" subtree:
        # the DPT head, and the FLUX teacher's fusion levels too).
        groups = [list(model.encoder.parameters()),
                  [p for n, p in model.named_parameters()
                   if not n.startswith("encoder.")]]
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
            zero_rows_(grad, c, 2 * c)
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
        """A state as `state_dict` gave it, or whole (gathered, or saved
        at another world size): the moments of sharded parameters are
        sharded as the parameters are, from this rank's copy."""
        params = [p for g in self.torch_optimizer.param_groups
                  for p in g["params"]]
        per_param = {}
        for i, st in state["state"].items():
            p = params[int(i)]
            per_param[i] = {k: (distribute_like(v, p) if torch.is_tensor(v)
                                and v.shape == p.shape and v.dim() else v)
                            for k, v in st.items()}
        self.torch_optimizer.load_state_dict({**state, "state": per_param})


@torch.no_grad()
def zero_rows_(grad: torch.Tensor, start: int, stop: int) -> None:
    """Zero rows [start, stop) of a gradient; of a DTensor sharded along
    rows (FSDP2), the part of them in this rank's shard."""
    local, offset = local_rows(grad)
    a = max(start - offset, 0)
    b = min(stop - offset, local.shape[0])
    if b > a:
        local[a: b] = 0


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's `clip_by_global_norm` in place over `params`' gradients:
    unchanged while the global norm is below `max_norm`, else each
    gradient g becomes (g / norm) * max_norm. Sharded gradients (FSDP2
    DTensors) add their shards' squares over the ranks first."""
    grads = [p.grad for p in params]
    sq = torch.zeros((), device=grads[0].device, dtype=torch.float32)
    sharded = torch.zeros_like(sq)
    groups = []
    for g in grads:
        local, _ = local_rows(g)
        part = (local.float() ** 2).sum()
        if is_dtensor(g):
            sharded = sharded + part
            groups = groups or shard_groups(g)
        else:
            sq = sq + part
    for group in groups:
        torch.distributed.all_reduce(sharded, group=group)
    norm = torch.sqrt(sq + sharded)
    if float(norm) >= max_norm:
        for g in grads:
            local, _ = local_rows(g)
            local.div_(norm.to(local.dtype)).mul_(max_norm)
