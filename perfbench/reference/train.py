"""Plain reference of the training step: forward in training mode (the
decoder's BatchNorms on the batch's statistics), the `focal_iou` loss,
the backward by autograd, and AdamW over two parameter groups (the
encoder at lr, everything else at lr x head_lr_mult, decoupled weight
decay, betas 0.9 / 0.999, eps 1e-8). Float32; imports nothing of the
program.

The loss, from the recipe: of the n mask logits, sigmoid probabilities
p; each mask's squared IoU with the target (inter / (sum t^2 + sum p^2 -
inter), smoothed by 1e-6, no gradient) picks the best mask; focal loss
(alpha 0.25, gamma 2, its BCE-with-logits applied to p, as the recipe's
components all take the sigmoid) x 20 and IoU loss x 1, each as the best
mask's mean plus 0.1 exp(-0.2 epoch) x the mean over all masks; plus
0.05 x the MSE of the sigmoid IoU scores against the squared IoUs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perfbench.reference import model as ref_model


def _flat(x):
    return x.reshape(x.shape[0], -1)


def _bce_logits(x, t):
    return x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))


def focal_iou_loss(mask_logits, iou_logits, target, epoch: float = 0.0):
    """(total loss, parts) with the recipe's part names: `focal_loss_best`,
    `focal_loss_full`, `iou_loss_best`, `iou_loss_full`, `mse_ious_loss`,
    `best_iou`."""
    b, n = mask_logits.shape[:2]
    p = torch.sigmoid(mask_logits)
    t = target[:, None].expand_as(p)
    with torch.no_grad():
        pf, tf = p.reshape(b, n, -1), t.reshape(b, n, -1)
        inter = (pf * tf).sum(2)
        sq_iou = (inter + 1e-6) / ((tf * tf).sum(2) + (pf * pf).sum(2) - inter + 1e-6)
        best = sq_iou.argmax(1)
    decay = 0.1 * math.exp(-0.2 * epoch)
    pf, tf = p.reshape(b * n, -1), t.reshape(b * n, -1)
    bce = _bce_logits(pf, tf)
    focal = (0.25 * (1 - torch.exp(-bce)) ** 2 * bce).mean(1).reshape(b, n)
    inter = (pf * tf).sum(1)
    iou = (1 - (inter + 1e-6) / (pf.sum(1) + tf.sum(1) - inter + 1e-6)).reshape(b, n)
    total, parts = 0.0, {"best_iou": sq_iou.max(1).values.mean()}
    for name, w, per in (("focal_loss", 20.0, focal), ("iou_loss", 1.0, iou)):
        chosen = per.gather(1, best[:, None]).mean()
        total = total + w * (chosen + per.mean() * decay)
        parts[f"{name}_best"], parts[f"{name}_full"] = chosen, per.mean()
    mse = ((torch.sigmoid(iou_logits) - sq_iou) ** 2).mean(1).mean()
    parts["mse_ious_loss"] = mse
    return total + 0.05 * mse, parts


class AdamW:
    """torch's AdamW written out, over named float32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float],
                 weight_decay: float):
        self.p, self.lrs, self.wd = params, lrs, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for k, p in self.p.items():
            g = grads.get(k)
            if g is None:
                g = torch.zeros_like(p)
            lr = self.lrs[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * mh / (vh.sqrt() + eps))


def is_parameter(name: str) -> bool:
    """State-dict entries that are trained (the BatchNorms' running
    statistics are not)."""
    return not any(name.endswith(s) for s in
                   ("running_mean", "running_var", "num_batches_tracked"))


def group_of(name: str) -> str:
    """A leaf's optimizer group: "encoder" at lr, "head" (every other
    leaf) at lr x head_lr_mult."""
    return "encoder" if name.startswith("encoder.") else "head"


def rope_scale(seed: int, rescale: Optional[float]) -> Optional[float]:
    """The step's RoPE coordinate scale: exp(U(-ln r, ln r)), drawn in
    float32 from a CPU `torch.Generator` seeded with `seed`."""
    if not rescale:
        return None
    g = torch.Generator().manual_seed(seed)
    lr = math.log(rescale)
    u = torch.empty((), dtype=torch.float32).uniform_(-lr, lr, generator=g)
    return float(torch.exp(u))


def train_steps(sd: Dict[str, torch.Tensor], cfg: dict, recipe: dict,
                batches: List[dict], rope_seeds: List[int],
                nm: ref_model.Numerics = ref_model.PLAIN) -> dict:
    """`len(batches)` steps from `sd`. Batches: {"images" normalized fp32
    (B, H, W, 3), "masks" (B, H, W)} and, for the teacher,
    "transformer_features" and "concept_maps". Returns {"losses": [...],
    "first": the first step's (mask logits, IoU logits), "grads1": {leaf: first step's gradient}, "params": {leaf: after the last step}, "initial": {leaf: at
    the start}}."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in sd.items() if is_parameter(k)}
    initial = {k: v.detach().clone() for k, v in params.items()}
    buffers = {k: v for k, v in sd.items() if not is_parameter(k)}
    group_lr = {"encoder": recipe["lr"], "head": recipe["lr"] * recipe["head_lr_mult"]}
    lrs = {k: group_lr[group_of(k)] for k in params}
    opt = AdamW(params, lrs, recipe["weight_decay"])
    teacher = bool(cfg.get("flux_dim"))
    losses, grads1 = [], None
    for i, batch in enumerate(batches):
        full = {**params, **buffers}
        if teacher:
            logits, iou = ref_model.teacher(
                batch["images"], batch["transformer_features"],
                batch["concept_maps"], full, cfg, training=True, nm=nm,
                remat=True)
        else:
            logits, iou = ref_model.segmentation(
                batch["images"], full, cfg, training=True, nm=nm,
                rope_scale=rope_scale(rope_seeds[i], cfg.get("pos_embed_rescale")),
                remat=True)
        loss, _ = focal_iou_loss(logits, iou, batch["masks"])
        if i == 0:
            first = (logits.detach().clone(), iou.detach().clone())
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = dict(zip(params, grads))
        if i == 0:
            grads1 = {k: (g.detach().clone() if g is not None else torch.zeros_like(params[k]))
                      for k, g in grads.items()}
        losses.append(loss.item())
        del logits, iou, loss
        opt.step(grads)
    return {"losses": losses, "grads1": grads1, "first": first,
            "params": {k: v.detach() for k, v in params.items()},
            "initial": initial}
