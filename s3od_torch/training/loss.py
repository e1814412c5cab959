"""Config-driven segmentation loss (counterpart of
`s3od_tpu/training/loss.py`, same names and presets).

- per-component weighted losses over (pred, target), optionally on the
  sigmoid of the logits;
- multi-mask "best-of-N": squared-IoU mask selection without gradient,
  loss = best-mask loss + mean over all masks * full_mask_lambda *
  exp(-decay_rate * epoch);
- aux components on the IoU head (MSE, optionally the pairwise rank loss)
  against the detached squared IoUs.

Every elementwise loss takes (pred, target) of shape (B, ...) and returns
per-sample losses (B,); the handler reduces them.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _flatten(x):
    return x.reshape(x.shape[0], -1)


def iou_loss(pred, target, smooth: float = 1e-6):
    p, t = _flatten(pred), _flatten(target)
    inter = (p * t).sum(1)
    union = p.sum(1) + t.sum(1) - inter
    return 1.0 - (inter + smooth) / (union + smooth)


def dice_loss(pred, target, smooth: float = 1e-6):
    p, t = _flatten(pred), _flatten(target)
    inter = (p * t).sum(1)
    dice = (2.0 * inter + smooth) / (p.sum(1) + t.sum(1) + smooth)
    return 1.0 - dice


def sigmoid_bce(logits, labels):
    """Numerically stable BCE-with-logits, elementwise (optax's formula)."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def focal_loss(pred_logits, target, alpha: float = 0.25, gamma: float = 2.0):
    bce = sigmoid_bce(pred_logits, target)
    pt = torch.exp(-bce)
    return _flatten(alpha * (1.0 - pt) ** gamma * bce).mean(1)


def bce_loss(pred_probs, target, eps: float = 1e-7):
    """BCE on probabilities (the reference's nn.BCELoss after sigmoid)."""
    p = pred_probs.clamp(eps, 1.0 - eps)
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return _flatten(bce).mean(1)


def mse_loss(pred, target):
    return _flatten((pred - target) ** 2).mean(1)


def rank_ious_loss(pred_scores, gt):
    """Pairwise logistic ranking loss over per-image mask scores (B, N):
    softplus(s_j - s_i) weighted by the gt gap for every gt_i > gt_j."""
    ds = pred_scores[:, :, None] - pred_scores[:, None, :]
    dg = gt[:, :, None] - gt[:, None, :]
    pair = dg.clamp_min(0.0) * F.softplus(-ds)
    n = pred_scores.shape[1]
    return pair.sum((1, 2)) * (2.0 / (n * (n - 1)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_loss(pred, target, window_size: int = 11):
    """1 - SSIM with an 11x11 Gaussian window; inputs (B, H, W)."""
    w = torch.from_numpy(_gaussian_window(window_size)).to(pred)[None, None]
    pad = window_size // 2

    def f(x):
        return F.conv2d(x[:, None], w, padding=pad)[:, 0]

    mu1, mu2 = f(pred), f(target)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = f(pred * pred) - mu1_sq
    s2 = f(target * target) - mu2_sq
    s12 = f(pred * target) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim = (((2 * mu12 + c1) * (2 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return 1.0 - _flatten(ssim).mean(1)


LOSS_FNS: Dict[str, Callable] = {
    "focal": focal_loss,
    "iou": iou_loss,
    "dice": dice_loss,
    "bce": bce_loss,
    "ssim": ssim_loss,
    "mse": mse_loss,
    "rank": rank_ious_loss,
}


@dataclasses.dataclass(frozen=True)
class LossComponent:
    name: str
    weight: float
    target_key: str
    output_key: str
    kind: str  # key into LOSS_FNS
    add_sigmoid: bool = True
    kwargs: tuple = ()

    @classmethod
    def from_dict(cls, conf: Dict[str, Any]) -> "LossComponent":
        return cls(
            name=conf["name"],
            weight=float(conf["weight"]),
            target_key=conf["target_key"],
            output_key=conf["output_key"],
            kind=conf["kind"],
            add_sigmoid=bool(conf.get("add_sigmoid", True)),
            kwargs=tuple(sorted(conf.get("kwargs", {}).items())),
        )

    def __call__(self, pred, target):
        return LOSS_FNS[self.kind](pred, target, **dict(self.kwargs))


# The reference's `LossComponent.from_dict` never reads add_sigmoid, so
# every component gets add_sigmoid=True — focal included, whose
# BCE-with-logits therefore runs on probabilities. Reproduced as the JAX
# package reproduces it (the published checkpoints were trained this way).
FOCAL_IOU = dict(
    criterions=[
        dict(name="focal_loss", target_key="masks", output_key="pred_masks",
             weight=20, kind="focal"),
        dict(name="iou_loss", target_key="masks", output_key="pred_masks",
             weight=1.0, kind="iou"),
        dict(name="mse_ious_loss", target_key="gt_ious", output_key="pred_iou",
             weight=0.05, kind="mse"),
    ],
    full_mask_lambda=0.1,
    decay_rate=0.2,
)

BCE_IOU_SSIM = dict(
    criterions=[
        dict(name="bce_loss", target_key="masks", output_key="pred_masks",
             weight=30, kind="bce"),
        dict(name="iou_loss", target_key="masks", output_key="pred_masks",
             weight=0.5, kind="iou"),
        dict(name="ssim_loss", target_key="masks", output_key="pred_masks",
             weight=10, kind="ssim"),
        dict(name="mse_ious_loss", target_key="gt_ious", output_key="pred_iou",
             weight=0.05, kind="mse"),
    ],
    full_mask_lambda=0.1,
    decay_rate=0.2,
)

FOCAL_IOU_RANK = dict(
    criterions=[
        *[dict(c) for c in FOCAL_IOU["criterions"]],
        dict(name="rank_ious_loss", target_key="gt_ious",
             output_key="pred_iou", weight=1.0, kind="rank",
             add_sigmoid=False),
    ],
    full_mask_lambda=0.1,
    decay_rate=0.2,
)

LOSS_PRESETS = {
    "focal_iou": FOCAL_IOU,
    "bce_iou_ssim": BCE_IOU_SSIM,
    "focal_iou_rank": FOCAL_IOU_RANK,
}


def compose_loss_config(loss_cfg) -> Dict:
    """The loss config group -> a LossModule config: the preset's
    criteria, then `criterions=[...]`, `full_mask_lambda=`, `decay_rate=`,
    `rank_weight=` and `weights.<name>=` overrides
    (`s3od_tpu/training/train.py:_compose_loss_config`)."""
    composed = copy.deepcopy(LOSS_PRESETS[loss_cfg["preset"]])
    if "criterions" in loss_cfg:
        composed["criterions"] = copy.deepcopy(loss_cfg["criterions"])
    for key in ("full_mask_lambda", "decay_rate"):
        if key in loss_cfg:
            composed[key] = float(loss_cfg[key])
    if "rank_weight" in loss_cfg:
        composed["criterions"].append(dict(
            name="rank_ious_loss", target_key="gt_ious",
            output_key="pred_iou", weight=float(loss_cfg["rank_weight"]),
            kind="rank", add_sigmoid=False,
        ))
    weights = loss_cfg.get("weights") or {}
    unknown = set(weights) - {c["name"] for c in composed["criterions"]}
    if unknown:
        raise ValueError(f"loss.weights for unknown criterions: {sorted(unknown)}")
    for crit in composed["criterions"]:
        if crit["name"] in weights:
            crit["weight"] = float(weights[crit["name"]])
    return composed


def _squared_iou(pred, target, smooth: float = 1e-6):
    """IoU with a squared-norm union, for best-mask selection.
    pred/target (B, N, H, W) -> (B, N)."""
    p = pred.reshape(*pred.shape[:2], -1)
    t = target.reshape(*target.shape[:2], -1)
    inter = (t * p).sum(2)
    union = (t * t).sum(2) + (p * p).sum(2) - inter
    return (inter + smooth) / (union + smooth)


class LossModule:
    """Callable: (outputs, batch, epoch) -> (scalar loss, dict of parts)."""

    def __init__(self, config: Dict[str, Any]):
        self.components = [LossComponent.from_dict(c) for c in config["criterions"]]
        self.mask_components = [
            c for c in self.components
            if c.target_key == "masks" and c.output_key == "pred_masks"
        ]
        self.aux_components = [
            c for c in self.components
            if not (c.target_key == "masks" and c.output_key == "pred_masks")
        ]
        self.full_mask_lambda = float(config.get("full_mask_lambda", 0.01))
        self.decay_rate = float(config.get("decay_rate", 0.2))

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor],
                 epoch: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred_masks = outputs["pred_masks"]  # (B, N, H, W) logits
        target = batch["masks"]  # (B, H, W)
        b, n = pred_masks.shape[:2]
        if n == 1:
            return self._single(outputs, batch)

        target_e = target[:, None].expand(pred_masks.shape)
        pred_sig = torch.sigmoid(pred_masks)
        ious = _squared_iou(pred_sig, target_e).detach()  # (B, N)
        best_idx = ious.argmax(1)
        decay = self.full_mask_lambda * math.exp(-self.decay_rate * float(epoch))

        total = pred_masks.new_zeros((), dtype=torch.float32)
        parts: Dict[str, torch.Tensor] = {"best_iou": ious.max(1).values.mean()}

        def per_mask(component, pred_bn):
            flat_p = pred_bn.reshape(b * n, *pred_bn.shape[2:])
            flat_t = target_e.reshape(b * n, *target_e.shape[2:])
            return component(flat_p, flat_t).reshape(b, n)

        for comp in self.mask_components:
            pred = pred_sig if comp.add_sigmoid else pred_masks
            all_losses = per_mask(comp, pred)  # (B, N)
            best_loss = all_losses.gather(1, best_idx[:, None]).mean()
            full = all_losses.mean()
            total = total + comp.weight * (best_loss + full * decay)
            parts[f"{comp.name}_best"] = best_loss
            parts[f"{comp.name}_full"] = full

        aux_targets = {**batch, "gt_ious": ious}
        for comp in self.aux_components:
            out = outputs[comp.output_key]
            if comp.add_sigmoid:
                out = torch.sigmoid(out)
            aux = comp(out, aux_targets[comp.target_key]).mean()
            total = total + comp.weight * aux
            parts[comp.name] = aux
        return total, parts

    def _single(self, outputs, batch):
        pred = outputs["pred_masks"][:, 0]
        target = batch["masks"]
        total = pred.new_zeros((), dtype=torch.float32)
        parts = {}
        for comp in self.mask_components:
            p = torch.sigmoid(pred) if comp.add_sigmoid else pred
            val = comp(p, target).mean()
            total = total + comp.weight * val
            parts[comp.name] = val
        return total, parts
