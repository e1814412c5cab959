"""The comparison that decides `correct`: the numbers each cell holds
against the plain reference, and the judgement against the cell's limits
(its workload file's `limits`).

Serving, over the compared answers (a seeded sample of the window's):
- `mask_rel`: ||M - M_ref|| / ||M_ref - mean(M_ref)||, each sum over every
  mask of every compared answer at the original size (the "best" payload
  returns one mask an answer: the reference's mask of the same index);
- `iou_rms`: the root mean square of score - score_ref over every IoU
  score of every compared answer;
- `alpha_gap`: the largest difference of an RGBA's alpha from the
  reference's (its mask of the chosen index), in grey levels; 255 where
  the RGB is not the image's;
- `pick`: the largest difference between a returned `predicted_mask` and
  the returned mask of the best score (exact: limit 0).

Training, over the first three steps (a leaf's gap is measured against
its reference norm or the median leaf's, whichever is larger):
- `loss_rel`: the largest |loss - loss_ref| / |loss_ref| of the steps;
- `fwd_rel`: ||M - M_ref|| / ||M_ref - mean(M_ref)|| of the first step's
  mask logits, as the step's own forward computed them;
- `grad_rel` / `grad_med`: the worst / the median leaf's gap between the
  program's and the reference's norm of the first step's gradient (the
  program's as its optimizer takes it);
- `grad_diff_med`: the median leaf's ||g - g_ref|| of that gradient;
- `update_rel`: the worst leaf's gap of the norms of the parameters'
  change after the three steps;
- `update_group_med`: that gap's median leaf in each optimizer group (the
  encoder; the rest at `head_lr_mult`), the larger of the two: a group
  left unmoved, or moved at the other's rate, reads about 1 however few
  leaves it holds.
Over the leaves whose reference gradient is at least a thousandth of the
median leaf's: the others (the conv biases ahead of a training-mode
BatchNorm, whose mean it removes; the unused parameters) have a gradient
of nought up to rounding, and move by weight decay and round-off alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from perfbench.reference.train import group_of

MEDIAN_FLOOR = 1e-3  # leaves whose reference gradient is under this x median


def serving_numbers(result, image: np.ndarray, ref: Dict[str, torch.Tensor],
                    payload: str) -> Dict[str, float]:
    """The sums of one answer: `result` as the program returned it (masks,
    scores, predicted mask, RGBA), `ref` from `reference.serve`."""
    dev = ref["masks"].device
    masks = torch.from_numpy(np.ascontiguousarray(result.all_masks)).to(dev).float()
    ious = torch.from_numpy(np.asarray(result.all_ious, np.float32)).to(dev)
    ref_ious = ref["ious"].float()
    choice = int(np.argmax(result.all_ious))
    ref_masks = ref["masks"] if payload == "full" else ref["masks"][choice: choice + 1]
    if masks.shape != ref_masks.shape or ious.shape != ref_ious.shape:
        return {"mask_err2": float("inf"), "mask_dev2": 1.0, "iou_err2": float("inf"),
                "iou_n": 1, "alpha_gap": 255.0, "pick": float("inf")}
    best_returned = masks[choice if payload == "full" else 0]
    pred = torch.from_numpy(np.ascontiguousarray(result.predicted_mask)).to(dev).float()
    pick = (float((pred - best_returned).abs().max())
            if pred.shape == best_returned.shape else float("inf"))
    rgba = np.asarray(result.rgba_image)
    alpha_gap = 255.0
    if rgba.shape == image.shape[:2] + (4,) and np.array_equal(rgba[..., :3], image):
        ref_alpha = (ref["masks"][choice] * 255).to(torch.uint8).to(torch.int16)
        got = torch.from_numpy(rgba[..., 3].copy()).to(dev).to(torch.int16)
        alpha_gap = float((got - ref_alpha).abs().max())
    return {"mask_err2": float(((masks - ref_masks).double() ** 2).sum()),
            "mask_dev2": float(((ref_masks - ref_masks.mean()).double() ** 2).sum()),
            "iou_err2": float(((ious - ref_ious).double() ** 2).sum()),
            "iou_n": int(ious.numel()), "alpha_gap": alpha_gap, "pick": pick}


def serving_summary(rows: List[Mapping[str, float]]) -> Dict[str, float]:
    """The serving numbers over all compared answers."""
    if not rows:
        return {}
    return {"mask_rel": math.sqrt(sum(r["mask_err2"] for r in rows)
                                  / max(sum(r["mask_dev2"] for r in rows), 1e-30)),
            "iou_rms": math.sqrt(sum(r["iou_err2"] for r in rows)
                                 / sum(r["iou_n"] for r in rows)),
            "alpha_gap": max(r["alpha_gap"] for r in rows),
            "pick": max(r["pick"] for r in rows)}


def _norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _leaf_gaps(got: Mapping[str, float], ref: Mapping[str, float], keys) -> List[float]:
    keys = list(keys)
    if not keys:
        return [float("inf")]
    med = float(np.median([ref[k] for k in keys]))
    return [abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def group_median(gaps: List[float], names: List[str]) -> float:
    """The larger of the optimizer groups' median gaps."""
    groups: Dict[str, List[float]] = {}
    for gap, name in zip(gaps, names):
        groups.setdefault(group_of(name), []).append(gap)
    return max(float(np.median(v)) for v in groups.values())


def forward_rel(first, ref_first) -> float:
    """||logits - logits_ref|| / ||logits_ref - mean|| of the first step's
    mask logits (inf where the shapes differ)."""
    got, want = first[0].float(), ref_first[0].float()
    if got.shape != want.shape:
        return float("inf")
    got = got.to(want.device)
    return float((got - want).double().norm()
                 / (want - want.mean()).double().norm().clamp_min(1e-30))


def training_numbers(losses: List[float],
                     grads1: Mapping[str, float], updates: Mapping[str, float],
                     ref: dict, g1: Mapping[str, torch.Tensor] = None,
                     first=None) -> Dict[str, float]:
    """`losses`: the program's first three losses; `first`: its first
    step's (mask logits, IoU logits);
    `grads1` and `updates`: its per-leaf norms (checkpoint names) of the
    first gradient and of the change after three steps; `g1`: its first
    gradient itself, leaf by leaf; `ref` from
    `reference.train.train_steps`. Returns (numbers, the three worst
    leaves of each gap: a look at what reads high, logged, never
    judged)."""
    inf = float("inf")
    names = ("loss_rel", "fwd_rel", "grad_rel", "grad_med", "grad_diff_med",
             "update_rel", "update_group_med")
    if len(losses) != len(ref["losses"]):
        return {k: inf for k in names}, {}
    g_ref = _norms(ref["grads1"])
    med = float(np.median(list(g_ref.values())))
    moving = [k for k, v in g_ref.items() if v >= MEDIAN_FLOOR * med]
    d_ref = {k: float((ref["params"][k].double() - ref["initial"][k].double()).norm())
             for k in moving}
    if set(g_ref) - set(grads1):
        return {k: inf for k in names}, {}
    g = _leaf_gaps(grads1, g_ref, moving)
    u = _leaf_gaps(updates, d_ref, moving)
    out = {"loss_rel": max(_rel(a, b) for a, b in zip(losses, ref["losses"])),
           "fwd_rel": forward_rel(first, ref["first"]) if first is not None else inf,
           "grad_rel": max(g), "grad_med": float(np.median(g)),
           "grad_diff_med": inf,
           "update_rel": max(u), "update_group_med": group_median(u, moving)}
    if g1 is not None:
        rg = ref["grads1"]
        floor = float(np.median([g_ref[j] for j in moving]))
        out["grad_diff_med"] = float(np.median([
            float((g1[k].to(rg[k].device).double() - rg[k].double()).norm())
            / max(g_ref[k], floor, 1e-30) if k in g1 else inf for k in moving]))
    order = lambda gaps: sorted(zip(gaps, moving), reverse=True)[:3]
    worst = {"grad": order(g), "update": order(u),
             "grad_ref_over_median": {k: g_ref[k] / med for _, k in order(g)}}
    return out, worst


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number within its limit; a number that is missing or not
    finite fails."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
