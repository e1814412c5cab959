"""Standard SOD evaluation metrics: MAE, Max/Avg F-measure, S-measure,
E-measure, weighted F-measure (the port's own copy of
`s3od_tpu/evaluation/metrics.py`).

Functional reimplementation of the metric definitions used by the reference
(`model_training/metrics.py:213-314`; the standard Fan et al. S/E-measure and
Margolin wF formulations). Key differences from the reference implementation:

- the 255-threshold PR sweep (`metrics.py:316-327`, a Python loop over
  thresholds) is computed exactly via a histogram + reverse cumsum over the
  threshold edges — O(HW + T) instead of O(T*HW);
- everything is numpy (no torch); per-image scores are accumulated by a
  small `MetricAccumulator`.

Semantics match the reference: soft pred in [0,1]; GT binarized at >0.5 for
S-measure, >0 for E/wF; per-dataset means.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_EPS = float(np.spacing(1))


def mae(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - gt)))


def _pr_sweep(pred: np.ndarray, gt: np.ndarray, num: int = 255):
    """Precision/recall at `num` thresholds linspace(0, 1-1e-10, num).

    tp(t) = sum(pred >= t over gt==1) computed for all t at once via
    histogram + reverse-cumsum (exact equivalence to per-threshold loops).
    """
    thresholds = np.linspace(0, 1 - 1e-10, num)
    gt_pos = gt > 0.5
    # bin index = number of thresholds <= value; counts per interval
    edges = np.concatenate([thresholds, [np.inf]])
    hist_fg, _ = np.histogram(pred[gt_pos], bins=edges)
    hist_all, _ = np.histogram(pred, bins=edges)
    # #(pred >= thresholds[i]) = sum of bins i..end
    tp = np.cumsum(hist_fg[::-1])[::-1].astype(np.float64)
    pp = np.cumsum(hist_all[::-1])[::-1].astype(np.float64)
    n_pos = float(gt_pos.sum())
    prec = tp / (pp + 1e-20)
    recall = tp / (n_pos + 1e-20)
    return prec, recall


def f_measures(pred: np.ndarray, gt: np.ndarray, beta2: float = 0.3):
    """(MaxF, AvgF) over the 255-threshold sweep (beta^2 = 0.3)."""
    prec, recall = _pr_sweep(pred, gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = (1 + beta2) * prec * recall / (beta2 * prec + recall)
    f = np.nan_to_num(f, nan=0.0)
    return float(f.max()), float(f.mean())


# ----------------------------------------------------------------------------
# S-measure (structure measure)
# ----------------------------------------------------------------------------


def _object_score(vals: np.ndarray) -> float:
    if vals.size == 0:
        return 0.0
    x = float(vals.mean())
    # torch.std is unbiased (ddof=1); a single element gives NaN -> score NaN
    # guarded to 0 like the reference's downstream nan handling.
    sigma = float(vals.std(ddof=1)) if vals.size > 1 else float("nan")
    score = 2.0 * x / (x * x + 1.0 + sigma + 1e-20)
    return 0.0 if np.isnan(score) else score


def _s_object(pred: np.ndarray, gt: np.ndarray) -> float:
    fg = np.where(gt, pred, 0.0)
    bg = np.where(gt, 0.0, 1.0 - pred)
    u = float(gt.mean())
    return u * _object_score(fg[gt]) + (1 - u) * _object_score(bg[~gt])


def _ssim_region(pred: np.ndarray, gt: np.ndarray) -> float:
    h, w = pred.shape
    n = h * w
    if n <= 1:
        return 1.0
    x, y = float(pred.mean()), float(gt.mean())
    dx, dy = pred - x, gt - y
    sx2 = float((dx * dx).sum()) / (n - 1 + 1e-20)
    sy2 = float((dy * dy).sum()) / (n - 1 + 1e-20)
    sxy = float((dx * dy).sum()) / (n - 1 + 1e-20)
    alpha = 4 * x * y * sxy
    beta = (x * x + y * y) * (sx2 + sy2)
    if alpha != 0:
        return alpha / (beta + 1e-20)
    return 1.0 if beta == 0 else 0.0


def _s_region(pred: np.ndarray, gt: np.ndarray) -> float:
    h, w = gt.shape
    total = gt.sum()
    if total == 0:
        cx, cy = round(w / 2), round(h / 2)
    else:
        cols = np.arange(w, dtype=np.float64)
        rows = np.arange(h, dtype=np.float64)
        cx = int(round(float((gt.sum(0) * cols).sum() / total)))
        cy = int(round(float((gt.sum(1) * rows).sum() / total)))
    area = h * w
    w1 = cx * cy / area
    w2 = (w - cx) * cy / area
    w3 = cx * (h - cy) / area
    w4 = 1 - w1 - w2 - w3
    score = 0.0
    for (ys, xs, wt) in (
        (slice(0, cy), slice(0, cx), w1),
        (slice(0, cy), slice(cx, w), w2),
        (slice(cy, h), slice(0, cx), w3),
        (slice(cy, h), slice(cx, w), w4),
    ):
        score += wt * _ssim_region(pred[ys, xs], gt[ys, xs].astype(np.float64))
    return score


def s_measure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    """Structure measure; gt binarized at 0.5 (`metrics.py:258-272`)."""
    y = float(gt.mean())
    if y == 0:
        return 1.0 - float(pred.mean())
    if y == 1:
        return float(pred.mean())
    gtb = gt >= 0.5
    q = alpha * _s_object(pred, gtb) + (1 - alpha) * _s_region(pred, gtb)
    return max(q, 0.0)


# ----------------------------------------------------------------------------
# E-measure (enhanced alignment)
# ----------------------------------------------------------------------------


def _em_from_counts(fg_fg, fg_bg, gt_fg: float, size: float):
    """Enhanced-alignment sum from confusion counts (vectorized over
    thresholds). Derivation: with binary maps, the alignment matrix takes one
    of 4 values by (pred, gt) region; each region's value depends only on the
    demeaned means."""
    pred_fg = fg_fg + fg_bg
    pred_bg = size - pred_fg
    bg_fg = gt_fg - fg_fg
    bg_bg = pred_bg - bg_fg
    parts = [fg_fg, fg_bg, bg_fg, bg_bg]

    mean_pred = pred_fg / size
    mean_gt = gt_fg / size
    combos = [
        (1 - mean_pred, 1 - mean_gt),
        (1 - mean_pred, 0 - mean_gt),
        (0 - mean_pred, 1 - mean_gt),
        (0 - mean_pred, 0 - mean_gt),
    ]
    total = 0.0
    for numel, (dp, dg) in zip(parts, combos):
        align = 2 * dp * dg / (dp * dp + dg * dg + _EPS)
        total = total + ((align + 1) ** 2 / 4) * numel
    return total


def e_measure_curve(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """256-threshold E-measure curve via the cumsum-histogram trick."""
    gtb = gt > 0
    size = float(gtb.size)
    gt_fg = float(gtb.sum())
    pred_u8 = (pred * 255).astype(np.uint8)
    bins = np.linspace(0, 256, 257)
    h_fg, _ = np.histogram(pred_u8[gtb], bins=bins)
    h_bg, _ = np.histogram(pred_u8[~gtb], bins=bins)
    fg_fg = np.cumsum(h_fg[::-1]).astype(np.float64)
    fg_bg = np.cumsum(h_bg[::-1]).astype(np.float64)
    if gt_fg == 0:
        enh = size - (fg_fg + fg_bg)
    elif gt_fg == size:
        enh = fg_fg + fg_bg
    else:
        enh = _em_from_counts(fg_fg, fg_bg, gt_fg, size)
    return enh / (size - 1 + _EPS)


def e_measure_adaptive(pred: np.ndarray, gt: np.ndarray) -> float:
    gtb = gt > 0
    size = float(gtb.size)
    gt_fg = float(gtb.sum())
    thr = min(2 * pred.mean(), 1.0)
    binp = pred >= thr
    fg_fg = float(np.count_nonzero(binp & gtb))
    fg_bg = float(np.count_nonzero(binp & ~gtb))
    if gt_fg == 0:
        enh = size - (fg_fg + fg_bg)
    elif gt_fg == size:
        enh = fg_fg + fg_bg
    else:
        enh = _em_from_counts(fg_fg, fg_bg, gt_fg, size)
    return float(enh / (size - 1 + _EPS))


# ----------------------------------------------------------------------------
# Weighted F-measure (Margolin et al.)
# ----------------------------------------------------------------------------


def _gauss2d(shape=(7, 7), sigma=5.0) -> np.ndarray:
    m, n = [(s - 1) / 2 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h / h.sum() if h.sum() else h


def weighted_f_measure(pred: np.ndarray, gt: np.ndarray, beta: float = 1.0) -> float:
    from scipy.ndimage import convolve, distance_transform_edt

    gtb = gt > 0
    if not gtb.any():
        return 0.0
    dst, idx = distance_transform_edt(~gtb, return_indices=True)
    err = np.abs(pred - gtb.astype(np.float64))
    err_t = err.copy()
    bg = ~gtb
    err_t[bg] = err_t[idx[0][bg], idx[1][bg]]
    ea = convolve(err_t, _gauss2d(), mode="constant", cval=0)
    min_e_ea = np.where(gtb & (ea < err), ea, err)
    b = np.where(bg, 2 - np.exp(np.log(0.5) / 5 * dst), 1.0)
    ew = min_e_ea * b
    tpw = gtb.sum() - ew[gtb].sum()
    fpw = ew[bg].sum()
    recall = 1 - ew[gtb].mean()
    prec = tpw / (tpw + fpw + _EPS)
    return float((1 + beta) * recall * prec / (recall + beta * prec + _EPS))


# ----------------------------------------------------------------------------
# Accumulator
# ----------------------------------------------------------------------------


class MetricAccumulator:
    """Per-dataset accumulation of all metrics (reference
    `EvaluationMetrics.step/compute_metrics`)."""

    def __init__(self, sm_only: bool = False):
        self.sm_only = sm_only
        self.scores: Dict[str, List[float]] = {}
        self.em_curves: List[np.ndarray] = []

    def _add(self, name: str, value: float):
        self.scores.setdefault(name, []).append(value)

    def step(self, pred: np.ndarray, gt: np.ndarray) -> None:
        pred = np.asarray(pred, dtype=np.float64)
        gt = np.asarray(gt, dtype=np.float64)
        self._add("Sm", s_measure(pred, gt))
        if self.sm_only:
            return
        self._add("MAE", mae(pred, gt))
        maxf, avgf = f_measures(pred, gt)
        self._add("MaxF", maxf)
        self._add("AvgF", avgf)
        self.em_curves.append(e_measure_curve(pred, gt))
        # The reference accumulates adaptive E-measure per image alongside
        # the threshold curve (`model_training/metrics.py:16-45`); reported
        # as `adpEm`.
        self._add("adpEm", e_measure_adaptive(pred, gt))
        self._add("wF", weighted_f_measure(pred, gt))

    def compute(self) -> Dict[str, float]:
        out = {k: float(np.mean(v)) for k, v in self.scores.items()}
        if self.em_curves:
            out["Em"] = float(np.mean(np.stack(self.em_curves), axis=0).mean())
        return out

    def reset(self) -> None:
        self.scores.clear()
        self.em_curves.clear()
