"""End-to-end training quality demo on the port (counterpart of
`scripts/train_demo_e2e.py`).

The full product loop with no external data or weights: a procedural
dataset -> train from scratch at 224px through the port's entry point ->
loss down / val dice up -> the exported checkpoint reloaded through the
port's `BackgroundRemoval` -> scored by the port's offline evaluation
(`s3od_torch.evaluation.compute_metrics`).

    python -m s3od_torch.training.demo_e2e [--root DIR] [--epochs 16]

The flags and defaults are the JAX script's. It exits non-zero unless
val_dice > 0.5 and the mean IoU of the 8 held-back images > 0.5 (the JAX
script's gate), and with `--rank-weight` also unless the selection gap
is at most 0.05.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image


# ----------------------------------------------------------------------------
# The procedural dataset (the port's copy of `scripts/make_demo_dataset.py`)
# ----------------------------------------------------------------------------


def _background(rng, h, w):
    kind = rng.integers(0, 3)
    if kind == 0:  # smooth 2D gradient
        a, b = rng.uniform(-1, 1, 2)
        yy, xx = np.mgrid[0:h, 0:w]
        g = (a * yy / h + b * xx / w)
        g = (g - g.min()) / (np.ptp(g) + 1e-6)
        base = rng.uniform(40, 200, 3)
        span = rng.uniform(20, 80, 3)
        return np.clip(base + g[..., None] * span, 0, 255)
    if kind == 1:  # low-frequency noise texture
        small = rng.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        img = np.asarray(
            Image.fromarray(small.astype(np.uint8)).resize((w, h), Image.BILINEAR),
            np.float32,
        )
        return 0.5 * img + 0.25 * 255
    # speckle
    base = rng.uniform(60, 190, 3)
    return np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255)


def _shape_mask(rng, h, w, obj_scale=1.0):
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), bool)
    n_parts = rng.integers(1, 4)
    cy0, cx0 = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    s = obj_scale
    for _ in range(n_parts):
        cy = cy0 + rng.normal(0, 0.08) * h
        cx = cx0 + rng.normal(0, 0.08) * w
        kind = rng.integers(0, 2)
        if kind == 0:  # rotated ellipse
            ry = rng.uniform(0.08, 0.22) * h * s
            rx = rng.uniform(0.08, 0.22) * w * s
            th = rng.uniform(0, np.pi)
            y, x = yy - cy, xx - cx
            yr = y * np.cos(th) - x * np.sin(th)
            xr = y * np.sin(th) + x * np.cos(th)
            mask |= (yr / ry) ** 2 + (xr / rx) ** 2 <= 1
        else:  # convex polygon (random half-plane intersection around center)
            r = rng.uniform(0.1, 0.24) * min(h, w) * s
            poly = np.ones((h, w), bool)
            for ang in np.linspace(0, 2 * np.pi, rng.integers(4, 8), endpoint=False):
                d = rng.uniform(0.7, 1.0) * r
                ny, nx = np.sin(ang), np.cos(ang)
                poly &= (yy - cy) * ny + (xx - cx) * nx <= d
            mask |= poly
    return mask


def make_sample(rng, size, obj_scale=1.0):
    """One (image uint8 (size, size, 3), mask uint8 0/255) pair: a textured
    or gradient background and one salient composite shape with its own
    colour statistics."""
    h = w = size
    img = _background(rng, h, w)
    mask = _shape_mask(rng, h, w, obj_scale)
    obj_color = rng.uniform(0, 255, 3)
    tex = rng.normal(0, 12, (h, w, 1))
    alpha = 0.75 + 0.25 * rng.random()
    img = np.where(
        mask[..., None], alpha * obj_color + (1 - alpha) * img + tex, img
    )
    return (
        np.clip(img, 0, 255).astype(np.uint8),
        (mask * 255).astype(np.uint8),
    )


def write_dataset(out: Path, n: int, size: int, seed: int = 0,
                  obj_scale: float = 1.0) -> None:
    """OUT/{images,masks}/NNNNN.png pairs (the reference dataset layout)."""
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "masks").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, mask = make_sample(rng, size, obj_scale)
        Image.fromarray(img).save(out / "images" / f"{i:05d}.png")
        Image.fromarray(mask).save(out / "masks" / f"{i:05d}.png")


# ----------------------------------------------------------------------------
# The demo
# ----------------------------------------------------------------------------


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(tempfile.gettempdir())
                                          / "s3od_demo_run"))
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--n-images", type=int, default=600)
    ap.add_argument("--lr", type=float, default=2e-4,
                    help="encoder lr; the head trains at --head-lr-mult x "
                         "(the reference's group split), raised from the "
                         "fine-tune default because the demo trains from "
                         "scratch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--data-size", type=int, default=256,
                    help="procedural source-image resolution")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="train and val batch (dataset default 8 / 16)")
    ap.add_argument("--accum", type=int, default=None,
                    help="gradient accumulation steps")
    ap.add_argument("--precision", default="32", choices=["32", "bf16"],
                    help="compute precision: 32 runs the exact float32 route, "
                         "bf16 the hand-written kernels")
    ap.add_argument("--loss", default="focal_iou",
                    choices=["focal_iou", "bce_iou_ssim"])
    ap.add_argument("--head-lr-mult", type=float, default=10.0)
    ap.add_argument("--model", default="dinob",
                    choices=["dinos", "dinob", "dinol"])
    ap.add_argument("--transform-mode", default="regular",
                    choices=["test", "regular", "synthetic"])
    ap.add_argument("--iou-mse-weight", type=float, default=None,
                    help="override the IoU-head MSE criterion weight")
    ap.add_argument("--rank-weight", type=float, default=None,
                    help="append the pairwise IoU-ranking criterion at this "
                         "weight; the gate then also holds the selection gap")
    ap.add_argument("--cache", action="store_true",
                    help="the pre-decoded uint8 letterbox memmap cache")
    ap.add_argument("--cpu", action="store_true",
                    help="train and score on the CPU (a mechanics run)")
    ap.add_argument("--checkpoint-path", default=None,
                    help="resume from a saved checkpoint")
    ap.add_argument("--save-every", type=int, default=1,
                    help="write the 'last' checkpoint every N epochs")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict:
    """Make the data, train, reload, score. Returns the summary with its
    gate under "ok"."""
    from s3od_torch import BackgroundRemoval
    from s3od_torch.evaluation.compute_metrics import evaluate_datasets
    from s3od_torch.training.train import train

    root = Path(args.root)
    data_dir = root / "data"
    exp_dir = root / "exp"
    if not (data_dir / "demo" / "images").exists():
        write_dataset(data_dir / "demo", args.n_images, args.data_size)

    overrides = [
        "backend=cpu" if args.cpu else "backend=1chip",
        "dataset=duts",
        f"model={args.model}",
        f"loss={args.loss}",
        f"data_dir={data_dir}",
        "dataset.paths=[demo]",
        "dataset.test_datasets=[]",
        f"dataset.image_size={args.image_size}",
        f"dataset.transform_mode={args.transform_mode}",
        f"backend.max_epochs={args.epochs}",
        "backend.remat_policy=flash",
        f"optimizer.lr={args.lr}",
        f"optimizer.head_lr_mult={args.head_lr_mult}",
        "optimizer.grad_clip=1.0",
        "scheduler.warmup_epochs=8",
        f"backend.precision={args.precision}",
        f"base_dir={exp_dir}",
        "experiment_name=demo",
        f"backend.save_every={args.save_every}",
    ]
    if args.image_size >= 1024:
        overrides.append("backend.split_augment=true")
    if args.batch_size:
        overrides += [f"dataset.train_batch_size={args.batch_size}",
                      f"dataset.val_batch_size={args.batch_size}"]
    if args.accum:
        overrides.append(f"backend.accumulate_grad_batches={args.accum}")
    if args.checkpoint_path:
        overrides.append(f"checkpoint_path={args.checkpoint_path}")
    if args.iou_mse_weight is not None:
        overrides.append(f"loss.weights.mse_ious_loss={args.iou_mse_weight}")
    if args.rank_weight is not None:
        overrides.append(f"loss.rank_weight={args.rank_weight}")
    if args.cache:
        overrides.append("dataset.cache=true")
    metrics = train(overrides)
    print("final metrics:", json.dumps(metrics, default=float))

    runs = sorted(exp_dir.glob("**/index.json"))
    if not runs:
        raise RuntimeError(f"no checkpoint index under {exp_dir}")
    index = json.loads(runs[-1].read_text())
    best = sorted((e["epoch"], e["score"]) for e in index.get("best", []))
    print("top-k checkpoints (epoch, val_dice):", best)

    finals = sorted(exp_dir.glob("**/s3od_final.npz"))
    if not finals:
        raise RuntimeError(f"no s3od_final.npz under {exp_dir}")
    device = "cpu" if args.cpu else "cuda"
    br = BackgroundRemoval(str(finals[-1]), image_size=args.image_size,
                           device=device)
    img_paths = sorted((data_dir / "demo" / "images").glob("*.png"))[-8:]
    ious, best_ious = [], []
    for p in img_paths:
        res = br.remove_background(np.asarray(Image.open(p).convert("RGB")))
        gt = np.asarray(Image.open(data_dir / "demo" / "masks" / p.name)
                        .convert("L")) > 128

        def iou(mask):
            pred = mask > 0.5
            return (pred & gt).sum() / max((pred | gt).sum(), 1)

        ious.append(iou(res.predicted_mask))
        # Oracle best mask: the selection head's ceiling.
        best_ious.append(max(iou(m) for m in res.all_masks))
    mean_iou, mean_best = float(np.mean(ious)), float(np.mean(best_ious))
    sel_gap = mean_best - mean_iou
    print(f"BackgroundRemoval on 8 held-back images: mean IoU {mean_iou:.3f} "
          f"(oracle best {mean_best:.3f}, selection gap {sel_gap:.3f})")

    results = evaluate_datasets(model_path=str(finals[-1]),
                                input_dir=str(data_dir), datasets=["demo"],
                                image_size=args.image_size, batch=8,
                                device=device)
    print("eval CLI:", json.dumps(results, default=float))

    ok = metrics.get("val_dice", 0.0) > 0.5 and mean_iou > 0.5
    if args.rank_weight is not None:
        ok = ok and sel_gap <= 0.05
    summary = {"ok": bool(ok), "val_dice": metrics.get("val_dice"),
               "train_loss": metrics.get("train_loss"),
               "holdout_iou": mean_iou, "holdout_best_iou": mean_best,
               "selection_gap": sel_gap, "eval": results, "top_k": best}
    print("DEMO", "OK" if ok else "WEAK", json.dumps(
        {k: summary[k] for k in ("val_dice", "holdout_iou", "holdout_best_iou",
                                 "selection_gap")}, default=float))
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)  # epoch lines: the learning curve
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
