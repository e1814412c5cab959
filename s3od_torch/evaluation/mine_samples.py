"""Hard-category mining via flip-consistency self-supervision (counterpart
of `s3od_tpu/evaluation/mine_samples.py`).

Reference (`model_training/mine_samples.py`): per-image score =
(Sm_orig + Sm_flip) * Sm_consistency / 2; sigmoid-scaled per-category sample
allocation; stability analysis; JSON results consumed by the data factory
(`s3od_torch/datagen/generate_train_images.py`, `class_weights_file`).

The original and the horizontally flipped image run as ONE forward of
batch 2 (`SODPredictor.predict_batch`).

Usage:
    python -m s3od_torch.evaluation.mine_samples --input_dir DIR \
        --model_path ckpt.npz [--img_size 1024] [--output_dir results] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from s3od_torch.evaluation.metrics import s_measure


def eval_sample_with_gt(predictor, image: np.ndarray, gt_mask: np.ndarray) -> float:
    """Score one image: Sm of original and flipped predictions vs GT, times
    their mutual consistency (`mine_samples.py:16-51`)."""
    flipped = image[:, ::-1].copy()
    res_orig, res_flip = predictor.predict_batch([image, flipped])
    soft_orig = res_orig.soft_mask
    soft_flip = res_flip.soft_mask[:, ::-1]

    s_orig = s_measure(soft_orig, gt_mask)
    s_flip = s_measure(soft_flip, gt_mask)
    s_cons = s_measure(soft_orig, soft_flip)
    if np.isnan(s_cons):
        s_cons = (s_orig + s_flip) / 2
    return (s_orig + s_flip) * s_cons / 2


def calculate_new_samples(
    category_scores: Dict[str, float],
    min_samples: int = 10,
    max_samples: int = 50,
    high_threshold: float = 0.95,
    low_threshold: float = 0.8,
) -> Dict[str, int]:
    """Difficulty-scaled allocation (`mine_samples.py:79-113`): easy
    categories get ~min, hard ones scale aggressively through a sigmoid."""
    cats = list(category_scores.keys())
    scores = np.array([category_scores[c] for c in cats])
    difficulties = np.empty_like(scores)
    hi, lo = high_threshold, low_threshold
    for i, s in enumerate(scores):
        if s >= hi:
            difficulties[i] = 0.1
        elif s <= lo:
            difficulties[i] = 0.7 + 0.3 * (lo - s) / lo
        else:
            difficulties[i] = 0.1 + 0.6 * (hi - s) / (hi - lo)
    scaled = 1.0 / (1.0 + np.exp(-8.0 * (difficulties - 0.5)))
    n = min_samples + (max_samples - min_samples) * scaled
    return {c: int(round(v)) for c, v in zip(cats, n)}


def analyze_stability(
    scores: Dict[str, float], n_categories: int = 15
) -> Tuple[List[str], List[str]]:
    ordered = sorted(scores.items(), key=lambda kv: kv[1])
    return (
        [c for c, _ in ordered[:n_categories]],
        [c for c, _ in ordered[-n_categories:]],
    )


def save_results(results: dict, output_dir: str, prefix: str = "") -> str:
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, f"{prefix}_eval_results_{stamp}.json")
    clean = {
        "category_scores": {
            k: float(v) for k, v in results["category_scores"].items()
        },
        "new_samples": results["new_samples"],
        "category_sample_scores": {
            k: [float(s) for s in v]
            for k, v in results["category_sample_scores"].items()
        },
        "stable_categories": results["stable_categories"],
        "unstable_categories": results["unstable_categories"],
    }
    Path(out).write_text(json.dumps(clean, indent=4))
    print(f"Results saved to: {out}")
    return out


def mine(
    input_dir: str,
    model_path: str,
    img_size: int = 1024,
    min_samples: int = 20,
    max_samples: int = 100,
    max_val_samples: int = 10,
    output_dir: str = "results",
    device: str = "cuda",
    dtype: str = None,
    _predictor=None,
) -> dict:
    from PIL import Image

    from s3od_torch.evaluation.predictor import SODPredictor

    predictor = _predictor or SODPredictor(model_path, image_size=img_size,
                                           device=device, dtype=dtype)

    splits_file = os.path.join(input_dir, "data_splits.json")
    if os.path.exists(splits_file):
        image_files = json.loads(Path(splits_file).read_text())["val"]
    else:
        images_dir = os.path.join(input_dir, "images")
        image_files = [
            f for f in os.listdir(images_dir) if f.endswith((".jpg", ".png"))
        ]

    categories: Dict[str, List[str]] = defaultdict(list)
    for f in image_files:
        categories[f.rsplit("_", 1)[0]].append(
            os.path.join(input_dir, "images", f)
        )

    category_scores, category_sample_scores = {}, {}
    for category, paths in categories.items():
        scores = []
        for p in paths[:max_val_samples] if max_val_samples else paths:
            image = np.array(Image.open(p).convert("RGB"))
            mask_path = p.replace("images", "masks")
            mask_path = str(Path(mask_path).with_suffix(".png"))
            if not os.path.exists(mask_path):
                continue
            gt = np.array(Image.open(mask_path).convert("L")) / 255.0
            s = eval_sample_with_gt(predictor, image, gt)
            if np.isnan(s):
                print(f"NaN score for {p}")
                continue
            scores.append(s)
        if scores:
            category_scores[category] = float(np.mean(scores))
            category_sample_scores[category] = scores

    new_samples = calculate_new_samples(
        category_scores, min_samples, max_samples
    )
    unstable, stable = analyze_stability(category_scores)
    results = {
        "category_scores": category_scores,
        "new_samples": new_samples,
        "category_sample_scores": category_sample_scores,
        "stable_categories": stable,
        "unstable_categories": unstable,
    }
    results["path"] = save_results(results, output_dir)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--img_size", type=int, default=1024)
    ap.add_argument("--min_samples", type=int, default=20)
    ap.add_argument("--max_samples", type=int, default=100)
    ap.add_argument("--max_val_samples", type=int, default=10)
    ap.add_argument("--output_dir", default="results")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    return mine(**vars(args))


if __name__ == "__main__":
    main()
