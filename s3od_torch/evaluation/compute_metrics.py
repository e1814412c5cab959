"""Offline evaluation CLI over SOD benchmark datasets, on PyTorch
(counterpart of `s3od_tpu/evaluation/compute_metrics.py`, same flags plus
`--device`).

The dataset loop (`process_dataset`), the registry (`get_datasets`) and the
metrics are the JAX package's jax-free modules, reused as they are; only
the predictor is the port's `SODPredictor`.

Usage:
    python -m s3od_torch.evaluation.compute_metrics \
        --input_dir /data/Test_Dataset --model_path ckpt.npz \
        --image_size 2048 --datasets dis [--device cpu] [--batch 1]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

from s3od_torch.evaluation.predictor import SODPredictor
from s3od_tpu.evaluation.compute_metrics import get_datasets, process_dataset


def evaluate_datasets(
    *,
    model_path: Optional[str] = None,
    model_params: Optional[tuple] = None,
    input_dir: str,
    datasets: List[str],
    image_size: int = 840,
    batch: Optional[int] = None,
    compute_best_metrics: bool = False,
    device: str = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Programmatic API. `model_params` is a JAX-layout (params, state,
    cfg) tuple with numpy leaves. `batch=None` takes 1 at canvases of 2048
    and above and 4 below, the JAX package's defaults."""
    if batch is None:
        batch = 1 if image_size >= 2048 else 4
    if model_params is not None:
        params, state, cfg = model_params
        predictor = SODPredictor.from_params(
            params, state, cfg, image_size=image_size, device=device)
    else:
        predictor = SODPredictor(model_path, image_size=image_size,
                                 device=device)
    out = {}
    for ds in datasets:
        ds_dir = f"{input_dir}/{ds}"
        if not os.path.isdir(ds_dir):
            print(f"skipping missing dataset dir {ds_dir}")
            continue
        out[ds] = process_dataset(ds_dir, predictor, compute_best_metrics,
                                  batch=batch)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--img_size", "--image_size", type=int, default=840,
                    dest="img_size",
                    help="square inference canvas; 2048 is the DIS5K "
                         "high-res path (16389 tokens)")
    ap.add_argument("--datasets", default="all")
    ap.add_argument("--compute_best_metrics", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 4 (<2048px), 1 (>=2048px)")
    ap.add_argument("--output_json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (bf16 through the kernels) or cpu (float32)")
    args = ap.parse_args(argv)

    results = evaluate_datasets(
        model_path=args.model_path,
        input_dir=args.input_dir,
        datasets=get_datasets(args.datasets),
        image_size=args.img_size,
        batch=args.batch,
        compute_best_metrics=args.compute_best_metrics,
        device=args.device,
    )
    for ds, metrics in results.items():
        print(f"Dataset: {ds}, Metrics: {metrics}")
    if args.output_json:
        Path(args.output_json).write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
