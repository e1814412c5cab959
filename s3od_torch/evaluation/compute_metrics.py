"""Offline evaluation CLI over SOD benchmark datasets, on PyTorch
(counterpart of `s3od_tpu/evaluation/compute_metrics.py`, same flags plus
`--device`).

The dataset registry (`get_datasets`), the dataset loop (`process_dataset`)
and the metrics (`s3od_torch.evaluation.metrics`) are the port's own
copies of the JAX package's; the predictor is the port's `SODPredictor`.

Usage:
    python -m s3od_torch.evaluation.compute_metrics \
        --input_dir /data/Test_Dataset --model_path ckpt.npz \
        --image_size 2048 --datasets dis [--device cpu] [--batch 1]
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from s3od_torch.evaluation.metrics import MetricAccumulator
from s3od_torch.evaluation.predictor import SODPredictor

# `compute_metrics.py:198-208` evaluation sets plus the extra sets the
# metadata generator covers (`generate_test_metadata.py:25-27`): DIS-VD,
# ECSSD, HKU-IS.
DIS_DATASETS = ["DIS-TE1", "DIS-TE2", "DIS-TE3", "DIS-TE4"]
SOD_DATASETS = ["DUTS-TE", "DUT-OMRON", "HRSOD-TE", "UHRSD-TE", "DAVIS-S"]
EXTRA_DATASETS = ["DIS-VD", "ECSSD", "HKU-IS"]


def get_datasets(datasets: str) -> List[str]:
    if datasets == "all":
        return DIS_DATASETS + SOD_DATASETS
    if datasets == "full":
        return DIS_DATASETS + ["DIS-VD"] + SOD_DATASETS + ["ECSSD", "HKU-IS"]
    if datasets == "dis":
        return DIS_DATASETS
    if datasets == "sod":
        return SOD_DATASETS
    return [d.strip() for d in datasets.split(",")]


def find_gt_mask_path(image_path: str) -> Optional[str]:
    for ext in (".png", ".jpg", ".jpeg"):
        p = image_path.replace("/images/", "/masks/")
        p = str(Path(p).with_suffix(ext))
        if os.path.exists(p):
            return p
    return None


def _load_image(path: str) -> Optional[np.ndarray]:
    try:
        import cv2

        img = cv2.imread(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except Exception:
        from PIL import Image

        return np.array(Image.open(path).convert("RGB"))


def _load_gt(path: str) -> np.ndarray:
    try:
        import cv2

        return (cv2.imread(path, cv2.IMREAD_GRAYSCALE) > 128).astype(np.float64)
    except Exception:
        from PIL import Image

        return (np.array(Image.open(path).convert("L")) > 128).astype(np.float64)


def process_dataset(
    data_dir: str,
    predictor,
    compute_best_metrics: bool = False,
    batch: int = 4,
    progress: bool = True,
) -> Dict:
    import time

    images = sorted(glob(f"{data_dir}/images/*"))
    acc = MetricAccumulator()
    best_acc = MetricAccumulator() if compute_best_metrics else None
    predict_s = 0.0
    n_predicted = 0

    it = range(0, len(images), batch)
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(it, desc=f"eval {Path(data_dir).name}")
        except ImportError:
            pass

    for b0 in it:
        chunk = images[b0 : b0 + batch]
        loaded = [( p, _load_image(p)) for p in chunk]
        loaded = [(p, im) for p, im in loaded if im is not None]
        t0 = time.perf_counter()
        results = predictor.predict_batch([im for _, im in loaded])
        # Steady-state full batches only: the first batch pays the
        # kernels' build and warm-up, and a final partial batch runs at
        # another shape.
        if b0 > 0 and len(loaded) == batch:
            predict_s += time.perf_counter() - t0
            n_predicted += len(loaded)
        for (img_path, _), result in zip(loaded, results):
            gt_path = find_gt_mask_path(img_path)
            if gt_path is None:
                print(f"Warning: GT mask not found for {img_path}")
                continue
            gt = _load_gt(gt_path)
            acc.step(result.soft_mask, gt)
            if compute_best_metrics:
                if result.has_multiple_masks:
                    gtb = gt > 0.5
                    best_iou, best_mask = -1.0, None
                    for m in result.all_masks:
                        mb = m > 0.5
                        union = np.logical_or(mb, gtb).sum()
                        iou = (
                            np.logical_and(mb, gtb).sum() / union
                            if union > 0
                            else 1.0
                        )
                        if iou > best_iou:
                            best_iou, best_mask = iou, m
                    best_acc.step(best_mask, gt)
                else:
                    best_acc.step(result.soft_mask, gt)

    # Prediction throughput (predict_batch wall time: letterbox + device
    # forward + unpad/antialiased resize; excludes GT loading/metric
    # math) — the reference reports FPS only via its separate
    # test_efficiency harness; here every eval run records it.
    perf = {
        "img_per_s": round(n_predicted / predict_s, 2) if predict_s else 0.0
    }
    if compute_best_metrics:
        return {
            "pred_metrics": acc.compute(),
            "best_metrics": best_acc.compute(),
            **perf,
        }
    return {**acc.compute(), **perf}




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
