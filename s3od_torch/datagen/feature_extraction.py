"""Offline FLUX-feature extraction for real datasets, in PyTorch
(counterpart of `s3od_tpu/datagen/feature_extraction.py`).

For each image of the real SOD training sets: a single-step img2img noise
inversion at the last timestep with concept attention over [tag,
'background'] (`ConceptAttentionPipeline.extract_features`), saved as a
compressed fp16 `.npz` per image: layer_0..3 tap features + category +
background concept maps, keyed `{DATASET}_{stem}`; sharded by task;
resumable by skipping existing files.

Usage:
    python -m s3od_torch.datagen.feature_extraction --config extraction.yaml \
        [--task_id N --num_tasks M]

Config keys (the JAX package's): input_dir, output_dir, metadata_dir
(captions/tags JSONs per dataset), flux_checkpoint, vae_checkpoint,
datasets, num_inference_steps, fsdp. The port's own, as in
`generate_train_images`: t5_checkpoint and clip_checkpoint (converted
`.npz` trees for the on-device text encoders; without them the encoders
come from transformers at the first prompt) and device ("cuda" by
default).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import yaml

from s3od_torch.datagen.resizer import FluxResizer
from s3od_torch.datagen.sharding import detect_task, filter_unprocessed, task_slice
from s3od_torch.parallel.distributed import broadcast_object, rank

logger = logging.getLogger("s3od_torch.extract")


class FeatureStorage:
    """fp16 .npz per image: layer_0..3 + category + background."""

    def __init__(self, output_dir: str):
        self.features_dir = Path(output_dir) / "features"
        self.features_dir.mkdir(parents=True, exist_ok=True)

    def path(self, sample_id: str) -> Path:
        return self.features_dir / f"{sample_id}.npz"

    def exists(self, sample_id: str) -> bool:
        return self.path(sample_id).exists()

    def save(self, sample_id: str, features: List[np.ndarray],
             concept_maps: Dict[str, np.ndarray]) -> None:
        arrays = {f"layer_{i}": f.astype(np.float16)
                  for i, f in enumerate(features)}
        arrays["category"] = concept_maps["category"].astype(np.float16)
        arrays["background"] = concept_maps["background"].astype(np.float16)
        np.savez_compressed(self.path(sample_id), **arrays)


def load_metadata(metadata_dir: str, dataset: str) -> Dict[str, Dict[str, str]]:
    """captions.json / tags.json per dataset, merged with the per-task
    shard files (`captions.taskNNNN.json`) of sharded metadata runs:
    {image stem: {'caption': ..., 'tag': ...}}."""
    meta: Dict[str, Dict[str, str]] = {}
    base = Path(metadata_dir) / dataset
    for kind in ("captions", "tags"):
        for f in sorted(base.glob(f"{kind}*.json")):
            for item in json.loads(f.read_text()):
                key = Path(item["image_path"]).stem
                meta.setdefault(key, {})[kind[:-1]] = item[kind[:-1]]
    return meta


class FluxFeatureExtractor:
    def __init__(self, pipeline, vae, num_inference_steps: int = 28):
        self.pipeline = pipeline
        self.vae = vae
        self.resizer = FluxResizer()
        self.num_steps = num_inference_steps

    def extract(self, image: np.ndarray, caption: str, tag: str):
        """-> (features list, concept maps dict) at the bucket resolution."""
        resized, (th, tw) = self.resizer.resize_image(image)
        latents = self.vae.encode(resized)
        out = self.pipeline.extract_features(
            latents, caption, [tag, "background"], th, tw)
        cmaps = {"category": out.concept_maps[tag],
                 "background": out.concept_maps["background"]}
        return [f[0] if f.ndim == 3 else f for f in out.features], cmaps


def text_encoders_from(cfg: dict):
    """The on-device encoders of `t5_checkpoint` / `clip_checkpoint`, or
    None (the pipeline's transformers encoders)."""
    if not (cfg.get("t5_checkpoint") and cfg.get("clip_checkpoint")):
        return None
    from s3od_torch.datagen.text_encoding import TorchTextEncoders

    return TorchTextEncoders.from_npz(cfg["t5_checkpoint"],
                                      cfg["clip_checkpoint"],
                                      device=cfg.get("device"))


def run(config_path: str, task_id: Optional[int] = None,
        num_tasks: Optional[int] = None) -> int:
    from PIL import Image

    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.models.vae import load_vae

    cfg = yaml.safe_load(Path(config_path).read_text())
    storage = FeatureStorage(cfg["output_dir"])
    device = cfg.get("device", "cuda")
    pipeline = ConceptAttentionPipeline.from_config(
        checkpoint=cfg["flux_checkpoint"],
        num_inference_steps=cfg.get("num_inference_steps", 28),
        fsdp=cfg.get("fsdp"), text_encoders=text_encoders_from(cfg),
        device=device)
    extractor = FluxFeatureExtractor(
        pipeline, load_vae(cfg["vae_checkpoint"], device=device))

    jobs = []
    for dataset in cfg["datasets"]:
        meta = load_metadata(cfg.get("metadata_dir", ""), dataset)
        images_dir = Path(cfg["input_dir"]) / dataset / "images"
        for img in sorted(images_dir.glob("*")):
            jobs.append((f"{dataset}_{img.stem}", img, meta.get(img.stem, {})))

    tid, ntasks = detect_task(task_id, num_tasks)
    jobs = task_slice(jobs, tid, ntasks)
    # Under `fsdp` every rank extracts every image in step: rank 0's view
    # of what exists decides, and rank 0 alone writes.
    jobs = broadcast_object(
        filter_unprocessed(jobs, lambda j: storage.exists(j[0])))
    logger.info("task %d/%d: %d images", tid, ntasks, len(jobs))

    done = 0
    for sample_id, img_path, meta in jobs:
        try:
            image = np.array(Image.open(img_path).convert("RGB"))
            caption = meta.get("caption", "a photo of a salient object")
            tag = meta.get("tag", "object")
            features, cmaps = extractor.extract(image, caption, tag)
            if rank() == 0:
                storage.save(sample_id, features, cmaps)
            done += 1
        except Exception as e:  # noqa: BLE001 — one failed image never stops a run
            logger.error("failed %s: %s", sample_id, e)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--task_id", type=int, default=None)
    ap.add_argument("--num_tasks", type=int, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = run(args.config, args.task_id, args.num_tasks)
    print(f"extracted features for {n} images")
    return n


if __name__ == "__main__":
    main()
