"""Filtering CLI: YAML-configured filter chain with sharding + resume
(counterpart of `s3od_tpu/datagen/run_filtering.py`).

Reference (`data_generation/run_filtering.py` + `filtering_config.yaml`):
3-filter chain flip_consistency -> semantic_quality -> mask_artifacts over a
class-organized dataset, SLURM-array sharded, resumable by scanning outputs,
per-class caps.

Usage:
    python -m s3od_torch.datagen.run_filtering --config filtering.yaml \
        [--task_id N --num_tasks M]

The registry keys are the JAX package's and name the port's filters; a
`type` may also be any `module:Class`. Filters take their config keys as
arguments (`device`, "cuda" by default, for the model-backed ones).
Example config: `s3od_torch/datagen/configs/filtering.yaml`.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List

import yaml

from s3od_torch.datagen.filtering import BaseFilter, DatasetLoader, FilterPipeline
from s3od_torch.datagen.sharding import detect_task, filter_unprocessed, task_slice

FILTER_REGISTRY: Dict[str, str] = {
    "flip_consistency": "s3od_torch.datagen.filters.consistency:HorizontalFlipConsistencyFilter",
    "semantic_quality": "s3od_torch.datagen.filters.vlm:GemmaSemanticFilter",
    "mask_artifacts": "s3od_torch.datagen.filters.vlm:GemmaMaskArtifactFilter",
}


def build_filter(spec: Dict) -> BaseFilter:
    """spec: {type: registry key or module:Class, **kwargs}."""
    kind = spec["type"]
    target = FILTER_REGISTRY.get(kind, kind)
    module, _, cls_name = target.partition(":")
    import importlib

    cls = getattr(importlib.import_module(module), cls_name)
    kwargs = {k: v for k, v in spec.items() if k != "type"}
    return cls(**kwargs)


def main(argv: List[str] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--task_id", type=int, default=None)
    ap.add_argument("--num_tasks", type=int, default=None)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = yaml.safe_load(Path(args.config).read_text())

    filters = [build_filter(s) for s in cfg["filters"]]
    pipeline = FilterPipeline(
        filters,
        output_dir=cfg["output_dir"],
        failed_dir=cfg.get("failed_dir"),
        max_per_class=cfg.get("max_per_class"),
    )

    samples = DatasetLoader(cfg["input_dir"]).load_samples()
    task_id, num_tasks = detect_task(args.task_id, args.num_tasks)
    samples = task_slice(samples, task_id, num_tasks)
    samples = filter_unprocessed(samples, pipeline.is_done)
    logging.info(
        "task %d/%d: %d samples to process", task_id, num_tasks, len(samples)
    )
    stats = pipeline.run(samples)
    logging.info("done: %s", stats)
    return stats


if __name__ == "__main__":
    main()
