"""Dataset filtering framework for the synthetic-data factory (the port's
own copy of `s3od_tpu/datagen/filtering.py`, which imports no jax).

Reference design (`data_generation/filter_dataset.py`): Sample/FilterResult
dataclasses, a short-circuiting chain of filters over class-organized
image/mask pairs, flat `class_sampleid.jpg/png` output copies, failed-case
visualization panels and per-class statistics.

Filters declare `batch_size`; the pipeline feeds them BATCHES so
model-backed filters (flip consistency) run one device forward over many
samples; the reference runs 2 sequential forwards per sample.
Short-circuit semantics are preserved at sample granularity.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shutil
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Sample:
    image_path: Path
    mask_path: Path
    class_name: str
    sample_id: str

    def load_image(self) -> np.ndarray:
        from PIL import Image

        return np.array(Image.open(self.image_path).convert("RGB"))

    def load_mask(self) -> np.ndarray:
        from PIL import Image

        return np.array(Image.open(self.mask_path).convert("L"))


@dataclasses.dataclass
class FilterResult:
    passed: bool
    reason: Optional[str] = None
    score: Optional[float] = None
    metadata: Optional[Dict[str, Any]] = None


def calculate_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    m1 = mask1 > 0.5
    m2 = mask2 > 0.5
    union = np.logical_or(m1, m2).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(m1, m2).sum() / union)


class BaseFilter(ABC):
    """A filter judges samples; `batch_size > 1` enables batched judging."""

    batch_size: int = 1

    def __init__(self, name: str):
        self.name = name
        self.stats = {"total": 0, "passed": 0, "failed": 0}

    @abstractmethod
    def filter(self, sample: Sample) -> FilterResult:
        ...

    def filter_batch(self, samples: Sequence[Sample]) -> List[FilterResult]:
        return [self.filter(s) for s in samples]

    def record(self, results: Sequence[FilterResult]) -> None:
        for r in results:
            self.stats["total"] += 1
            self.stats["passed" if r.passed else "failed"] += 1

    @property
    def pass_rate(self) -> float:
        return self.stats["passed"] / self.stats["total"] if self.stats["total"] else 0.0


class DatasetLoader:
    """Class-per-directory dataset scan: `{root}/{class}/images|masks/*`."""

    def __init__(self, dataset_path: str):
        self.root = Path(dataset_path)

    def load_samples(self) -> List[Sample]:
        samples = []
        for class_dir in sorted(self.root.iterdir()):
            if not class_dir.is_dir():
                continue
            images, masks = class_dir / "images", class_dir / "masks"
            if not (images.is_dir() and masks.is_dir()):
                logging.warning("skipping %s: missing images/ or masks/", class_dir)
                continue
            for img in sorted(images.glob("*.jpg")):
                mask = masks / f"{img.stem}.png"
                if mask.exists():
                    samples.append(Sample(img, mask, class_dir.name, img.stem))
                else:
                    logging.warning("missing mask for %s", img)
        logging.info(
            "loaded %d samples from %d classes",
            len(samples), len({s.class_name for s in samples}),
        )
        return samples


class FilterPipeline:
    """Short-circuit chain with batched execution and flat output copying."""

    def __init__(
        self,
        filters: Sequence[BaseFilter],
        output_dir: Optional[str] = None,
        failed_dir: Optional[str] = None,
        max_per_class: Optional[int] = None,
    ):
        self.filters = list(filters)
        self.output_dir = Path(output_dir) if output_dir else None
        self.failed_dir = Path(failed_dir) if failed_dir else None
        self.max_per_class = max_per_class
        self.per_class_kept: Dict[str, int] = {}

    def output_paths(self, sample: Sample):
        stem = f"{sample.class_name}_{sample.sample_id}"
        return (
            self.output_dir / "images" / f"{stem}.jpg",
            self.output_dir / "masks" / f"{stem}.png",
        )

    def is_done(self, sample: Sample) -> bool:
        if self.output_dir is None:
            return False
        img, mask = self.output_paths(sample)
        return img.exists() and mask.exists()

    def _accept(self, sample: Sample) -> None:
        if self.output_dir is None:
            return
        img_out, mask_out = self.output_paths(sample)
        img_out.parent.mkdir(parents=True, exist_ok=True)
        mask_out.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(sample.image_path, img_out)
        shutil.copy(sample.mask_path, mask_out)

    def _reject(self, sample: Sample, filt: BaseFilter, result: FilterResult) -> None:
        if self.failed_dir is None:
            return
        panel = self._failure_panel(sample, filt, result)
        out = self.failed_dir / filt.name
        out.mkdir(parents=True, exist_ok=True)
        from PIL import Image

        Image.fromarray(panel).save(
            out / f"{sample.class_name}_{sample.sample_id}.jpg", quality=90
        )

    @staticmethod
    def _failure_panel(sample: Sample, filt: BaseFilter, result: FilterResult):
        """[image | red mask overlay] panel with a text header."""
        img = sample.load_image()
        mask = sample.load_mask() > 127
        overlay = img.copy()
        overlay[mask] = (
            0.5 * overlay[mask] + 0.5 * np.array([255, 0, 0])
        ).astype(np.uint8)
        panel = np.concatenate([img, overlay], axis=1)
        header = np.full((28, panel.shape[1], 3), 255, np.uint8)
        panel = np.concatenate([header, panel], axis=0)
        try:
            import cv2

            text = f"{filt.name}: {result.reason or ''} score={result.score}"
            cv2.putText(panel, text[:90], (4, 20), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (0, 0, 0), 1)
        except ImportError:  # pragma: no cover
            pass
        return panel

    def run(self, samples: Sequence[Sample], progress: bool = True) -> Dict:
        """Run the chain; returns summary stats."""
        alive: List[Sample] = []
        for s in samples:
            cap = self.max_per_class
            if cap is not None and self.per_class_kept.get(s.class_name, 0) >= cap:
                continue
            alive.append(s)

        rejected: Dict[str, int] = {}
        for filt in self.filters:
            next_alive: List[Sample] = []
            bs = max(1, filt.batch_size)
            it = range(0, len(alive), bs)
            if progress:
                try:
                    from tqdm import tqdm

                    it = tqdm(it, desc=f"filter {filt.name}")
                except ImportError:
                    pass
            for b0 in it:
                chunk = alive[b0 : b0 + bs]
                results = filt.filter_batch(chunk)
                filt.record(results)
                for s, r in zip(chunk, results):
                    if r.passed:
                        next_alive.append(s)
                    else:
                        rejected[filt.name] = rejected.get(filt.name, 0) + 1
                        self._reject(s, filt, r)
            alive = next_alive

        kept = 0
        for s in alive:
            cap = self.max_per_class
            n = self.per_class_kept.get(s.class_name, 0)
            if cap is not None and n >= cap:
                continue
            self._accept(s)
            self.per_class_kept[s.class_name] = n + 1
            kept += 1

        stats = {
            "input": len(samples),
            "kept": kept,
            "rejected": rejected,
            "pass_rates": {f.name: f.pass_rate for f in self.filters},
        }
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            (self.output_dir / "filter_stats.json").write_text(
                json.dumps(stats, indent=2)
            )
        return stats
