"""Flip-consistency filter: validate generated masks with the student model
(counterpart of `s3od_tpu/datagen/filters/consistency.py`).

Reference (`data_generation/filters/consistency_filter.py:49-95`): pass iff
IoU(pred, generated) >= 0.7 for both the original and h-flipped image, and
IoU(pred_orig, pred_flip) >= 0.8.

Batched: a chunk of B samples becomes ONE forward of 2B letterboxed images
(originals + flips) through the port's `SODPredictor` on the card (bf16
through K1-K5); the reference runs 2 sequential single-image forwards per
sample. The predictor is on `device` ("cuda" by default; float32 on the
CPU), with no fallback to the CPU.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

from s3od_torch.datagen.filtering import (
    BaseFilter,
    FilterResult,
    Sample,
    calculate_iou,
)


class HorizontalFlipConsistencyFilter(BaseFilter):
    batch_size = 8

    def __init__(
        self,
        model_path: str,
        name: str = "horizontal_flip_consistency",
        threshold: float = 0.7,
        consistency_threshold: float = 0.8,
        image_size: int = 840,
        batch_size: int = 8,
        device: str = "cuda",
    ):
        super().__init__(name)
        self.threshold = threshold
        self.consistency_threshold = consistency_threshold
        self.model_path = model_path
        self.image_size = image_size
        self.batch_size = batch_size
        self.device = device
        self._predictor = None

    @property
    def predictor(self):
        if self._predictor is None:
            from s3od_torch.evaluation.predictor import SODPredictor

            self._predictor = SODPredictor(
                self.model_path, image_size=self.image_size,
                device=self.device)
            logging.info("loaded consistency model from %s", self.model_path)
        return self._predictor

    def _judge(self, pred_orig, pred_flip, generated) -> FilterResult:
        iou_og = calculate_iou(pred_orig, generated)
        iou_fg = calculate_iou(pred_flip, generated)
        iou_of = calculate_iou(pred_orig, pred_flip)
        passed = (
            iou_og >= self.threshold
            and iou_fg >= self.threshold
            and iou_of >= self.consistency_threshold
        )
        return FilterResult(
            passed=passed,
            reason=None if passed else "flip inconsistency",
            score=(iou_og + iou_fg) / 2,
            metadata={
                "iou_orig_generated": iou_og,
                "iou_flipped_generated": iou_fg,
                "iou_orig_flipped": iou_of,
            },
        )

    def filter(self, sample: Sample) -> FilterResult:
        return self.filter_batch([sample])[0]

    def filter_batch(self, samples: Sequence[Sample]) -> List[FilterResult]:
        images = [s.load_image() for s in samples]
        gens = [s.load_mask() / 255.0 for s in samples]
        batch = images + [im[:, ::-1] for im in images]
        results = self.predictor.predict_batch(batch)
        n = len(samples)
        return [self._judge(results[i].binary_mask,
                            results[n + i].binary_mask[:, ::-1], gens[i])
                for i in range(n)]
