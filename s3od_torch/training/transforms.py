"""Augmentation mode facade (counterpart of `s3od_tpu/training/transforms.py`).

The reference exposes `get_transforms(image_size, mode)` building one of
three albumentations pipelines (`model_training/transforms.py:12-224`:
test / regular / synthetic). Training splits that work: the loader
letterboxes and draws the geometry on the host (`training/data.py`), and
everything else runs batched on the device (`s3od_torch/ops/augment.py`).

`get_transforms` returns a single-sample CPU callable with the reference
pipeline's contract (dict in, dict out) for code that wants one sample at
a time (e.g. debugging); it runs the device pipeline, geometry included,
on a batch of one.
"""

from __future__ import annotations

import enum
from typing import Dict

import numpy as np
import torch

from s3od_torch.ops.augment import augment_batch, normalize_imagenet
from s3od_torch.training.data import letterbox


class TransformMode(str, enum.Enum):
    REGULAR = "regular"
    TEST = "test"
    SYNTHETIC = "synthetic"


def get_transforms(image_size: int, mode: str = "regular"):
    """Returns callable(image=, mask=) -> {'image': float32 normalized
    (S,S,3), 'mask': float32 (S,S)}. Draws come from a CPU
    `torch.Generator` seeded from numpy's global stream, as the JAX
    facade seeds its key."""
    mode = TransformMode(mode).value
    gen = torch.Generator().manual_seed(int(np.random.randint(0, 2**31 - 1)))

    def apply(image: np.ndarray, mask: np.ndarray = None) -> Dict[str, np.ndarray]:
        img_l, mask_l = letterbox(
            image, mask if mask is not None else np.zeros(image.shape[:2], np.uint8),
            image_size,
        )
        m = mask_l.astype(np.float32)[None] / (
            255.0 if mask_l.dtype == np.uint8 else 1.0)
        x, m = augment_batch(torch.from_numpy(img_l[None]), torch.from_numpy(m),
                             mode, gen)
        out = {"image": normalize_imagenet(x)[0].numpy().astype(np.float32)}
        if mask is not None:
            out["mask"] = m[0].numpy().astype(np.float32)
        return out

    return apply
