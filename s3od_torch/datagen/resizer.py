"""Resolution bucketing for diffusion-compatible image sizes.

Maps arbitrary aspect ratios to the nearest of 11 ~1MP resolutions with both
sides divisible by 32 (FLUX's 16-stride VAE + 2x2 latent packing;
reference `data_generation/resizer.py:19-65`). Bucketing doubles as the
static-shape strategy for TPU jit: every generated/teacher-processed image
lands on one of 11 compiled shapes.

The port's own copy of `s3od_tpu/datagen/resizer.py` (which imports no
jax): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# (height, width), all % 32 == 0, ~1MP — the standard FLUX bucket list.
RESOLUTION_BUCKETS: List[Tuple[int, int]] = [
    (1024, 1024),
    (896, 1152), (1152, 896),
    (768, 1344), (1344, 768),
    (832, 1216), (1216, 832),
    (704, 1408), (1408, 704),
    (960, 1088), (1088, 960),
]


def select_bucket(height: int, width: int) -> Tuple[int, int]:
    """Nearest bucket by aspect-ratio distance."""
    aspect = width / height
    return min(RESOLUTION_BUCKETS, key=lambda hw: abs(aspect - hw[1] / hw[0]))


def is_compatible(height: int, width: int) -> bool:
    return height % 32 == 0 and width % 32 == 0


class FluxResizer:
    """Image/mask resizing onto the bucket grid (LANCZOS for images,
    NEAREST for masks — reference `resizer.py:85-121`)."""

    OPTIMAL_RESOLUTIONS = RESOLUTION_BUCKETS

    def select_best_resolution(self, h: int, w: int) -> Tuple[int, int]:
        return select_bucket(h, w)

    def resize_image(self, image: np.ndarray):
        th, tw = select_bucket(*image.shape[:2])
        try:
            import cv2

            out = cv2.resize(image, (tw, th), interpolation=cv2.INTER_LANCZOS4)
        except ImportError:  # pragma: no cover
            from PIL import Image

            out = np.array(Image.fromarray(image).resize((tw, th), Image.LANCZOS))
        return out, (th, tw)

    def resize_pil_image(self, image):
        from PIL import Image

        w, h = image.size
        th, tw = select_bucket(h, w)
        return image.resize((tw, th), Image.LANCZOS), (th, tw)

    def resize_mask(self, mask: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
        th, tw = target_hw
        if mask.ndim == 3 and mask.shape[2] == 1:
            mask = mask[:, :, 0]
        try:
            import cv2

            return cv2.resize(mask, (tw, th), interpolation=cv2.INTER_NEAREST)
        except ImportError:  # pragma: no cover
            from PIL import Image

            return np.array(Image.fromarray(mask).resize((tw, th), Image.NEAREST))

    def get_compatible_resolutions(self):
        return list(RESOLUTION_BUCKETS)

    @staticmethod
    def verify_compatibility(height: int, width: int) -> bool:
        return is_compatible(height, width)
