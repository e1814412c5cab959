"""Visualization helpers (the port's copy of `s3od_tpu/visualizer.py`, on
the port's `RemovalResult`).

Behavioral contract from the reference (`src/s3od/visualizer.py:8-48`):
`visualize_removal` blends the image over a solid color with the soft mask;
`visualize_all_masks` tiles every candidate mask composite into a grid of at
most 4 columns. Both implemented here as single vectorized numpy expressions
(one batched composite + a reshape-based tiling) rather than per-mask loops.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
from PIL import Image

from s3od_torch.predictor import RemovalResult

_MAX_GRID_COLS = 4


def _as_rgb_array(image: Union[np.ndarray, Image.Image]) -> np.ndarray:
    if isinstance(image, Image.Image):
        return np.asarray(image.convert("RGB"))
    return image


def _composite(image: np.ndarray, masks: np.ndarray,
               background: np.ndarray) -> np.ndarray:
    """Soft-blend `image` over `background` for a stack of masks.

    masks: (..., H, W) in [0, 1]; broadcasts over leading axes.
    """
    alpha = masks[..., None].astype(np.float32)
    return (alpha * image + (1.0 - alpha) * background).astype(np.uint8)


def visualize_removal(
    image: Union[np.ndarray, Image.Image],
    result: RemovalResult,
    background_color: Tuple[int, int, int] = (0, 255, 0),
) -> Image.Image:
    """Soft-mask composite of the image over a solid background color."""
    rgb = _as_rgb_array(image)
    bg = np.broadcast_to(
        np.asarray(background_color, dtype=np.uint8), rgb.shape
    )
    return Image.fromarray(_composite(rgb, result.predicted_mask, bg))


def visualize_all_masks(
    image: Union[np.ndarray, Image.Image],
    result: RemovalResult,
) -> Image.Image:
    """All candidate masks applied to the image, tiled on a grid
    (up to 4 per row; trailing cells stay black)."""
    rgb = _as_rgb_array(image)
    h, w = rgb.shape[:2]
    masks = np.asarray(result.all_masks)  # (N, H, W)
    n = masks.shape[0]
    cols = min(n, _MAX_GRID_COLS)
    rows = -(-n // cols)

    # One batched composite over black, padded to a full grid, then tiled
    # with a single reshape/transpose.
    tiles = _composite(rgb, masks, np.zeros_like(rgb))  # (N, H, W, 3)
    pad = rows * cols - n
    if pad:
        tiles = np.concatenate(
            [tiles, np.zeros((pad, h, w, 3), dtype=np.uint8)]
        )
    grid = (
        tiles.reshape(rows, cols, h, w, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rows * h, cols * w, 3)
    )
    return Image.fromarray(grid)
