"""TensorBoard image panels for training visualization (the port's copy of
`s3od_tpu/training/image_logger.py`).

Reference (`model_training/lightning_module.py:16-144` ImageLogger):
side-by-side panels of [denormalized input | each predicted mask with a
green border on the argmax-IoU one | GT mask | optional plasma-colormapped
concept maps], capped at `max_images` per epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _denormalize(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalized float (H,W,3) -> uint8."""
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _to_rgb(mask: np.ndarray) -> np.ndarray:
    m = np.clip(mask, 0, 1)
    return np.stack([(m * 255).astype(np.uint8)] * 3, axis=-1)


def _green_border(img: np.ndarray, width: int = 6) -> np.ndarray:
    out = img.copy()
    out[:width] = out[-width:] = (0, 255, 0)
    out[:, :width] = out[:, -width:] = (0, 255, 0)
    return out


def _plasma(m: np.ndarray) -> np.ndarray:
    """Cheap plasma-like colormap without matplotlib."""
    m = np.clip(m, 0, 1)
    r = np.clip(2.1 * m - 0.1, 0, 1)
    g = np.clip(1.5 * np.abs(m - 0.55) * -1 + 0.9, 0, 1) * m
    b = np.clip(1.2 - 1.5 * m, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def make_panel(
    image_norm: np.ndarray,          # (H, W, 3) normalized float
    pred_masks: np.ndarray,          # (N, H, W) sigmoid probabilities
    pred_ious: np.ndarray,           # (N,)
    gt_mask: np.ndarray,             # (H, W)
    concept_maps: Optional[Dict[str, np.ndarray]] = None,
) -> np.ndarray:
    """One HWC uint8 panel row."""
    tiles: List[np.ndarray] = [_denormalize(image_norm)]
    best = int(np.argmax(pred_ious))
    for i, m in enumerate(pred_masks):
        tile = _to_rgb(m)
        if i == best:
            tile = _green_border(tile)
        tiles.append(tile)
    tiles.append(_to_rgb(gt_mask))
    if concept_maps:
        h, w = gt_mask.shape
        for cm in concept_maps.values():
            cm_big = np.kron(
                np.asarray(cm, np.float64),
                np.ones((h // cm.shape[0], w // cm.shape[1])),
            )[:h, :w]
            tiles.append(_plasma(cm_big))
    return np.concatenate(tiles, axis=1)


class ImageLogger:
    """Collects up to `max_images` panels per epoch and writes them to a
    TensorBoard SummaryWriter."""

    def __init__(self, max_images: int = 8):
        self.max_images = max_images
        self.panels: List[np.ndarray] = []

    def maybe_add(self, images_norm, pred_masks, pred_ious, gt_masks,
                  concept_maps=None) -> None:
        for b in range(len(images_norm)):
            if len(self.panels) >= self.max_images:
                return
            self.panels.append(
                make_panel(
                    np.asarray(images_norm[b]),
                    np.asarray(pred_masks[b]),
                    np.asarray(pred_ious[b]),
                    np.asarray(gt_masks[b]),
                    concept_maps,
                )
            )

    def flush(self, writer, split: str, epoch: int) -> None:
        for i, panel in enumerate(self.panels):
            writer.add_image(
                f"{split}_images/epoch_{epoch}_img_{i}", panel, epoch,
                dataformats="HWC",
            )
        self.panels.clear()
