"""Letterbox math and input normalization (the port's own copy of
`s3od_tpu/utils.py`; reference `src/s3od/utils.py:6-37`), shared by every
predictor surface of the port."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def as_rgb_uint8(image) -> np.ndarray:
    """Normalize any accepted input to (H, W, 3) uint8.

    Accepts PIL images (any mode), grayscale 2D / (H, W, 1), RGBA (alpha
    dropped, as PIL ``convert("RGB")`` does in the reference), bool masks,
    uint16 (rescaled from the 16-bit range), other integer arrays (clipped
    to 0-255), and float arrays — floats with max <= 1.0 are treated as
    normalized 0-1 (the common convention; a uniformly-dark float image
    already on the 0-255 scale is indistinguishable and lands here too).
    """
    from PIL import Image

    if isinstance(image, Image.Image):
        return np.array(image.convert("RGB"))
    a = np.asarray(image)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    elif a.ndim == 3 and a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    elif a.ndim == 3 and a.shape[-1] == 4:
        a = a[..., :3]
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(
            f"expected an RGB/grayscale/RGBA image, got shape {a.shape}"
        )
    if a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"image has a zero-sized dimension: {a.shape}")
    if a.dtype != np.uint8:
        if a.dtype == np.bool_:
            a = a.astype(np.uint8) * 255
        elif a.dtype == np.uint16:
            a = (a >> 8).astype(np.uint8)
        elif np.issubdtype(a.dtype, np.integer):
            a = np.clip(a, 0, 255).astype(np.uint8)
        else:
            af = a.astype(np.float32)
            if af.size and float(af.max()) <= 1.0:
                af = af * 255.0
            a = np.clip(af, 0.0, 255.0).astype(np.uint8)
    return a


def place_on_canvas(resized: np.ndarray, image_size: int,
                    pad_info: Dict[str, Any]) -> np.ndarray:
    """Center the resized image on a square zero canvas.

    Exact-size placement: the reference's symmetric `padded[hp:-hp] =`
    slice (`src/s3od/predictor.py:85-87`) crashes when canvas - new_size
    is odd, and a `canvas = resized` shortcut is wrong when both pads are
    0 but the resized image is one pixel short of square."""
    canvas = np.zeros((image_size, image_size, 3), dtype=np.uint8)
    hp, wp = pad_info["height_pad"], pad_info["width_pad"]
    canvas[hp : hp + resized.shape[0], wp : wp + resized.shape[1]] = resized
    return canvas


def get_pad_info(image: np.ndarray, image_size: int = 1024) -> Dict[str, Any]:
    """Compute resize + center-pad geometry for a square canvas.

    Longest side maps to `image_size`; the short side is scaled to preserve
    aspect ratio and centered with equal (floor-divided) padding.
    """
    h, w = image.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"image has a zero-sized dimension: {image.shape}")
    aspect_ratio = w / h
    if aspect_ratio > 1:
        new_w = image_size
        # max(1, ...): extreme aspect ratios (e.g. 1 x 5000) would otherwise
        # round the short side to 0 and crash the resize downstream.
        new_h = max(1, int(new_w / aspect_ratio))
        return {
            "height_pad": (image_size - new_h) // 2,
            "width_pad": 0,
            "original_size": (h, w),
            "resized_size": (new_h, new_w),
        }
    new_h = image_size
    new_w = max(1, int(new_h * aspect_ratio))
    return {
        "height_pad": 0,
        "width_pad": (image_size - new_w) // 2,
        "original_size": (h, w),
        "resized_size": (new_h, new_w),
    }


def remove_padding(masks: np.ndarray, pad_info: Dict[str, Any]) -> np.ndarray:
    """masks: (N, H, W). Crop the letterbox padding back out.

    Exact-size crop (the reference's symmetric `[pad:-pad]` slice,
    `src/s3od/utils.py:32-37`, is identical for even padding and
    off-by-one — paired with a crash upstream — for odd padding)."""
    hp, wp = pad_info["height_pad"], pad_info["width_pad"]
    nh, nw = pad_info["resized_size"]
    # Always slice to resized_size: a near-square input can have pad 0 on an
    # axis whose resized extent is still one pixel short of the canvas, and
    # skipping the crop there leaves a zero row/column that misaligns the
    # mask when resized back to the original size.
    return masks[:, hp : hp + nh, wp : wp + nw]


def resolve_device(device=None):
    """`device` (default "cuda") as a torch.device; a CUDA device without a
    card raises rather than falling back to the CPU."""
    import torch

    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def compute_dtype_for(device, name=None):
    """"bfloat16" / "float32" as a torch dtype; None -> bf16 on CUDA and
    float32 elsewhere (`ops.precision.default_dtype`)."""
    import torch

    from s3od_torch.ops.precision import default_dtype

    if name is None:
        return default_dtype(torch.device(device))
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
