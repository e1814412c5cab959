"""Plain reference of one background-removal request, from the original
image to everything the API returns: letterbox onto the square canvas
(longest side to the canvas, the short side scaled with the aspect kept,
truncated, and centred with the floor of half the padding), ImageNet
normalization, the model (`model.segmentation`), sigmoid masks and IoU
scores, the padding cropped away, each mask resized back to the original
size (bilinear, with the antialiasing triangle filter on downscales) and
clipped to [0, 1], and the best-scored mask as the RGBA alpha.

Float32 on the device it is given; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import model as ref_model

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def letterbox_geometry(h: int, w: int, canvas: int) -> Tuple[int, int, int, int]:
    """(new_h, new_w, top, left) of an (h, w) image on the canvas."""
    if w > h:
        nw, nh = canvas, max(1, int(canvas / (w / h)))
    else:
        nh, nw = canvas, max(1, int(canvas * (w / h)))
    return nh, nw, (canvas - nh) // 2, (canvas - nw) // 2


def letterbox(image: np.ndarray, canvas: int, device) -> Tuple[torch.Tensor, tuple]:
    """uint8 (H, W, 3) -> the normalized fp32 canvas (1, S, S, 3) and its
    geometry. The resize is bilinear on pixel centres, without
    antialiasing, rounded to uint8 (the serving contract's host resize)."""
    h, w = image.shape[:2]
    nh, nw, top, left = letterbox_geometry(h, w, canvas)
    x = torch.from_numpy(image).to(device).permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    x = x.round().clamp(0, 255)
    out = torch.zeros((1, 3, canvas, canvas), device=device)
    out[:, :, top: top + nh, left: left + nw] = x
    mean = torch.tensor(MEAN, device=device)[:, None, None]
    std = torch.tensor(STD, device=device)[:, None, None]
    out = (out / 255.0 - mean) / std
    return out.permute(0, 2, 3, 1), (h, w, nh, nw, top, left)


def to_original(masks: torch.Tensor, geom: tuple) -> torch.Tensor:
    """(n, S, S) masks on the canvas -> (n, H, W) at the original size."""
    h, w, nh, nw, top, left = geom
    m = masks[:, top: top + nh, left: left + nw][None]
    m = F.interpolate(m, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return m[0].clamp(0.0, 1.0)


@torch.no_grad()
def request(image: np.ndarray, sd, cfg: dict, canvas: int, device,
            nm: ref_model.Numerics = ref_model.PLAIN,
            chunk_elems: int = 1 << 28) -> Dict[str, torch.Tensor]:
    """One request: {"masks": (n, H, W) fp32 at the original size, "ious":
    (n,) sigmoid scores, "canvas_masks": (n, S, S) sigmoid masks on the
    canvas}, on `device`."""
    x, geom = letterbox(image, canvas, device)
    logits, iou = ref_model.segmentation(x, sd, cfg, nm=nm,
                                         chunk_elems=chunk_elems)
    canvas_masks = torch.sigmoid(logits[0])
    return {"masks": to_original(canvas_masks, geom),
            "ious": torch.sigmoid(iou[0]), "canvas_masks": canvas_masks}

