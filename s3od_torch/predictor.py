"""Background-removal inference API on PyTorch (counterpart of
`s3od_tpu/predictor.py`).

Same contract as the JAX predictor: letterbox to a square canvas on the
host, upload uint8, normalize -> encoder -> DPT head -> sigmoid on the
device, then unpad, resize back with antialiasing, pick the mask with the
best IoU score and compose RGBA on the host. bf16 on CUDA by default
(through the hand-written kernels), float32 exact mode otherwise.

`RemovalResult` and the host resize helpers are carried over rather than
imported: `s3od_tpu.predictor` imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from s3od_torch.configs import SegmentationConfig
from s3od_tpu.utils import as_rgb_uint8, get_pad_info, place_on_canvas, remove_padding
from s3od_torch.convert import load_checkpoint, state_dict_from_jax
from s3od_torch.models.segmentation import S3ODSegmentation
from s3od_torch.ops.precision import default_dtype, set_exact_float32
from s3od_torch.ops.resize import resize_bilinear_numpy

# ImageNet statistics (reference `src/s3od/predictor.py:42-43`).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class RemovalResult:
    predicted_mask: np.ndarray
    all_masks: np.ndarray
    all_ious: np.ndarray
    rgba_image: Image.Image


def _resize_image(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC resize; cv2 INTER_LINEAR when available, else the matched
    numpy bilinear (the JAX predictor's rule)."""
    try:
        import cv2

        return cv2.resize(image, (out_hw[1], out_hw[0]))
    except ImportError:
        out = resize_bilinear_numpy(image.astype(np.float32), out_hw,
                                    h_axis=0, w_axis=1)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _masks_to_original(masks_nhw: np.ndarray,
                       out_hw: Tuple[int, int]) -> np.ndarray:
    """(n, h, w) soft masks -> (n, H, W) at the original size, clipped.
    Antialiasing changes only downscales, so upscales take cv2's bilinear
    when available; downscales keep the torch-matched triangle filter."""
    ih, iw = masks_nhw.shape[1:]
    oh, ow = out_hw
    if oh >= ih and ow >= iw:
        try:
            import cv2

            out = np.stack([cv2.resize(m, (ow, oh), interpolation=cv2.INTER_LINEAR)
                            for m in masks_nhw])
            return np.clip(out, 0.0, 1.0)
        except ImportError:
            pass
    return np.clip(resize_bilinear_numpy(masks_nhw, out_hw, antialias=True,
                                         h_axis=1, w_axis=2), 0.0, 1.0)


def _postprocess(image: np.ndarray, pad_info, masks_nc: np.ndarray,
                 ious: np.ndarray) -> RemovalResult:
    """Unpad -> resize to the original size -> argmax-IoU selection ->
    RGBA. `masks_nc`: (n, S, S) fp32 soft masks on the padded canvas."""
    all_masks = _masks_to_original(remove_padding(masks_nc, pad_info),
                                   pad_info["original_size"])
    best = int(ious.argmax())
    alpha = (all_masks[best] * 255).astype(np.uint8)
    return RemovalResult(
        predicted_mask=all_masks[best],
        all_masks=all_masks,
        all_ious=ious,
        rgba_image=Image.fromarray(np.dstack([image, alpha]), mode="RGBA"),
    )


class BackgroundRemoval:
    DEFAULT_CHECKPOINT_NAME = "s3od.pt"
    BATCH_CHUNK = 16

    def __init__(
        self,
        model_id: Optional[str] = None,
        image_size: int = 1024,
        device: str = "cuda",
        dtype: Optional[str] = None,
        fold_bn: bool = True,
        _model: Optional[S3ODSegmentation] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BackgroundRemoval(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the plain PyTorch path")
        if dtype is not None and dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.compute_dtype = (_DTYPES[dtype] if dtype is not None
                              else default_dtype(self.device))
        if self.compute_dtype == torch.float32:
            set_exact_float32()
        self.image_size = image_size
        if _model is None:
            if model_id is None:
                raise ValueError("model_id (a .pt / .npz path) is required")
            sd, cfg = load_checkpoint(self._resolve(model_id))
            _model = S3ODSegmentation(cfg)
            _model.load_state_dict(sd, strict=True)
        self.model = _model.prepare_serving_(self.compute_dtype, fold_bn)
        self.model.to(self.device)
        self.cfg = self.model.cfg
        self._mean = torch.tensor(IMAGENET_MEAN * 255.0, device=self.device)
        self._inv_std = torch.tensor(1.0 / (IMAGENET_STD * 255.0),
                                     device=self.device)

    @classmethod
    def from_pretrained(cls, model_id: str, **kwargs) -> "BackgroundRemoval":
        return cls(model_id=model_id, **kwargs)

    @classmethod
    def from_params(cls, params: dict, state: Optional[dict],
                    cfg: SegmentationConfig, **kwargs) -> "BackgroundRemoval":
        """From a JAX-layout param pytree (numpy leaves)."""
        model = S3ODSegmentation(cfg)
        model.load_state_dict(state_dict_from_jax(params, state), strict=True)
        return cls(_model=model, **kwargs)

    @classmethod
    def from_model(cls, model: S3ODSegmentation, **kwargs) -> "BackgroundRemoval":
        """From a constructed model (e.g. seeded random weights); the
        model is prepared in place."""
        return cls(_model=model, **kwargs)

    @classmethod
    def _resolve(cls, model_id: str) -> Path:
        path = Path(model_id)
        if path.is_dir():
            for name in (cls.DEFAULT_CHECKPOINT_NAME, "s3od.npz"):
                if (path / name).exists():
                    return path / name
            raise ValueError(f"No checkpoint found under {model_id}")
        if not path.exists():
            raise ValueError(
                f"{model_id} is not a local checkpoint; the port loads local "
                ".pt / .npz files only")
        return path

    def _preprocess(self, image: np.ndarray) -> Tuple[np.ndarray, Dict[str, Any]]:
        pad_info = get_pad_info(image, self.image_size)
        resized = _resize_image(image, pad_info["resized_size"])
        return place_on_canvas(resized, self.image_size, pad_info), pad_info

    @torch.inference_mode()
    def forward_canvases(self, canvases_u8: np.ndarray):
        """(B, S, S, 3) uint8 canvases -> (sigmoid masks (B, n, S, S) fp32,
        sigmoid IoU scores (B, n) fp32) as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(canvases_u8)).to(self.device)
        x = ((x.float() - self._mean) * self._inv_std).to(self.compute_dtype)
        out = self.model(x)
        masks = torch.sigmoid(out["pred_masks"])
        ious = torch.sigmoid(out["pred_iou"])
        return masks.float().cpu().numpy(), ious.cpu().numpy()

    def remove_background(self, image: Union[np.ndarray, Image.Image],
                          threshold: float = 0.5) -> RemovalResult:
        image = as_rgb_uint8(image)
        canvas, pad_info = self._preprocess(image)
        masks, ious = self.forward_canvases(canvas[None])
        return _postprocess(image, pad_info, masks[0], ious[0])

    def remove_background_batch(
        self, images: List[Union[np.ndarray, Image.Image]],
        threshold: float = 0.5, chunk: Optional[int] = None,
    ) -> List[RemovalResult]:
        """Batched inference: device steps over chunks of `chunk` images
        (default 16), host postprocess per image."""
        chunk = chunk or self.BATCH_CHUNK
        arrays = [as_rgb_uint8(im) for im in images]
        results: List[RemovalResult] = []
        for i in range(0, len(arrays), chunk):
            group = arrays[i: i + chunk]
            pre = [self._preprocess(a) for a in group]
            masks, ious = self.forward_canvases(np.stack([c for c, _ in pre]))
            results.extend(
                _postprocess(a, pi, masks[j], ious[j])
                for j, (a, (_, pi)) in enumerate(zip(group, pre)))
        return results
