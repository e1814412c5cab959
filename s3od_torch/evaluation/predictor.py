"""Research predictor on PyTorch (counterpart of
`s3od_tpu/evaluation/predictor.py`).

Same contract: letterbox to a square canvas (840 by default), normalize,
forward, sigmoid, unpad, antialiased resize to the original size; a
`PredictionResult` whose `all_masks` are BINARY, unlike the product
predictor's soft masks. A canvas that is not a patch multiple is cropped
to one by the encoder (840 -> 52 patches, 832 pixels), as in the JAX
package. At a 2048 canvas this is the DIS5K high-res path.

The model, its load and prepare step, the letterbox and the device
forward are those of `s3od_torch.predictor.BackgroundRemoval`, which this
class wraps.

    pred = SODPredictor("ckpt.npz", image_size=2048, device="cuda")
    res = pred.predict(image)          # res.soft_mask, res.binary_mask
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from s3od_torch.configs import SegmentationConfig
from s3od_torch.predictor import BackgroundRemoval, _masks_to_original
from s3od_torch.utils import as_rgb_uint8, remove_padding


@dataclass
class PredictionResult:
    binary_mask: np.ndarray
    soft_mask: np.ndarray
    all_masks: Optional[np.ndarray] = None
    all_ious: Optional[np.ndarray] = None

    @property
    def has_multiple_masks(self) -> bool:
        return self.all_masks is not None

    @property
    def num_masks(self) -> int:
        return 0 if self.all_masks is None else len(self.all_masks)


class SODPredictor:
    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        image_size: int = 840,
        device: str = "cuda",
        dtype: Optional[str] = None,
        _predictor: Optional[BackgroundRemoval] = None,
    ):
        """`checkpoint_path`: a local .pt or .npz. `device` and `dtype` as
        for `BackgroundRemoval` (bf16 through the kernels on CUDA, float32
        exact mode on the CPU by default)."""
        self.image_size = image_size
        self.predictor = _predictor or BackgroundRemoval(
            checkpoint_path, image_size=image_size, device=device, dtype=dtype)
        self.cfg = self.predictor.cfg
        self.compute_dtype = self.predictor.compute_dtype

    @classmethod
    def from_params(cls, params, state, cfg: SegmentationConfig,
                    image_size: int = 840, **kwargs) -> "SODPredictor":
        """From a JAX-layout param tree (numpy leaves)."""
        return cls(image_size=image_size, _predictor=BackgroundRemoval.from_params(
            params, state, cfg, image_size=image_size, **kwargs))

    def _letterbox(self, image):
        return self.predictor._preprocess(as_rgb_uint8(image))

    def _postprocess(self, masks, ious, pad_info, threshold):
        resized = _masks_to_original(remove_padding(masks, pad_info),
                                     pad_info["original_size"])
        if resized.shape[0] == 1:
            soft = resized[0]
            return PredictionResult(
                binary_mask=(soft > threshold).astype(np.float32),
                soft_mask=soft)
        soft = resized[int(ious.argmax())]
        return PredictionResult(
            binary_mask=(soft > threshold).astype(np.float32),
            soft_mask=soft,
            all_masks=(resized > threshold).astype(np.float32),
            all_ious=ious,
        )

    def predict(self, image, threshold: float = 0.5) -> PredictionResult:
        return self.predict_batch([image], threshold)[0]

    def predict_batch(self, images: Sequence, threshold: float = 0.5
                      ) -> List[PredictionResult]:
        """One device step over all `images`."""
        pre = [self._letterbox(im) for im in images]
        masks, ious = self.predictor.forward_canvases(
            np.stack([c for c, _ in pre]))
        return [self._postprocess(m, i, info, threshold)
                for m, i, (_, info) in zip(masks, ious, pre)]
