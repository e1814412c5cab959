"""Teacher mask generation for synthetic images, in PyTorch (counterpart of
`s3od_tpu/datagen/mask_generator.py`).

Loads the FluxDPT teacher (`models/flux_teacher.py`), normalizes the image
on the device, runs the teacher with the FLUX transformer features and
concept maps from the diffusion backend, and returns the best-IoU mask.
bf16 on the card (the encoder's kernel route), float32 when the caller
asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from s3od_torch.models.flux_teacher import FluxTeacher
from s3od_torch.utils import compute_dtype_for, resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class MaskGenerator:
    def __init__(self, checkpoint_path: Optional[str] = None,
                 threshold: float = 0.5, dtype: Optional[str] = None,
                 device: Optional[str] = "cuda",
                 model: Optional[FluxTeacher] = None):
        """`checkpoint_path`: a teacher `.npz`; or pass `model`."""
        from s3od_torch.convert import load_teacher

        self.threshold = threshold
        self.device = resolve_device(device)
        self.dtype = compute_dtype_for(self.device, dtype)
        if model is None:
            model = load_teacher(checkpoint_path)
        self.model = model.to(self.device).eval()
        self.cfg = self.model.cfg
        self._mean = torch.tensor(IMAGENET_MEAN * 255.0, device=self.device)
        self._inv_std = torch.tensor(1.0 / (IMAGENET_STD * 255.0),
                                     device=self.device)

    @torch.inference_mode()
    def predict(self, image: np.ndarray, transformer_features: List[np.ndarray],
                concept_maps: Dict[str, np.ndarray]):
        """-> (sigmoid masks (n, H, W), sigmoid IoU scores (n,)) fp32 on
        the device."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        x = torch.as_tensor(np.asarray(image), device=self.device)[None]
        x = ((x.float() - self._mean) * self._inv_std).to(self.dtype)
        tf = [t(f[None] if f.ndim == 2 else f) for f in transformer_features]
        cm = {k: t(v[None] if v.ndim == 2 else v)
              for k, v in concept_maps.items()}
        out = self.model(x, tf, cm)
        return (torch.sigmoid(out["pred_masks"][0]),
                torch.sigmoid(out["pred_iou"][0]))

    def generate_mask(self, image: np.ndarray,
                      transformer_features: List[np.ndarray],
                      concept_maps: Dict[str, np.ndarray]) -> np.ndarray:
        """image uint8 (H, W, 3) at a bucket resolution -> uint8 mask."""
        masks, ious = self.predict(image, transformer_features, concept_maps)
        best = int(ious.argmax())
        return (masks[best] * 255).to(torch.uint8).cpu().numpy()


def create_mask_generator(checkpoint_path: str, **kwargs) -> MaskGenerator:
    return MaskGenerator(checkpoint_path, **kwargs)
