"""Teacher predictor: FLUX feature extraction + FluxDPT teacher inference,
in PyTorch (counterpart of `s3od_tpu/evaluation/teacher_predictor.py`).

Per image: bucket-resize, single-step img2img noise inversion through the
concept-attention pipeline (the last timestep of 50, concepts [tag,
'background']), features compressed 3072 -> 768, then the FluxDPT teacher
and the argmax-IoU mask, resized back with antialiasing. Features can
also come from precomputed `.npz` files (`predict_from_npz`).

The JAX `predict` hands the teacher the pipeline's features with their
batch axis ((1, 1, N, C)) and fails there; `_run_teacher` here drops that
axis, so `predict` runs (ROADMAP, Queue 3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from s3od_torch.datagen.resizer import FluxResizer
from s3od_torch.evaluation.predictor import PredictionResult
from s3od_torch.ops.resize import resize_bilinear_numpy


class SODTeacherPredictor:
    def __init__(self, checkpoint_path: str,
                 flux_checkpoint: Optional[str] = None,
                 vae_checkpoint: Optional[str] = None,
                 num_inference_steps: int = 28, dtype: Optional[str] = None,
                 fsdp: Optional[int] = None, device: str = "cuda",
                 text_encoders=None, mask_generator=None, pipeline=None,
                 vae=None):
        """The teacher on `device` (bf16 on the card, float32 on the CPU
        unless `dtype` says otherwise); the MMDiT and the VAE load at the
        first image. `text_encoders`: e.g. `TorchTextEncoders` (the card
        has no transformers). `mask_generator`, `pipeline` and `vae` take
        parts already built in place of the checkpoints."""
        from s3od_torch.datagen.mask_generator import MaskGenerator

        self.teacher = mask_generator or MaskGenerator(
            checkpoint_path, dtype=dtype, device=device)
        self.device, self.dtype = self.teacher.device, self.teacher.dtype
        self.cfg = self.teacher.cfg
        self.resizer = FluxResizer()
        self.num_steps = num_inference_steps
        self._fsdp = fsdp
        self._flux_checkpoint = flux_checkpoint
        self._vae_checkpoint = vae_checkpoint
        self._text_encoders = text_encoders
        self._pipeline = pipeline
        self._vae = vae

    @property
    def pipeline(self):
        if self._pipeline is None:
            from s3od_torch.datagen.diffusion import ConceptAttentionPipeline

            self._pipeline = ConceptAttentionPipeline.from_config(
                checkpoint=self._flux_checkpoint,
                num_inference_steps=self.num_steps, fsdp=self._fsdp,
                text_encoders=self._text_encoders, device=str(self.device))
        return self._pipeline

    @property
    def vae(self):
        if self._vae is None:
            from s3od_torch.models.vae import load_vae

            self._vae = load_vae(self._vae_checkpoint, device=str(self.device))
        return self._vae

    def extract_flux_features(self, image: np.ndarray, caption: str, tag: str):
        """Single-step inversion at the last timestep."""
        resized, (th, tw) = self.resizer.resize_image(image)
        latents = self.vae.encode(resized)
        out = self.pipeline.extract_features(latents, caption,
                                             [tag, "background"], th, tw)
        cmaps = {"category": out.concept_maps[tag],
                 "background": out.concept_maps["background"]}
        return resized, out.features, cmaps

    def _run_teacher(self, resized, features, cmaps, original_hw, threshold):
        masks, ious = self.teacher.predict(
            resized, [np.asarray(f, np.float32)[0] if np.ndim(f) == 3
                      else np.asarray(f, np.float32) for f in features],
            {k: np.asarray(v, np.float32) for k, v in cmaps.items()})
        masks = masks.float().cpu().numpy()
        ious = ious.float().cpu().numpy()
        masks = np.clip(resize_bilinear_numpy(masks, original_hw, antialias=True,
                                              h_axis=1, w_axis=2), 0.0, 1.0)
        best = int(ious.argmax())
        soft = masks[best]
        return PredictionResult(
            binary_mask=(soft > threshold).astype(np.float32), soft_mask=soft,
            all_masks=(masks > threshold).astype(np.float32), all_ious=ious)

    def predict(self, image: np.ndarray, caption: str = "",
                tag: str = "object", threshold: float = 0.5) -> PredictionResult:
        resized, features, cmaps = self.extract_flux_features(image, caption, tag)
        return self._run_teacher(resized, features, cmaps, image.shape[:2],
                                 threshold)

    def predict_from_npz(self, image: np.ndarray, npz_path: str,
                         threshold: float = 0.5) -> PredictionResult:
        """Precomputed features (the offline extraction's format:
        layer_0..layer_3, category, background)."""
        resized, _ = self.resizer.resize_image(image)
        with np.load(npz_path) as z:
            features = [z[f"layer_{i}"].astype(np.float32) for i in range(4)]
            cmaps = {"category": z["category"].astype(np.float32),
                     "background": z["background"].astype(np.float32)}
        return self._run_teacher(resized, features, cmaps, image.shape[:2],
                                 threshold)
