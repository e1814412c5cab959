"""Synthetic training-image generation orchestrator, in PyTorch
(counterpart of `s3od_tpu/datagen/generate_train_images.py`).

Per-class loop: load/generate prompts, sample a bucket resolution,
generate an image with the diffusion backend (the port's MMDiT with
concept attention, on the card), pseudo-label it with the FluxDPT
teacher, save jpg (q95) + mask png; sharded by task; resumable by skipping
existing files; one failed sample never stops a run; class weights from
mining results scale the per-class counts.

The YAML fields and the CLI are the JAX package's. Three optional fields
are the port's own: `t5_checkpoint` and `clip_checkpoint` (converted
`.npz` trees) select the on-device text encoders, without which the
encoders come from transformers, loaded at the first prompt (the card has
none); `device` ("cuda" by default, "cpu" for the plain path).

With `fsdp` set, the MMDiT is sharded over the process group (launch with
`torchrun`): every rank runs every sample in step, rank 0's view of which
outputs and prompts exist decides what is skipped and prompted, and
only rank 0 writes.

Usage:
    python -m s3od_torch.datagen.generate_train_images --config generation.yaml
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import random
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np
import yaml

from s3od_torch.datagen.prompts import FilePromptProvider, ImagePromptGenerator
from s3od_torch.datagen.sharding import detect_task, task_slice
from s3od_torch.parallel.distributed import broadcast_object, rank

# Generation samples from a gentler-aspect list than the resizer's
# feature-extraction buckets ((width, height) pairs).
GENERATION_RESOLUTIONS = [
    (1024, 1024),
    (896, 1024), (1024, 896),
    (832, 1024), (1024, 832),
    (1024, 768), (768, 1024),
    (960, 1024), (1024, 960),
    (1088, 1024), (1024, 1088),
]

logger = logging.getLogger("s3od_torch.datagen")


@dataclasses.dataclass
class GenerationConfig:
    output_dir: str
    prompts_dir: str
    teacher_checkpoint: Optional[str] = None
    class_list: Optional[str] = None  # JSON: {index: name} or [names]
    prompts_per_class: int = 20
    num_inference_steps: int = 28
    class_weights_file: Optional[str] = None  # mine_samples results JSON
    backend: str = "diffusion"  # diffusion | procedural
    seed: int = 42
    flux_checkpoint: Optional[str] = None
    vae_checkpoint: Optional[str] = None
    lora: Optional[str] = None
    lora_scale: Optional[float] = None
    fsdp: Optional[int] = None
    # The port's own: converted encoder trees for the on-device encoders,
    # and the device (no silent fallback to the CPU).
    t5_checkpoint: Optional[str] = None
    clip_checkpoint: Optional[str] = None
    device: str = "cuda"

    @classmethod
    def from_yaml(cls, path: str) -> "GenerationConfig":
        data = yaml.safe_load(Path(path).read_text())
        return cls(**{k: v for k, v in data.items() if k in {
            f.name for f in dataclasses.fields(cls)}})


class ImageBackend(Protocol):
    def generate(
        self, prompt: str, concept: str, height: int, width: int, seed: int
    ) -> Tuple[np.ndarray, List[np.ndarray], Dict[str, np.ndarray]]:
        """-> (image uint8 HWC, transformer_features, concept_maps)."""


class ProceduralBackend:
    """Offline test backend: draws a random blob 'object' so the whole
    factory (prompts -> generate -> teacher -> save) runs without diffusion
    weights. The concept map marks the blob."""

    def generate(self, prompt, concept, height, width, seed):
        rng = np.random.default_rng(seed)
        img = rng.integers(100, 200, (height, width, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:height, 0:width]
        cy, cx = rng.integers(height // 4, 3 * height // 4), rng.integers(
            width // 4, 3 * width // 4)
        r = min(height, width) // rng.integers(4, 8)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
        img[blob] = rng.integers(0, 255, 3)
        ph, pw = height // 16, width // 16
        feats = [rng.standard_normal((ph * pw, 768)).astype(np.float32)
                 for _ in range(4)]
        small_blob = blob[::16, ::16].astype(np.float32)
        return img, feats, {"category": small_blob,
                            "background": 1.0 - small_blob}


def make_backend(cfg: GenerationConfig) -> ImageBackend:
    if cfg.backend == "procedural":
        return ProceduralBackend()
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline

    text_encoders = None
    if cfg.t5_checkpoint and cfg.clip_checkpoint:
        from s3od_torch.datagen.text_encoding import TorchTextEncoders

        text_encoders = TorchTextEncoders.from_npz(
            cfg.t5_checkpoint, cfg.clip_checkpoint, device=cfg.device)
    pipeline = ConceptAttentionPipeline.from_config(
        checkpoint=cfg.flux_checkpoint,
        num_inference_steps=cfg.num_inference_steps,
        lora=cfg.lora, lora_scale=cfg.lora_scale, fsdp=cfg.fsdp,
        text_encoders=text_encoders, device=cfg.device)
    if cfg.vae_checkpoint:
        # Pixels need the VAE decoder (pipeline.generate raises without).
        from s3od_torch.models.vae import load_vae

        pipeline.vae = load_vae(cfg.vae_checkpoint, device=cfg.device)
    return pipeline


VENDORED_CLASS_LIST = Path(__file__).parent / "data" / "imagenet_classes.json"


def load_class_list(path: Optional[str]) -> Dict[str, str]:
    """{index: class name}; the vendored 1,100-class ImageNet(+) list by
    default."""
    p = Path(path) if path else VENDORED_CLASS_LIST
    data = json.loads(p.read_text())
    if isinstance(data, list):
        return {str(i): c for i, c in enumerate(data)}
    return {str(k): v for k, v in data.items()}


def load_class_weights(path: Optional[str], default_n: int) -> Dict[str, int]:
    """Per-class sample counts from mining results."""
    if not path or not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    return {k: int(v) for k, v in data.get("new_samples", {}).items()}


class ImageMaskGenerationPipeline:
    def __init__(self, cfg: GenerationConfig, backend: ImageBackend,
                 mask_generator=None):
        self.cfg = cfg
        self.backend = backend
        self.mask_generator = mask_generator
        self.writer = rank() == 0
        gen = ImagePromptGenerator(seed=cfg.seed)
        self.prompts = (FilePromptProvider(cfg.prompts_dir, gen)
                        if self.writer else None)
        self.out = Path(cfg.output_dir)
        if self.writer:
            (self.out / "images").mkdir(parents=True, exist_ok=True)
            (self.out / "masks").mkdir(parents=True, exist_ok=True)

    def _paths(self, class_name: str, idx: int) -> Tuple[Path, Path]:
        stem = f"{class_name.replace(' ', '_')}_{idx:04d}"
        return (self.out / "images" / f"{stem}.jpg",
                self.out / "masks" / f"{stem}.png")

    def process_class(self, class_name: str, n_samples: int) -> int:
        """Generate up to n_samples for one class; skips existing outputs."""
        from PIL import Image

        rng = random.Random(f"{self.cfg.seed}/{class_name}")
        prompts = broadcast_object(
            self.prompts.get_prompts(class_name, n_samples) if self.writer
            else None)
        done = 0
        for i, prompt in enumerate(prompts[:n_samples]):
            img_path, mask_path = self._paths(class_name, i)
            if broadcast_object(img_path.exists() and mask_path.exists()):
                done += 1
                continue
            try:
                w, h = rng.choice(GENERATION_RESOLUTIONS)
                seed = rng.randrange(2**31)
                image, feats, cmaps = self.backend.generate(
                    prompt, class_name, h, w, seed)
                if self.mask_generator is not None:
                    mask = self.mask_generator.generate_mask(image, feats, cmaps)
                else:
                    mask = (cmaps["category"] > 0.5).astype(np.uint8) * 255
                    mask = np.array(Image.fromarray(mask).resize(
                        (w, h), Image.NEAREST))
                if self.writer:
                    Image.fromarray(image).save(img_path, quality=95)
                    Image.fromarray(mask).save(mask_path)
                done += 1
            except Exception as e:  # noqa: BLE001 — continue past failures
                logger.error("failed %s[%d]: %s", class_name, i, e)
        return done

    def run(self, task_id: Optional[int] = None,
            num_tasks: Optional[int] = None):
        classes = load_class_list(self.cfg.class_list)
        weights = load_class_weights(self.cfg.class_weights_file,
                                     self.cfg.prompts_per_class)
        names = task_slice(sorted(classes.values()),
                           *detect_task(task_id, num_tasks))
        total = 0
        for name in names:
            n = weights.get(name, self.cfg.prompts_per_class)
            total += self.process_class(name, n)
            logger.info("%s done (%d total)", name, total)
        return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--task_id", type=int, default=None)
    ap.add_argument("--num_tasks", type=int, default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = GenerationConfig.from_yaml(args.config)
    backend = make_backend(cfg)
    mask_gen = None
    if cfg.teacher_checkpoint:
        from s3od_torch.datagen.mask_generator import create_mask_generator

        mask_gen = create_mask_generator(cfg.teacher_checkpoint,
                                         device=cfg.device)
    pipeline = ImageMaskGenerationPipeline(cfg, backend, mask_gen)
    total = pipeline.run(args.task_id, args.num_tasks)
    print(f"generated {total} samples")
    return total


if __name__ == "__main__":
    main()
