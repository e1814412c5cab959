"""LoRA fine-tuning CLI for the MMDiT on captioned real-image data, in
PyTorch (counterpart of `s3od_tpu/datagen/flux_finetune.py`).

Fine-tunes FLUX with a LoRA on the real SOD training sets, using VLM
captions, so that generated images better match the real data: latents
and text embeddings are computed on the fly, and training is
rectified-flow matching on the LoRA leaves only (`datagen/lora.py`), on
the card: every attention of the step is K7 forward and K8 backward.

Usage:
    python -m s3od_torch.datagen.flux_finetune --config finetune.yaml

Config keys (the JAX package's): flux_checkpoint, vae_checkpoint,
input_dir, datasets, metadata_dir, rank, alpha, lr, steps, seed,
out_lora. The port's own: t5_checkpoint and clip_checkpoint (converted
`.npz` trees for the on-device text encoders; without them the encoders
come from transformers), device ("cuda" by default) and compute_dtype
("bfloat16", the JAX package's default, or "float32").
"""

from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import yaml

logger = logging.getLogger("s3od_torch.finetune")


def collect_samples(input_dir: str, datasets: List[str],
                    metadata_dir: str) -> List[Dict]:
    from s3od_torch.datagen.feature_extraction import load_metadata

    samples = []
    for ds in datasets:
        meta = load_metadata(metadata_dir, ds)
        for img in sorted((Path(input_dir) / ds / "images").glob("*")):
            m = meta.get(img.stem, {})
            samples.append({
                "image": img,
                "caption": m.get("caption", "a photo of a salient object"),
            })
    return samples


def run(config_path: str, *, _mmdit_cfg=None, _vae=None, _text=None,
        _resizer=None) -> str:
    """Run LoRA fine-tuning from a YAML config; -> the written `.npz`.

    The underscore kwargs inject substitutes (a tiny MMDiT configuration,
    a VAE, text encoders, a resizer), as in the JAX package: the
    full-size VAE and the gated CLIP/T5 downloads are then not needed."""
    from PIL import Image

    from s3od_torch.convert import load_mmdit, save_native
    from s3od_torch.datagen.diffusion import TextEncoders, make_img_ids, pack_latents
    from s3od_torch.datagen.feature_extraction import text_encoders_from
    from s3od_torch.datagen.lora import (PACK_ORDER, LoRAConfig, init_lora_params,
                                         lora_optimizer, make_lora_train_step)
    from s3od_torch.datagen.resizer import FluxResizer
    from s3od_torch.utils import compute_dtype_for, resolve_device

    cfg = yaml.safe_load(Path(config_path).read_text())
    device = resolve_device(cfg.get("device"))
    model = load_mmdit(cfg["flux_checkpoint"], cfg=_mmdit_cfg, device=device,
                       dtype=compute_dtype_for(device, cfg.get("compute_dtype")))
    if _vae is not None:
        vae = _vae
    else:
        from s3od_torch.models.vae import load_vae

        vae = load_vae(cfg["vae_checkpoint"], device=device)
    text = _text or text_encoders_from(cfg) or TextEncoders()
    resizer = _resizer or FluxResizer()

    lcfg = LoRAConfig(rank=int(cfg.get("rank", 16)),
                      alpha=float(cfg.get("alpha", 16.0)))
    lora = init_lora_params(torch.Generator(device=device).manual_seed(0),
                            model, lcfg)
    opt = lora_optimizer(lora, float(cfg.get("lr", 1e-4)))
    step = make_lora_train_step(
        model, lcfg, opt,
        compute_dtype=compute_dtype_for(device, cfg.get("compute_dtype")))

    samples = collect_samples(cfg["input_dir"], cfg["datasets"],
                              cfg["metadata_dir"])
    logger.info("%d training samples", len(samples))
    rng = random.Random(cfg.get("seed", 0))
    steps = int(cfg.get("steps", 1000))
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    for it in range(steps):
        s = rng.choice(samples)
        image = np.array(Image.open(s["image"]).convert("RGB"))
        resized, _ = resizer.resize_image(image)
        latents = as_t(vae.encode(resized))
        t5, pooled = text.encode([s["caption"]])
        # The RoPE grid is the PACKED latent grid (2x2 packing after the
        # VAE's downsample), derived so that any VAE configuration fits.
        ph, pw = latents.shape[1] // 2, latents.shape[2] // 2
        batch = {
            "latents": pack_latents(latents),
            "txt": as_t(t5),
            "pooled": as_t(pooled),
            "img_ids": as_t(make_img_ids(ph, pw)),
            "txt_ids": torch.zeros(np.shape(t5)[1], 3, device=device),
        }
        loss = step(lora, batch, torch.Generator(device=device).manual_seed(it))
        if it % 50 == 0:
            logger.info("step %d loss %.4f", it, float(loss))

    out = cfg.get("out_lora", "flux_lora.npz")
    # The merge scale and the latent-pack-order tag ride beside the
    # adapters: the pipeline's lora=path merges W + (alpha / rank) A @ B
    # as training did, and refuses adapters trained on another packing.
    save_native(out, lora, {"alpha": np.float32(lcfg.alpha),
                            "rank": np.int32(lcfg.rank),
                            "pack_order": np.bytes_(PACK_ORDER)})
    logger.info("wrote %s", out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run(args.config)


if __name__ == "__main__":
    main()
