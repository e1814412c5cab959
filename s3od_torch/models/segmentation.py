"""Full segmentation model: DINOv3 encoder + DPT decoder (counterpart of
`s3od_tpu/models/segmentation.py`).

    model = S3ODSegmentation(cfg)            # reference parameter names
    model.load_state_dict(sd, strict=True)   # reference .pt or converted .npz
    out = model(images_nhwc)                 # {"pred_masks", "pred_iou"}
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from s3od_torch.configs import SegmentationConfig
from s3od_torch.models.dinov3 import DINOv3Encoder
from s3od_torch.models.dpt import DPTHead, fold_bn_


class S3ODSegmentation(nn.Module):
    def __init__(self, cfg: SegmentationConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = DINOv3Encoder(cfg.encoder)
        self.seg_head = DPTHead(cfg)

    def forward(self, images, training: bool = False,
                rope_coord_scale: Optional[torch.Tensor] = None,
                remat_policy: Optional[str] = None,
                serving_fast_output: bool = False,
                rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                bn_group=None):
        """images (B, H, W, 3) normalized, in the compute dtype.

        Returns {"pred_masks": (B, n, H, W) logits, "pred_iou": (B, n) fp32
        logits}. bf16 input takes the encoder's "kernel" route, any other
        dtype the "exact" one (models/dinov3.py). Serving keeps the masks in
        the compute dtype; `training=True` returns them in fp32 (the JAX
        public contract, `segmentation.py:78-83`), normalizes the decoder
        with batch statistics (updating the BatchNorms' running ones) and
        checkpoints every encoder block (`remat_policy`: models/dinov3.py).
        `rope_coord_scale` rescales the RoPE coordinates.
        `serving_fast_output` marks the serving forward, as in the JAX
        package: only it may run the fused mask tail (K10, behind
        `models/dpt.MASK_TAIL_FUSED`); the masks stay NCHW either way.
        `rope_tables`: the encoder's RoPE (cos, sin), given instead of
        built (`models/dinov3.encoder_tables`). `bn_group`: in training,
        the process group whose ranks hold the other rows of the batch;
        the BatchNorms then take the global batch's statistics
        (`models/dpt.batch_norm`)."""
        route = "kernel" if images.dtype == torch.bfloat16 else "exact"
        cfg = self.cfg
        p = cfg.encoder.patch_size
        taps = self.encoder(images, cfg.tap_layers, route,
                            rope_coord_scale=rope_coord_scale,
                            remat=training,
                            remat_policy=remat_policy,
                            tables=rope_tables)
        masks, iou = self.seg_head(
            taps, (images.shape[1] // p, images.shape[2] // p), p, training,
            serving_fast_output, bn_group)
        if training:
            masks = masks.float()
        return {"pred_masks": masks, "pred_iou": iou.float()}

    def unused_parameter_names(self):
        """Parameters the forward never reads: the encoder blocks past the
        last tap, the final LayerNorm, the mask token, and refinenet4's
        first RCU (refinenet4 has no skip input). Data-parallel wrappers
        leave them out of the gradient reduction (`parallel.shard_module`);
        the optimizer gives them zero gradients."""
        used = self.cfg.num_encoder_layers_used
        prefixes = [f"encoder.layer.{i}." for i in
                    range(used, len(self.encoder.layer))]
        prefixes += ["encoder.norm.", "encoder.embeddings.mask_token",
                     "seg_head.scratch.refinenet4.resConfUnit1."]
        return [n for n, _ in self.named_parameters()
                if any(n.startswith(p) for p in prefixes)]

    @torch.no_grad()
    def prepare_serving_(self, dtype: torch.dtype, fold_bn: bool = True):
        """One-time load transforms (`prepare_serving_params`): fold the
        BNs and cast EVERY parameter to the compute dtype (the kernels read
        bf16 LayerNorm weights, layerscales and biases; the qkv weights are
        stored fused already). Returns self, in eval mode."""
        self.eval()
        if fold_bn:
            fold_bn_(self.seg_head)
        return self.to(dtype)


@torch.no_grad()
def init_weights_(model: S3ODSegmentation,
                  generator: torch.Generator) -> S3ODSegmentation:
    """Seeded random weights in the JAX package's init scheme
    (`init_encoder_params`, `init_dpt_params`): encoder linears, tokens and
    patch embed ~ N(0, 0.02) truncated at 2 sigma with zero biases, LN
    (1, 0), layerscales at their config value; decoder convs and linears
    U(+-sqrt(1/fan_in)) for weight and bias, BN at identity statistics."""
    enc = model.encoder
    ls_value = model.cfg.encoder.layerscale_value
    for name, prm in enc.named_parameters():
        if name.endswith("lambda1"):
            prm.fill_(ls_value)
        elif ".norm" in name or name.startswith("norm"):
            prm.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            prm.zero_()
        elif name.endswith("mask_token"):
            prm.zero_()
        else:
            nn.init.trunc_normal_(prm, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
    for mod in model.seg_head.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = w[0].numel()
            bound = math.sqrt(1.0 / fan_in)
            nn.init.uniform_(w, -bound, bound, generator=generator)
            if mod.bias is not None:
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model
