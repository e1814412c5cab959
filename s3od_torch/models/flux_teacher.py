"""FLUX-teacher segmentation model: DINOv3 + DPT with FLUX-feature fusion,
in PyTorch (counterpart of `s3od_tpu/models/flux_teacher.py`: the
forward, eval and training, and the init).

Per pyramid level, [DINO scratch features | FLUX transformer features (4
taps, 768-d, stride-16 tokens) | concept maps (category + background)]
go through 1x1/3x3 conv + BN + ReLU projections, a fusion conv pair and a
final 1x1; the fused pyramid then flows through the base model's
refinenets and mask/IoU heads (`models/dpt.py`). The encoder is the
port's DINOv3 (the K1-K5 kernel route in bf16, any patch grid). FLUX
features and concept maps reach each level through the antialiased
resize matrices of `ops/resize.py` (`resize_bilinear_matrix`), as the JAX
package resizes them. BatchNorms use their running statistics in eval;
with `training=True` (`flux_fusion_forward(training=True)`) every
BatchNorm, the fusion levels' and the refinenets', normalizes with the
batch's statistics and updates its running ones (`models/dpt.batch_norm`:
fp32, n = B x H x W for the unbiasing). The encoder is not checkpointed,
as the JAX teacher step does not remat it.

State-dict names: the base model's (`encoder.*`, `seg_head.*`, reference
layout) plus `fusion.{level}.{vit,flux,concept}.{conv,bn}.*`,
`fusion.{level}.fusion.{conv1,bn1,conv2,bn2}.*` and `fusion.{level}.final.*`.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from s3od_torch.configs import SegmentationConfig
from s3od_torch.models.dpt import _conv, batch_norm
from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_
from s3od_torch.ops.resize import resize_bilinear_matrix


@dataclasses.dataclass(frozen=True)
class FluxTeacherConfig:
    base: SegmentationConfig
    flux_dim: int = 768
    num_concept_channels: int = 2
    use_concept_maps: bool = True
    use_flux_features: bool = True
    use_dino_features: bool = True


class ProjBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x, training: bool = False):
        return F.relu(batch_norm(self.bn, _conv(self.conv, x), training))


class FusionConvs(nn.Module):
    def __init__(self, cin: int, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, f, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(f)
        self.conv2 = nn.Conv2d(f, f, 1)
        self.bn2 = nn.BatchNorm2d(f)

    def forward(self, x, training: bool = False):
        x = F.relu(batch_norm(self.bn1, _conv(self.conv1, x), training))
        return batch_norm(self.bn2, _conv(self.conv2, x), training)


class FluxFusion(nn.Module):
    """One pyramid level of FluxFeatureFusion (`flux_fusion_forward`)."""

    def __init__(self, cfg: FluxTeacherConfig):
        super().__init__()
        self.cfg = cfg
        f, fin = cfg.base.features, 0
        if cfg.use_dino_features:
            self.vit = ProjBNReLU(f, f)
            fin += f
        if cfg.use_flux_features:
            self.flux = ProjBNReLU(cfg.flux_dim, f)
            fin += f
        if cfg.use_concept_maps:
            self.concept = ProjBNReLU(cfg.num_concept_channels, f // 2, k=3)
            fin += f // 2
        self.fusion = FusionConvs(fin, f)
        if cfg.use_dino_features:
            self.final = nn.Conv2d(2 * f, f, 1)

    def forward(self, vit_feat, flux_feat, concept, training: bool = False):
        cfg = self.cfg
        target = tuple(vit_feat.shape[-2:])
        parts = []
        if cfg.use_dino_features:
            parts.append(self.vit(vit_feat, training))
        if cfg.use_flux_features:
            parts.append(self.flux(resize_bilinear_matrix(
                flux_feat, target, antialias=True), training))
        if cfg.use_concept_maps:
            parts.append(self.concept(resize_bilinear_matrix(
                concept, target, antialias=True), training))
        if not parts or (len(parts) == 1 and cfg.use_dino_features):
            return vit_feat
        fused = (parts[0] if len(parts) == 1
                 else self.fusion(torch.cat(parts, 1), training))
        if cfg.use_dino_features:
            return _conv(self.final, torch.cat([vit_feat, fused], 1))
        return fused


class FluxTeacher(nn.Module):
    def __init__(self, cfg: FluxTeacherConfig):
        super().__init__()
        self.cfg = cfg
        base = S3ODSegmentation(cfg.base)
        self.encoder, self.seg_head = base.encoder, base.seg_head
        self.fusion = nn.ModuleList(FluxFusion(cfg) for _ in range(4))

    def forward(self, images, transformer_features: List[torch.Tensor],
                concept_maps: Dict[str, torch.Tensor], training: bool = False):
        """images (B, H, W, 3) normalized, in the compute dtype (bf16: the
        encoder's kernel route); transformer_features: 4 x (B, seq,
        flux_dim) at stride 16; concept_maps {'category', 'background'}
        (B, Hc, Wc). -> {'pred_masks': (B, n, H, W), 'pred_iou': (B, n)},
        both fp32 logits. `training`: batch-statistics BatchNorms that
        update their running statistics."""
        cfg, base = self.cfg, self.cfg.base
        dt = images.dtype
        p = base.encoder.patch_size
        ph, pw = images.shape[1] // p, images.shape[2] // p
        route = "kernel" if dt == torch.bfloat16 else "exact"
        taps = self.encoder(images, base.tap_layers, route)
        rn = self.seg_head.neck([t.to(dt) for t in taps], (ph, pw))
        flux = [None] * 4
        if cfg.use_flux_features:
            flux = [t.to(dt).transpose(1, 2).reshape(t.shape[0], t.shape[2],
                                                      ph, pw)
                    for t in transformer_features]
        concept = None
        if cfg.use_concept_maps:
            concept = torch.stack([concept_maps["category"],
                                   concept_maps["background"]], 1).to(dt)
        fused = [fus(rn[i], flux[i], concept, training)
                 for i, fus in enumerate(self.fusion)]
        masks, iou = self.seg_head.decode(fused, (ph, pw), p, training)
        return {"pred_masks": masks.float(), "pred_iou": iou.float()}


@torch.no_grad()
def init_flux_teacher(cfg: FluxTeacherConfig,
                      generator: torch.Generator) -> FluxTeacher:
    """Seeded random weights: the base model's scheme (`init_weights_`)
    for the encoder and head, and the JAX init's for the fusion convs
    (weights U(+-sqrt(6 / fan_in)), biases U(+-sqrt(1 / fan_in)), BNs at
    identity statistics)."""
    model = FluxTeacher(cfg)
    init_weights_(SimpleNamespace(cfg=cfg.base, encoder=model.encoder,
                                  seg_head=model.seg_head), generator)
    for mod in model.fusion.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            w, b = math.sqrt(6.0 / fan_in), math.sqrt(1.0 / fan_in)
            nn.init.uniform_(mod.weight, -w, w, generator=generator)
            nn.init.uniform_(mod.bias, -b, b, generator=generator)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model.eval()
