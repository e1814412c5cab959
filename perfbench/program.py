"""The program under test, `s3od_torch`, as the benchmark reaches it: the
one module of the benchmark that imports it. Each function builds the
port's own objects from a configuration file's numbers and a seeded state
dict in the checkpoint layout; the drivers then call the port's public
entry points (`BackgroundRemoval`, `train_step`) on them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def segmentation_config(cfg: dict):
    from s3od_torch.configs import EncoderConfig, SegmentationConfig

    enc = EncoderConfig(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        patch_size=cfg["patch_size"],
        num_register_tokens=cfg["num_register_tokens"],
        rope_theta=cfg["rope_theta"], layer_norm_eps=cfg["layer_norm_eps"],
        layerscale_value=cfg["layerscale_value"],
        query_bias=cfg["query_bias"], key_bias=cfg["key_bias"],
        value_bias=cfg["value_bias"], proj_bias=cfg["proj_bias"],
        mlp_bias=cfg["mlp_bias"], pos_embed_rescale=cfg["pos_embed_rescale"])
    return SegmentationConfig(
        encoder=enc, tap_layers=tuple(cfg["tap_layers"]),
        neck_channels=tuple(cfg["neck_channels"]), features=cfg["features"],
        num_outputs=cfg["num_outputs"], use_bn=cfg["use_bn"],
        mask_inter_features=cfg["mask_inter_features"])


def build_model(cfg: dict, sd: Dict[str, torch.Tensor], device):
    """The port's model (`S3ODSegmentation`, or `FluxTeacher` for a
    configuration with `flux_dim`) on `device`, loaded strictly from `sd`."""
    from s3od_torch.models.flux_teacher import FluxTeacher, FluxTeacherConfig
    from s3od_torch.models.segmentation import S3ODSegmentation

    seg = segmentation_config(cfg)
    with torch.device(device):
        if cfg.get("flux_dim"):
            model = FluxTeacher(FluxTeacherConfig(
                base=seg, flux_dim=cfg["flux_dim"],
                num_concept_channels=cfg["num_concept_channels"]))
        else:
            model = S3ODSegmentation(seg)
    model.load_state_dict(sd, strict=True)
    return model


def predictor(model, image_size: int, dtype: str):
    """`BackgroundRemoval` serving `model` (prepared in place: the BN fold
    and the cast to `dtype`)."""
    from s3od_torch.predictor import BackgroundRemoval

    dev = next(model.parameters()).device
    return BackgroundRemoval.from_model(model, image_size=image_size,
                                        device=str(dev), dtype=dtype)


@dataclasses.dataclass
class Trainer:
    """The port's training step with its model, optimizer and loss: one
    object, built once and driven step after step."""
    model: torch.nn.Module
    optimizer: object
    loss: object
    forward: object
    dtype: torch.dtype
    preprocessed: bool

    def step(self, batch, step: int, rope_seed: int):
        from s3od_torch.training.train_step import train_step

        return train_step(self.model, self.optimizer, self.loss, batch, 0, step,
                          generator=torch.Generator().manual_seed(rope_seed),
                          compute_dtype=self.dtype,
                          preprocessed=self.preprocessed, forward=self.forward)


def trainer(cfg: dict, model, recipe: dict, dtype: str) -> Trainer:
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import segmentation_forward, teacher_forward

    opt = Optimizer(model, recipe["lr"], head_lr_mult=recipe["head_lr_mult"],
                    weight_decay=recipe["weight_decay"],
                    steps_per_epoch=recipe["steps_per_epoch"])
    teacher = bool(cfg.get("flux_dim"))
    return Trainer(model, opt, LossModule(LOSS_PRESETS[recipe["loss"]]),
                   teacher_forward if teacher else segmentation_forward,
                   getattr(torch, dtype), preprocessed=not teacher)


def split_qkv(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-parameter tensors keyed by the port's names -> keyed by the
    checkpoint's: each fused qkv weight and bias split into q, k and v
    (the key bias, which the checkpoint does not have, dropped)."""
    out = {}
    for n, t in named.items():
        if ".attention.qkv." in n:
            stem, leaf = n.rsplit(".qkv.", 1)
            q, k, v = t.chunk(3)
            out[f"{stem}.q_proj.{leaf}"] = q
            if leaf == "weight":
                out[f"{stem}.k_proj.{leaf}"] = k
            out[f"{stem}.v_proj.{leaf}"] = v
        else:
            out[n] = t
    return out
