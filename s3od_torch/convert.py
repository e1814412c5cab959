"""Weights carried across: JAX pytrees and reference `.pt` files -> the
port's state dict.

The port's modules use the reference checkpoint's parameter names, so the
JAX-free `s3od_tpu.convert.export_torch_state_dict` (which writes that
layout) is the whole converter; this module wraps it in torch tensors and
infers the configuration of a checkpoint.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s3od_torch.configs import (
    SegmentationConfig,
    segmentation_config,
    tiny_test_config,
)
from s3od_tpu.convert import (
    _HIDDEN_TO_ENCODER,
    export_torch_state_dict,
    load_native_segmentation,
)


def state_dict_from_jax(params: dict, state: Optional[dict]) -> Dict[str, torch.Tensor]:
    """JAX params/BN-state pytree (numpy arrays, as `load_native` returns
    them) -> the port's state dict, loadable with `strict=True`."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_torch_state_dict(params, state).items()
    }


def config_from_state_dict(sd: Dict[str, torch.Tensor]) -> SegmentationConfig:
    """Infer the configuration from the encoder width, as
    `s3od_tpu.convert.load_native_segmentation` does (width 64 is the tiny
    test model, whose depth is read from the layer count)."""
    hid = int(sd["encoder.embeddings.cls_token"].shape[-1])
    if hid == 64:
        n = sum(1 for k in sd if k.startswith("encoder.layer.")
                and k.endswith(".norm1.weight"))
        return tiny_test_config(num_layers=n)
    if hid not in _HIDDEN_TO_ENCODER:
        raise ValueError(f"unknown encoder hidden size {hid}")
    return segmentation_config(_HIDDEN_TO_ENCODER[hid])


def load_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], SegmentationConfig]:
    """A reference `.pt` ({'state_dict': ...}, Lightning 'model.' prefix
    allowed) or a JAX `.npz` -> (state dict, config)."""
    path = Path(path)
    if path.suffix == ".npz":
        params, state, cfg = load_native_segmentation(str(path))
        return state_dict_from_jax(params, state), cfg
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    return sd, config_from_state_dict(sd)
