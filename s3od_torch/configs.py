"""Model configurations of the port (its own copy of `s3od_tpu/configs.py`).

The dataclasses, the named encoder variants and the constructors keep the
JAX package's names and values, so a configuration means the same model on
both sides:

    from s3od_torch.configs import segmentation_config
    cfg = segmentation_config("dinov3_base")   # DINOv3-ViT-B/16 + DPT

Architecture facts follow the reference checkpoint family
(`src/s3od/dinov3_config/config.json`, `src/s3od/model.py:36-45`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """DINOv3 ViT encoder configuration.

    Defaults correspond to DINOv3-ViT-B/16 as configured by the reference
    (`src/s3od/dinov3_config/config.json:8-31`).
    """

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    num_register_tokens: int = 4
    rope_theta: float = 100.0
    layer_norm_eps: float = 1e-5
    layerscale_value: float = 1.0
    query_bias: bool = True
    key_bias: bool = False
    value_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    use_gated_mlp: bool = False
    # Training-time RoPE coordinate augmentation (`pos_embed_rescale: 2.0`).
    pos_embed_rescale: Optional[float] = 2.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_prefix_tokens(self) -> int:
        # CLS + register tokens
        return 1 + self.num_register_tokens


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Full DPT segmentation model configuration.

    `tap_layers` are indices into the HF-style hidden_states list where
    hidden_states[0] is the embedding output and hidden_states[i] is the output
    of transformer block i-1 (`src/s3od/model.py:36-40,62-86`). The reference
    taps [2, 5, 8, 11] for base — i.e. outputs of blocks 1, 4, 7 and 10 — which
    means the final block and final layernorm are dead code for this model; we
    simply never run them.
    """

    encoder: EncoderConfig = EncoderConfig()
    tap_layers: Sequence[int] = (2, 5, 8, 11)
    # DPT neck: per-tap projection channels (`src/s3od/model.py:45`)
    neck_channels: Sequence[int] = (256, 512, 1024, 1024)
    features: int = 256
    num_outputs: int = 3
    num_classes: int = 1
    use_bn: bool = True
    use_clstoken: bool = False
    mask_inter_features: int = 32

    @property
    def num_encoder_layers_used(self) -> int:
        """Blocks that must actually run: tap t needs blocks 0..t-1."""
        return max(self.tap_layers)


# Named variants matching the reference model family (`README.md:114-141`).
DINOV3_BASE = EncoderConfig()
DINOV3_SMALL = dataclasses.replace(
    DINOV3_BASE, hidden_size=384, num_heads=6, intermediate_size=1536
)
DINOV3_LARGE = dataclasses.replace(
    DINOV3_BASE,
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    intermediate_size=4096,
)

# CI/smoke-scale encoder (model=tiny config group): real architecture at
# toy width so the full train()/predict stack runs in seconds on CPU.
DINOV3_TINY = dataclasses.replace(
    DINOV3_BASE, hidden_size=64, num_layers=4, num_heads=2,
    intermediate_size=128,
)

ENCODER_CONFIGS = {
    "dinov3_base": DINOV3_BASE,
    "dinov3_small": DINOV3_SMALL,
    "dinov3_large": DINOV3_LARGE,
    "dinov3_tiny": DINOV3_TINY,
}

# Intermediate tap layers per encoder (`src/s3od/model.py:36-40`).
TAP_LAYERS = {
    "dinov3_base": (2, 5, 8, 11),
    "dinov3_small": (2, 5, 8, 11),
    "dinov3_large": (4, 11, 17, 23),
    "dinov3_tiny": (1, 2, 3, 4),
}

# Smaller DPT neck for the tiny encoder (default is the reference's
# (256, 512, 1024, 1024), `src/s3od/model.py:45`).
NECK_CHANNELS = {
    "dinov3_tiny": (32, 64, 128, 128),
}


def segmentation_config(
    encoder_name: str = "dinov3_base",
    num_outputs: int = 3,
    features: int = 256,
    use_bn: bool = True,
    use_clstoken: bool = False,
) -> SegmentationConfig:
    kwargs = {}
    if encoder_name in NECK_CHANNELS:
        kwargs["neck_channels"] = NECK_CHANNELS[encoder_name]
        kwargs["mask_inter_features"] = 8
    return SegmentationConfig(
        encoder=ENCODER_CONFIGS[encoder_name],
        tap_layers=TAP_LAYERS[encoder_name],
        num_outputs=num_outputs,
        features=features,
        use_bn=use_bn,
        use_clstoken=use_clstoken,
        **kwargs,
    )


def tiny_test_config(num_layers: int = 4) -> SegmentationConfig:
    """A deliberately tiny config for CI tests that need no checkpoint.

    The reference has no fake-model path (SURVEY.md §4) — this fills that gap.
    """
    enc = EncoderConfig(
        hidden_size=64,
        num_layers=num_layers,
        num_heads=2,
        intermediate_size=128,
    )
    return SegmentationConfig(
        encoder=enc,
        tap_layers=(1, 2, 3, 4)[:num_layers],
        neck_channels=(32, 64, 128, 128),
        features=32,
        mask_inter_features=8,
    )
