"""Model configurations of the port.

The dataclasses and constructors are those of `s3od_tpu.configs`, which
imports no jax; this module is the port's one entry point for them, so
scripts that drive the port name no module of the JAX package.

    from s3od_torch.configs import segmentation_config
    cfg = segmentation_config("dinov3_base")   # DINOv3-ViT-B/16 + DPT
"""

from s3od_tpu.configs import (  # noqa: F401  (re-exported)
    EncoderConfig,
    SegmentationConfig,
    segmentation_config,
    tiny_test_config,
)

__all__ = ["EncoderConfig", "SegmentationConfig", "segmentation_config",
           "tiny_test_config"]
