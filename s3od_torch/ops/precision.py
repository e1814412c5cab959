"""Exact / fast precision switch (counterpart of `s3od_tpu/ops/precision.py`).

The JAX package pins every float32 dot and conv to HIGHEST precision in
its exact mode. On Hopper a float32 matmul is full float32 by default, but
a float32 cuDNN convolution runs in TF32 (about three decimal digits), so
exact mode turns TF32 off for both. bf16 fast mode leaves the flags alone:
its products are bf16 with fp32 accumulation either way.
"""

from __future__ import annotations

import torch


def set_exact_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions (process-wide:
    these are PyTorch's global backend flags)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on CUDA, float32 elsewhere — the JAX predictor's rule
    (`s3od_tpu/predictor.py:206-208`) with CUDA in the TPU's place."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
