"""The 2-D convolution every 3x3 conv of the port's DPT decoder, FLUX VAE
and FluxDPT teacher goes through (counterpart of `s3od_tpu/ops/conv.py`'s
`conv2d`).

NCHW activations, OIHW weights (`nn.Conv2d` layout), both cast to x's
dtype at use. With `S3OD_WINOGRAD=1` in the environment at import (as
`conv.py:29` reads it), an eligible 3x3/stride-1/pad-1 conv on the bf16
route runs K9a, the Winograd F(2x2, 3x3) kernel
(`ops/experimental/winograd.py`); everything else runs cuDNN. The gate is
off by default, as in the JAX package.

One difference from the JAX package, on purpose: float32 exact mode keeps
cuDNN (TF32 off, `ops/precision.py`) even with the gate on, because exact
mode launches none of the port's kernels. The JAX package's float32
Winograd agrees with its direct conv to about 1e-6 relative
(`s3od_tpu/ops/experimental/winograd.py:27-29`), so the two exact modes
differ by that much on the routed convs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from s3od_torch.ops.experimental import winograd
from s3od_torch.ops.experimental.winograd import conv3x3_winograd

_WINOGRAD_ENABLED = os.environ.get("S3OD_WINOGRAD", "0") == "1"


def _winograd_eligible(x: torch.Tensor, weight: torch.Tensor, stride: int,
                       padding: int) -> bool:
    """The one place a conv chooses between K9a and cuDNN: the gate, the
    bf16 route, a 3x3/s1/p1 kernel and the JAX package's shape rule."""
    if not _WINOGRAD_ENABLED or x.dtype != torch.bfloat16:
        return False
    if stride != 1 or padding != 1 or tuple(weight.shape[2:]) != (3, 3):
        return False
    _, c, h, w = x.shape
    return winograd.winograd_available(h, w, c, weight.shape[0], x.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Conv of NCHW x with OIHW weight (+ bias), groups 1."""
    w = weight.to(x.dtype)
    b = bias.to(x.dtype) if bias is not None else None
    if _winograd_eligible(x, w, stride, padding):
        p = {"kernel": w.permute(2, 3, 1, 0)}
        if b is not None:
            p["bias"] = b
        y = conv3x3_winograd(x.permute(0, 2, 3, 1), p)
        return y.permute(0, 3, 1, 2)
    return F.conv2d(x, w, b, stride, padding)
