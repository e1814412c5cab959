"""Bilinear resize, PyTorch `F.interpolate` semantics.

On the device the port calls `F.interpolate(mode="bilinear",
align_corners=False[, antialias=True])` itself — the behaviour
`s3od_tpu/ops/resize.py` was built to match. The host-side numpy resize
(letterbox fallback and the antialiased mask resize back to the original
size) and the FLUX-teacher fusion (`resize_bilinear_matrix`, on the
device) use the torch-matched separable resize matrix; it is carried over
from `s3od_tpu/ops/resize.py:27-60,153-175` rather than imported, because
that module imports jax.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch.nn.functional as F


def resize_bilinear(x, out_hw: Tuple[int, int], *, antialias: bool = False):
    """NCHW tensor -> (N, C, *out_hw); a no-op at the same size."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=antialias)


@functools.lru_cache(maxsize=256)
def _linear_resize_matrix(in_size: int, out_size: int,
                          antialias: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic resize matrix, torch-matched."""
    scale = in_size / out_size
    out = np.zeros((out_size, in_size), dtype=np.float64)
    if antialias and scale > 1.0:
        # Triangle filter stretched by the downscale ratio.
        support = scale
        for o in range(out_size):
            center = scale * (o + 0.5)
            lo = max(0, int(center - support + 0.5))
            hi = min(in_size, int(center + support + 0.5))
            j = np.arange(lo, hi, dtype=np.float64)
            w = np.clip(1.0 - np.abs((j + 0.5 - center) / scale), 0.0, None)
            s = w.sum()
            if s > 0:
                out[o, lo:hi] = w / s
            else:  # pragma: no cover - degenerate
                out[o, min(int(center), in_size - 1)] = 1.0
    else:
        for o in range(out_size):
            c = max(scale * (o + 0.5) - 0.5, 0.0)
            i0 = int(np.floor(c))
            frac = c - i0
            out[o, min(max(i0, 0), in_size - 1)] += 1.0 - frac
            out[o, min(i0 + 1, in_size - 1)] += frac
    return out.astype(np.float32)


def resize_bilinear_matrix(x, out_hw: Tuple[int, int], *,
                           antialias: bool = False):
    """NCHW tensor -> (N, C, *out_hw) through the torch-matched separable
    resize matrices, as `s3od_tpu/ops/resize.py:resize_bilinear` applies
    them: two matmuls, the matrices in x's dtype (bf16 stays bf16). The
    FLUX-teacher fusion resizes with these so that its antialiased
    downscale is the JAX package's."""
    import torch

    out_h, out_w = out_hw
    in_h, in_w = x.shape[-2:]
    if in_h != out_h:
        w = torch.from_numpy(_linear_resize_matrix(in_h, out_h, antialias))
        x = torch.matmul(x.transpose(-1, -2), w.T.to(x.device, x.dtype)
                         ).transpose(-1, -2)
    if in_w != out_w:
        w = torch.from_numpy(_linear_resize_matrix(in_w, out_w, antialias))
        x = torch.matmul(x, w.T.to(x.device, x.dtype))
    return x


def resize_bilinear_numpy(x: np.ndarray, out_hw: Tuple[int, int], *,
                          antialias: bool = False, h_axis: int = -3,
                          w_axis: int = -2) -> np.ndarray:
    """Host-side resize of the `h_axis`/`w_axis` axes of `x` (float32)."""
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    out_h, out_w = out_hw
    x = np.asarray(x, dtype=np.float32)
    if in_h != out_h:
        w = _linear_resize_matrix(in_h, out_h, antialias)
        x = np.moveaxis(np.moveaxis(x, h_axis, -1) @ w.T, -1, h_axis)
    if in_w != out_w:
        w = _linear_resize_matrix(in_w, out_w, antialias)
        x = np.moveaxis(np.moveaxis(x, w_axis, -1) @ w.T, -1, w_axis)
    return x
