"""Int8 weight residency (counterpart of `s3od_tpu/ops/quant.py`).

Weight-only int8: an eligible linear keeps its kernel as int8 plus one
fp32 scale per output channel (symmetric absmax, w ~= q * scale) and
dequantizes at use into the compute dtype, so the full-depth FLUX MMDiT
holds ~12 GB of weights instead of ~24 GB in bf16. Compute stays in the
compute dtype; int8 buys capacity only. In the JAX package XLA fuses the
dequantization into the dot's operand read; here it is two elementwise
ops feeding `F.linear` (`models/mmdit.py:_linear`), and the dequantized
weight of one linear lives only for its product.

Trees use the JAX names: an eligible `{"kernel": W (din, dout), ...}`
becomes `{"kernel_q": int8 (din, dout), "kernel_scale": fp32 (dout,),
...}`. In a module the same pair is the buffers `weight_q` (dout, din)
and `weight_scale` (dout,) of a `models/mmdit.QuantLinear`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Kernels smaller than this on either axis stay in float: they are a
# rounding error of the total bytes, and the small ones (in/out
# projections) are precision-sensitive. A module attribute, read at each
# call (tests lower it to quantize a tiny model).
MIN_QUANT_DIM = 256


def quantize_weight_int8(w: torch.Tensor):
    """(dout, din) float weight -> (int8 (dout, din), fp32 (dout,) scale):
    symmetric absmax per output channel, w ~= q * scale, in float32 on
    `w`'s device."""
    w = w.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kernel_int8(kernel) -> Tuple[np.ndarray, np.ndarray]:
    """(din, dout) float kernel -> (int8 kernel, (dout,) fp32 scale), in
    numpy, bit-equal to the JAX function (the same float32 operations,
    round half to even)."""
    w = np.ascontiguousarray(np.asarray(kernel, np.float32).T)
    q, scale = quantize_weight_int8(torch.from_numpy(w))
    return np.ascontiguousarray(q.numpy().T), scale.numpy()


def eligible(shape) -> bool:
    """A 2-D kernel at least MIN_QUANT_DIM on both axes."""
    return (len(shape) == 2 and shape[0] >= MIN_QUANT_DIM
            and shape[1] >= MIN_QUANT_DIM)


def quantize_tree_int8(params):
    """Rewrite every eligible {'kernel': W, ...} dict of a param tree to
    {'kernel_q': int8, 'kernel_scale': f32, ...}; everything else as it
    was. Host numpy in, host numpy out."""
    if isinstance(params, dict):
        kernel = params.get("kernel")
        if kernel is not None and eligible(getattr(kernel, "shape", ())):
            q, s = quantize_kernel_int8(kernel)
            out = {k: quantize_tree_int8(v) for k, v in params.items()
                   if k != "kernel"}
            out["kernel_q"] = q
            out["kernel_scale"] = s
            return out
        return {k: quantize_tree_int8(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree_int8(v) for v in params)
    return params


def dequant_weight(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The (dout, din) weight of int8 `q` (dout, din) and its per-row
    `scale` (dout,) in `dtype`, in the JAX order (`quant.py:77-81`): both
    cast to `dtype`, then one product."""
    return q.to(dtype) * scale.to(dtype)[:, None]


def dequant_kernel(p: dict, dtype: torch.dtype) -> torch.Tensor:
    """The (din, dout) kernel of a tree node in `dtype` (`dequant_weight`
    on the transposed codes; elementwise, so the same values)."""
    if "kernel_q" in p:
        return dequant_weight(torch.as_tensor(p["kernel_q"]).T,
                              torch.as_tensor(p["kernel_scale"]), dtype).T
    return torch.as_tensor(p["kernel"]).to(dtype)


def tree_bytes(params) -> int:
    """Bytes of every array leaf of a tree (numpy or torch)."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if hasattr(params, "nbytes"):
        return int(params.nbytes)
    return 0
