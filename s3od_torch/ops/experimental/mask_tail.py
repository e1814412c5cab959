"""K10: the fused mask-head tail (CUDA) and its plain version.

Replaces the TPU kernel `s3od_tpu/ops/experimental/mask_tail.py:_kernel`
(via `mask_tail`). The kernel source and its design note are in
`s3od_torch/csrc/mask_tail.cu`.

Given x, the mask head's transposed-conv output before its ReLU:
    h1  = relu(conv3x3(relu(x), w1) + b1)     C_in -> C_in, rounded once
    h2  = relu(conv3x3(h1, w0) + b0)          C_in -> C_mid, rounded once
    out = h2 @ k1 + bk                        C_mid -> n_out, rounded once
Rounding points (the TPU kernel's): each product accumulates in fp32; each
bias is read in the compute dtype and added to the fp32 accumulator
before that layer's one rounding, so the unfused chain — which rounds
the conv and the bias add separately — is not bit-equal to it. h1 is
zero outside the image (its ring is masked after the ReLU), as the second
conv's zero padding needs. The output is (B, H, W, n_out) logits in x's
dtype.

Layout: x is (B, H, W, C_in) in NHWC *logical* order with any strides;
the decoder hands in its NCHW tensor as a `permute(0, 2, 3, 1)` view and
gets an output in the same memory order back (`_empty_like_layout`).
Weights HWIO, as in the JAX package. There is no backward, as in JAX:
training keeps the unfused path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from s3od_torch import _build
from s3od_torch.ops.experimental.winograd import _empty_like_layout

# (C_in, C_mid) the kernel is built for: the mask head of every ViT config
# but the tiny test ones (inter 32: 64 -> 96).
KERNEL_WIDTHS = (64, 96)
MAX_OUT = 4


def _conv3x3(x, w, b):
    """NHWC 3x3 'same' conv, fp32 accumulation of x's-dtype products, bias
    added in fp32: the fp32 accumulator before the rounding."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float().permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1) + b.float()


def mask_tail_plain(x, w1, b1, w0, b0, k1, bk):
    """Plain version of K10. x (B, H, W, C_in); w1 (3, 3, C_in, C_in), w0
    (3, 3, C_in, C_mid), k1 (C_mid, n_out); biases (C_in,), (C_mid,),
    (n_out,). The weights are cast to x's dtype first."""
    dt = x.dtype
    cast = lambda t: t.to(dt)
    w1, b1, w0, b0, k1, bk = map(cast, (w1, b1, w0, b0, k1, bk))
    h1 = torch.relu(_conv3x3(torch.relu(x), w1, b1)).to(dt)
    h2 = torch.relu(_conv3x3(h1, w0, b0)).to(dt)
    return (torch.matmul(h2.float(), k1.float()) + bk.float()).to(dt)


def mask_tail(x, w1, b1, w0, b0, k1, bk):
    """The fused tail. CPU tensors take the plain version. CUDA tensors
    launch the kernel or raise: bf16 x (B, H, W, C_in) with (C_in, C_mid)
    = `KERNEL_WIDTHS` and n_out <= 4."""
    if x.device.type == "cpu":
        return mask_tail_plain(x, w1, b1, w0, b0, k1, bk)
    bsz, h, w, cin = x.shape
    cmid, nout = w0.shape[-1], k1.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError("mask_tail kernel: bf16 inputs only")
    if ((cin, cmid) != KERNEL_WIDTHS or not 1 <= nout <= MAX_OUT
            or tuple(w1.shape) != (3, 3, cin, cin)
            or tuple(w0.shape) != (3, 3, cin, cmid)
            or tuple(k1.shape) != (cmid, nout) or tuple(b1.shape) != (cin,)
            or tuple(b0.shape) != (cmid,) or tuple(bk.shape) != (nout,)
            or not x.numel()):
        raise ValueError(f"mask_tail kernel: unsupported x={tuple(x.shape)} "
                         f"w1={tuple(w1.shape)} w0={tuple(w0.shape)} "
                         f"k1={tuple(k1.shape)}")
    w1, b1, w0, b0, k1, bk = (t.to(x.dtype).contiguous()
                              for t in (w1, b1, w0, b0, k1, bk))
    out = _empty_like_layout(x, nout)
    lib = _build.load_library()
    code = lib.s3od_mask_tail(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w0.data_ptr(),
        b0.data_ptr(), k1.data_ptr(), bk.data_ptr(), out.data_ptr(),
        bsz, h, w, cin, cmid, nout, *x.stride(), *out.stride(),
        _build.stream_ptr(x))
    _build.check(code, "mask_tail")
    _build.count_launch(mask_tail)
    return out


mask_tail.launches = 0
