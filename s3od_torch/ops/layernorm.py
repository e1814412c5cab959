"""K1: row LayerNorm with fp32 statistics (Triton) and its plain version.

Replaces the TPU kernel `s3od_tpu/ops/layernorm.py:_ln_fwd_kernel` (via
`layer_norm(impl="pallas")`): per row, mean and E[x^2] in fp32,
var = max(E[x^2] - mean^2, 0), y = (x - mean) * rstd * w + b stored in the
input dtype; mean and rstd are emitted for a later backward.

Bound on the H100: no product at all — 2C bytes in and 2C + 8 bytes out
per row (4160 x 768 at ViT-B, 1024^2: ~12.8 MB, ~4 us at 3.35 TB/s), so
it is memory-bound. One program per row with a masked power-of-two block
(1024 lanes for C = 768) reads each row once and writes it once, which is
all a CUDA kernel could do too, so Triton suffices for this reduction.
On an H100 80GB (700 W) it takes ~5 us of device time at that shape;
the host's Triton launch (~60 us) costs more than the kernel. `triton`
is imported only when the kernel launches.

Plain LayerNorm for the exact (float32) route, the two-pass formula of
`s3od_tpu/ops/layernorm.py:_xla_layer_norm`, lives here too.

The kernel is also the registered op `s3od::layer_norm` (`_build.via_ops`),
whose implementation is `_layer_norm`: a LayerNorm does no product, so
it has no FLOP formula, as aten's own LayerNorm has none.
"""

from __future__ import annotations

import functools
import torch

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp

def layer_norm_plain(x, weight, bias, eps: float):
    """Plain version of K1: returns (y, mean, rstd); mean/rstd (..., 1)."""
    xf = x.float()
    m1 = xf.mean(-1, keepdim=True)
    m2 = (xf * xf).mean(-1, keepdim=True)
    rstd = torch.rsqrt((m2 - m1 * m1).clamp_min(0.0) + eps)
    y = (xf - m1) * rstd
    y = y * weight.float() + bias.float()
    return y.to(x.dtype), m1, rstd


def layer_norm_exact(x, weight, bias, eps: float):
    """Two-pass fp32-statistics LayerNorm (the exact route's formula)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd(X, W, B, Y, MEAN, RSTD, C, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < C
        x = tl.load(X + row * C + cols, mask=mask, other=0.0).to(tl.float32)
        m1 = tl.sum(x, axis=0) / C
        m2 = tl.sum(x * x, axis=0) / C
        var = tl.maximum(m2 - m1 * m1, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=mask, other=0.0).to(tl.float32)
        y = (x - m1) * rstd
        y = y * w + b
        tl.store(Y + row * C + cols, y.to(Y.dtype.element_ty), mask=mask)
        tl.store(MEAN + row, m1)
        tl.store(RSTD + row, rstd)

    return triton, _ln_fwd


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm over the last axis -> (y, mean, rstd).

    CPU tensors take `layer_norm_plain`. CUDA tensors launch the Triton
    kernel (bf16 rows, C a multiple of 64 up to 1024) or raise."""
    if _build.via_ops():
        return torch.ops.s3od.layer_norm(x, weight, bias, float(eps))
    return _layer_norm(x, weight, bias, eps)


def _layer_norm(x, weight, bias, eps: float):
    """`layer_norm`'s implementation, and its op's."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or c % 64 or c > 1024:
        raise ValueError(f"layer_norm kernel: unsupported {x.dtype} C={c}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("layer_norm kernel: weight/bias must be (C,)")
    x2 = x.contiguous().view(-1, c)
    rows = x2.shape[0]
    with _build.launch(layer_norm):
        y = torch.empty_like(x2)
        mean = torch.empty((rows, 1), device=x.device, dtype=torch.float32)
        rstd = torch.empty_like(mean)
        triton, kernel = _triton_kernel()
        with _build.triton_cache():
            kernel[(rows,)](
                x2, weight.contiguous(), bias.contiguous(), y, mean, rstd, c, eps,
                BLOCK=triton.next_power_of_2(c), num_warps=4,
            )
    lead = x.shape[:-1]
    return y.view(x.shape), mean.view(*lead, 1), rstd.view(*lead, 1)


layer_norm.launches = 0


def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _build.op_outputs(_layer_norm(x, weight, bias, eps))


def _layer_norm_fake(x, weight, bias, eps):
    stat = x.new_empty((*x.shape[:-1], 1), dtype=torch.float32)
    return x.new_empty(x.shape), stat, torch.empty_like(stat)


_build.register_op("layer_norm", _layer_norm_op, _layer_norm_fake)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps)[0]

    @staticmethod
    def backward(ctx, g):
        fn = lambda x, w, b: layer_norm_plain(x, w, b, ctx.eps)[0]
        return (*plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:3],
                           (g,)), None)


# Differentiable `layer_norm` -> y: K1 forward, the plain version's vjp
# backward (`_ln_bwd_rule`).
layer_norm_autograd = _LayerNorm.apply
