"""K2: fused QKV projection + RoPE, head-major output (CUDA) and its plain
version.

Replaces the TPU kernel `s3od_tpu/ops/qkv_project.py:_kernel` (via
`qkv_project_rope`). The kernel source and its design note are in
`s3od_torch/csrc/qkv_project.cu`.

The weight is the fused nn.Linear-layout (3C, C) matrix — the q, k and v
projection weights stacked — with the fused (3C,) bias whose key segment
is zero (DINOv3 has no key bias). The TPU kernel's head-pair packing is a
lane layout of the TPU and is not ported.
"""

from __future__ import annotations

import torch

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp


def rotate_half(t):
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], dim=-1)


def qkv_project_rope_plain(x, weight, bias, cos, sin, num_heads: int,
                           scale: float):
    """Plain version of K2. x (B, N, C); weight (3C, C); bias (3C,);
    cos/sin (N, D) fp32 -> q, k, v each (B, H, N, D) in x's dtype.

    y = x @ W^T + b in fp32; rotate-half acts on y rounded to x's dtype
    (exact in float32); q is scaled after RoPE, before the final round."""
    b, n, c = x.shape
    d = c // num_heads
    y = torch.matmul(x.float(), weight.float().t()) + bias.float()
    y = y.view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (3,B,H,N,D)
    cos_f, sin_f = cos.float(), sin.float()

    def rope(t):
        return t * cos_f + rotate_half(t.to(x.dtype).float()) * sin_f

    q = rope(y[0]) * scale
    k = rope(y[1])
    return q.to(x.dtype), k.to(x.dtype), y[2].to(x.dtype)


def qkv_project_rope(x, weight, bias, cos, sin, num_heads: int, scale: float):
    """x (B, N, C) -> q, k, v each (B, H, N, D), RoPE'd, q pre-scaled.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: bf16 x/weight/bias, fp32 tables, N and C multiples of 64,
    C <= 1024, D in {32, 64}."""
    if x.device.type == "cpu":
        return qkv_project_rope_plain(x, weight, bias, cos, sin, num_heads,
                                      scale)
    b, n, c = x.shape
    d = c // num_heads
    if (x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16
            or bias.dtype != torch.bfloat16):
        raise ValueError("qkv_project_rope kernel: bf16 x, weight, bias only")
    if n % 64 or c % 64 or c > 1024 or d * num_heads != c or d not in (32, 64):
        raise ValueError(
            f"qkv_project_rope kernel: unsupported N={n} C={c} H={num_heads}")
    if weight.shape != (3 * c, c) or bias.shape != (3 * c,):
        raise ValueError("qkv_project_rope kernel: weight (3C, C), bias (3C,)")
    if cos.shape != (n, d) or sin.shape != (n, d) or cos.dtype != torch.float32:
        raise ValueError("qkv_project_rope kernel: fp32 (N, D) tables")
    x = x.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    q, k, v = (torch.empty((b, num_heads, n, d), device=x.device,
                           dtype=x.dtype) for _ in range(3))
    lib = _build.load_library()
    code = lib.s3od_qkv_project_rope(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b * n, n, c, num_heads, d, float(scale), _build.stream_ptr(x),
    )
    _build.check(code, "qkv_project_rope")
    _build.count_launch(qkv_project_rope)
    return q, k, v


qkv_project_rope.launches = 0


class _QKVProjectRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, cos, sin, num_heads, scale):
        ctx.save_for_backward(x, weight, bias, cos, sin)
        ctx.num_heads, ctx.scale = num_heads, scale
        return qkv_project_rope(x, weight, bias, cos, sin, num_heads, scale)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        fn = lambda *a: qkv_project_rope_plain(*a, ctx.num_heads, ctx.scale)
        return (*plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:5],
                           (gq, gk, gv)), None, None)


# Differentiable `qkv_project_rope`: K2 forward, the plain version's vjp
# backward (linear, `_bwd_rule`); the q pre-scale reaches dq.
qkv_project_rope_autograd = _QKVProjectRope.apply
