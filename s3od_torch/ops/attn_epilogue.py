"""K4: attention epilogue — o_proj over the heads, + bias, x ls1,
+ residual, then LayerNorm(norm2) of the rounded new stream (CUDA) — and
its plain version.

Replaces the TPU kernel `s3od_tpu/ops/attn_epilogue.py:_kernel` (via
`attn_epilogue`). The kernel source and its design note are in
`s3od_torch/csrc/attn_epilogue.cu`.
"""

from __future__ import annotations

import torch

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp
from s3od_torch.ops.layernorm import layer_norm_plain


def attn_epilogue_plain(a, wo, bo, x, ls, lw, lb, eps: float):
    """Plain version of K4. a (B*H, N, D) head-major attention output;
    wo (C, C) nn.Linear layout; x (B, N, C); bo, ls, lw, lb (C,).
    Returns (x', LayerNorm(x')), both in x's dtype."""
    b, n, c = x.shape
    h = a.shape[0] // b
    a2 = a.reshape(b, h, n, c // h).permute(0, 2, 1, 3).reshape(b, n, c)
    t = torch.matmul(a2.float(), wo.float().t()) + bo.float()
    xn = (x.float() + t * ls.float()).to(x.dtype)
    return xn, layer_norm_plain(xn, lw, lb, eps)[0]


def attn_epilogue(a, wo, bo, x, ls, lw, lb, eps: float):
    """(x', LayerNorm_norm2(x')) from the head-major attention output.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: all bf16, N and C multiples of 64, C <= 1024, D in {32, 64}."""
    if x.device.type == "cpu":
        return attn_epilogue_plain(a, wo, bo, x, ls, lw, lb, eps)
    b, n, c = x.shape
    if a.shape[0] % b:
        raise ValueError("attn_epilogue kernel: B*H rows expected")
    h = a.shape[0] // b
    d = c // h
    tensors = (a, wo, bo, x, ls, lw, lb)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("attn_epilogue kernel: bf16 inputs only")
    if (n % 64 or c % 64 or c > 1024 or d * h != c or d not in (32, 64)
            or a.shape != (b * h, n, d) or wo.shape != (c, c)
            or any(t.shape != (c,) for t in (bo, ls, lw, lb))):
        raise ValueError(
            f"attn_epilogue kernel: unsupported a={tuple(a.shape)} "
            f"x={tuple(x.shape)}")
    a, wo, x = a.contiguous(), wo.contiguous(), x.contiguous()
    bo, ls, lw, lb = (t.contiguous() for t in (bo, ls, lw, lb))
    xn = torch.empty_like(x)
    hn = torch.empty_like(x)
    lib = _build.load_library()
    code = lib.s3od_attn_epilogue(
        a.data_ptr(), wo.data_ptr(), bo.data_ptr(), x.data_ptr(),
        ls.data_ptr(), lw.data_ptr(), lb.data_ptr(), xn.data_ptr(),
        hn.data_ptr(), b, n, c, h, d, float(eps), _build.stream_ptr(x),
    )
    _build.check(code, "attn_epilogue")
    _build.count_launch(attn_epilogue)
    return xn, hn


attn_epilogue.launches = 0


class _AttnEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, wo, bo, x, ls, lw, lb, eps):
        ctx.save_for_backward(a, wo, bo, x, ls, lw, lb)
        ctx.eps = eps
        return attn_epilogue(a, wo, bo, x, ls, lw, lb, eps)

    @staticmethod
    def backward(ctx, gx, gh):
        fn = lambda *args: attn_epilogue_plain(*args, ctx.eps)
        return (*plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:7],
                           (gx, gh)), None)


# Differentiable `attn_epilogue` -> (x', h): K4 forward, the plain
# version's vjp backward (`_bwd_rule`).
attn_epilogue_autograd = _AttnEpilogue.apply
