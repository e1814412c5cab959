"""K5: fused ViT MLP — up-proj + bias, erf-GELU, down-proj + bias, x ls2,
+ residual, with the (rows, 4C) hidden kept on chip (CUDA) — and its plain
version.

Replaces the TPU kernel `s3od_tpu/ops/mlp_fused.py:_kernel` (via
`mlp_fused`). The kernel source and its design note are in
`s3od_torch/csrc/mlp_fused.cu`.

Rounding points (the TPU kernel's): both products accumulate in fp32, the
GELU runs on the fp32 up-proj accumulator, the hidden is rounded once to
the compute dtype before the down-proj, and bias, layerscale and residual
are added in fp32 before one rounding. Biases and the layerscale are read
in the compute dtype and widened to fp32. The GELU is the exact erf one
(CUDA's `erff` in the kernel, `torch.erf` here); the TPU kernel uses a
rational approximation within 1.5e-7 of it (`_erf_approx`).

The gate differs from the JAX package's. `fits_vmem` there is a TPU VMEM
limit that sends ViT-L (C = 1024, F = 4096) to the unfused XLA MLP, with
other rounding points. The Hopper kernel keeps one C-wide row tile in
shared memory instead (`smem_bytes`), which fits up to C = 1024, so ViT-L
runs fused here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp

ROW_TILE = 32       # rows per block
HIDDEN_CHUNK = 32  # hidden columns per step of the F loop
MAX_SMEM = 232448  # bytes of shared memory one H100 block may use


def smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block at width `c` (mirrors the
    kernel's `smem_bytes`): X and one Wu chunk (32 x (C + 8) each), one Wd
    chunk ((C + 16) x 40), the hidden (32 x 40) in bf16; two fp32 partial
    tiles (32 x 40)."""
    bf16 = 2 * (2 * ROW_TILE * (c + 8) + (c + 16) * 40 + ROW_TILE * 40)
    return bf16 + 4 * 2 * ROW_TILE * 40


def mlp_fused_plain(x_ln, wu, bu, wd, bd, res, ls):
    """Plain version of K5. x_ln, res (..., C); wu (F, C), wd (C, F) in
    nn.Linear layout; bu (F,), bd, ls (C,). Returns the new stream in
    res's dtype."""
    h = torch.matmul(x_ln.float(), wu.float().t()) + bu.float()
    h = F.gelu(h, approximate="none").to(x_ln.dtype)
    t = torch.matmul(h.float(), wd.float().t()) + bd.float()
    return (res.float() + t * ls.float()).to(res.dtype)


def mlp_fused(x_ln, wu, bu, wd, bd, res, ls):
    """res + MLP(x_ln) * ls with the hidden on chip.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: all bf16, x_ln and res of one shape with rows a multiple of 32,
    C a multiple of 64 up to 1024, F a multiple of 32."""
    if x_ln.device.type == "cpu":
        return mlp_fused_plain(x_ln, wu, bu, wd, bd, res, ls)
    c = x_ln.shape[-1]
    f = wu.shape[0]
    rows = x_ln.numel() // c if c else 0
    tensors = (x_ln, wu, bu, wd, bd, res, ls)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("mlp_fused kernel: bf16 inputs only")
    if (res.shape != x_ln.shape or rows % ROW_TILE or c % 64 or c > 1024
            or f % HIDDEN_CHUNK or f == 0 or wu.shape != (f, c)
            or wd.shape != (c, f) or bu.shape != (f,)
            or bd.shape != (c,) or ls.shape != (c,)
            or smem_bytes(c) > MAX_SMEM):
        raise ValueError(
            f"mlp_fused kernel: unsupported x={tuple(x_ln.shape)} "
            f"wu={tuple(wu.shape)} wd={tuple(wd.shape)}")
    x_ln, wu, bu, wd, bd, res, ls = (t.contiguous() for t in tensors)
    out = torch.empty_like(res)
    lib = _build.load_library()
    code = lib.s3od_mlp_fused(
        x_ln.data_ptr(), wu.data_ptr(), bu.data_ptr(), wd.data_ptr(),
        bd.data_ptr(), res.data_ptr(), ls.data_ptr(), out.data_ptr(),
        rows, c, f, _build.stream_ptr(x_ln),
    )
    _build.check(code, "mlp_fused")
    _build.count_launch(mlp_fused)
    return out


mlp_fused.launches = 0


class _MLPFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_ln, wu, bu, wd, bd, res, ls):
        ctx.save_for_backward(x_ln, wu, bu, wd, bd, res, ls)
        return mlp_fused(x_ln, wu, bu, wd, bd, res, ls)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(mlp_fused_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, (g,))


# Differentiable `mlp_fused`: K5 forward, the plain version's vjp backward
# (`_bwd_rule`).
mlp_fused_autograd = _MLPFused.apply
