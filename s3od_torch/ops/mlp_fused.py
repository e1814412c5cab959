"""K5: the ViT MLP — up-proj + bias, erf-GELU, down-proj + bias, x ls2,
+ residual — as two warp-specialised wgmma GEMMs with fused epilogues
(CUDA), and its plain version, with the plain version of each half.

Replaces the TPU kernel `s3od_tpu/ops/mlp_fused.py:_kernel` (via
`mlp_fused`). The kernel source and its design note are in
`s3od_torch/csrc/mlp_fused.cu`: one call is two device launches, the
up-projection into a (rows, F) bf16 hidden that the wrapper allocates,
then the down-projection with the residual.

Rounding points (the TPU kernel's): both products accumulate in fp32, the
GELU runs on the fp32 up-proj accumulator, the hidden is rounded once to
the compute dtype before the down-proj, and bias, layerscale and residual
are added in fp32 before one rounding. Biases and the layerscale are read
in the compute dtype and widened to fp32. The GELU is the exact erf one
(CUDA's `erff` in the kernel, `torch.erf` here); the TPU kernel uses a
rational approximation within 1.5e-7 of it (`_erf_approx`).

The gate differs from the JAX package's. `fits_vmem` there is a TPU VMEM
limit that sends ViT-L (C = 1024, F = 4096) to the unfused XLA MLP, with
other rounding points. The Hopper kernel streams 64-wide K slices of
both operands, so its shared memory does not grow with C or F and ViT-L
runs through it here.

The kernel is also the registered op `s3od::mlp_fused` (`_build.via_ops`),
whose implementation is `_mlp_fused` and returns (out, h), with the FLOP
formula of its two products, 4 rows C F.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp

# The tile plan of `csrc/mlp_fused.cu`, mirrored so that the CPU tests can
# check it at every shape the repo's configs give the kernel.
ROW_TILE = 128              # rows of an output tile (two consumer warpgroups)
K_TILE = 64                 # K slice of one pipeline stage (one swizzle atom)
TILE_WIDTHS = (256, 192, 128, 64)
THREADS = 384               # producer warpgroup + two consumer warpgroups
PRODUCER_REGS, CONSUMER_REGS = 40, 232
SMS = 132                   # streaming multiprocessors of one H100 SXM
MAX_SMEM = 232448           # bytes of shared memory one H100 block may use
REGISTERS = 65536           # 32-bit registers of one SM


def stages(bn: int) -> int:
    """TMA ring depth at tile width `bn` (the kernel's `stages`)."""
    return 3 if bn == 256 else 4


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of one block at tile width `bn` (the
    kernel's `smem_bytes`): 1024 bytes of alignment slack, the ring of
    A (128 x 64) and B (bn x 64) bf16 stages, the two consumers' 64 x bn
    bf16 staging tiles, a full and an empty mbarrier per stage and a
    residual mbarrier per consumer."""
    return (1024 + stages(bn) * (ROW_TILE + bn) * K_TILE * 2 + 2 * 64 * bn * 2
            + (2 * stages(bn) + 2) * 8)


def pick_bn(m: int, n: int, sms: int = SMS) -> int:
    """The kernel's `pick_bn`: of the tile widths that divide n, the one
    whose waves over `sms` blocks cost least (waves x width), the wider on
    a tie; 0 if none divides n."""
    best, best_cost = 0, 0
    for bn in TILE_WIDTHS:
        if n % bn:
            continue
        tiles = -(-m // ROW_TILE) * (n // bn)
        cost = -(-tiles // sms) * bn
        if best == 0 or cost < best_cost:
            best, best_cost = bn, cost
    return best


def gemm_plan(m: int, n: int, k: int, sms: int = SMS) -> dict:
    """Launch plan of one GEMM (m, k) @ (n, k)^T: tile width, tiles, the
    persistent grid, K blocks, ring stages, shared memory, and the fp32
    accumulator registers a consumer thread holds (64 x bn over 128
    threads)."""
    bn = pick_bn(m, n, sms)
    tiles = -(-m // ROW_TILE) * (n // bn) if bn else 0
    return {"bn": bn, "tiles": tiles, "grid": min(tiles, sms),
            "k_blocks": k // K_TILE, "stages": stages(bn),
            "smem": smem_bytes(bn) if bn else 0, "acc_regs": bn // 2}


def plan(rows: int, c: int, f: int, sms: int = SMS) -> dict:
    """Both launches of one `mlp_fused` call: "up" (rows, C) @ Wu^T ->
    (rows, F), "down" (rows, F) @ Wd^T -> (rows, C)."""
    return {"up": gemm_plan(rows, f, c, sms), "down": gemm_plan(rows, c, f, sms)}


def mlp_up_plain(x_ln, wu, bu):
    """Plain version of the first launch: h = gelu_erf(x @ Wu^T + bu) in
    fp32, rounded once to x's dtype."""
    h = torch.matmul(x_ln.float(), wu.float().t()) + bu.float()
    return F.gelu(h, approximate="none").to(x_ln.dtype)


def mlp_down_plain(h, wd, bd, res, ls):
    """Plain version of the second launch: res + (h @ Wd^T + bd) * ls in
    fp32, rounded once to res's dtype."""
    t = torch.matmul(h.float(), wd.float().t()) + bd.float()
    return (res.float() + t * ls.float()).to(res.dtype)


def mlp_fused_plain(x_ln, wu, bu, wd, bd, res, ls):
    """Plain version of K5: the two halves composed. x_ln, res (..., C);
    wu (F, C), wd (C, F) in nn.Linear layout; bu (F,), bd, ls (C,).
    Returns the new stream in res's dtype."""
    return mlp_down_plain(mlp_up_plain(x_ln, wu, bu), wd, bd, res, ls)


def mlp_fused(x_ln, wu, bu, wd, bd, res, ls, return_hidden: bool = False):
    """res + MLP(x_ln) * ls; with `return_hidden`, (out, h) where h is the
    hidden that the first launch wrote (plain: `mlp_up_plain`).

    CPU tensors take the plain versions. CUDA tensors launch the kernels
    or raise: all bf16, x_ln and res of one shape with at least one row, C
    and F multiples of 64. One call counts one launch of K5 (two device
    launches)."""
    if _build.via_ops():
        out, h = torch.ops.s3od.mlp_fused(x_ln, wu, bu, wd, bd, res, ls)
    else:
        out, h = _mlp_fused(x_ln, wu, bu, wd, bd, res, ls)
    return (out, h) if return_hidden else out


def _mlp_fused(x_ln, wu, bu, wd, bd, res, ls):
    """`mlp_fused`'s implementation, and its op's: -> (out, h)."""
    if x_ln.device.type == "cpu":
        h = mlp_up_plain(x_ln, wu, bu)
        return mlp_down_plain(h, wd, bd, res, ls), h
    c = x_ln.shape[-1]
    f = wu.shape[0]
    rows = x_ln.numel() // c if c else 0
    tensors = (x_ln, wu, bu, wd, bd, res, ls)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("mlp_fused kernel: bf16 inputs only")
    if (res.shape != x_ln.shape or rows == 0 or c == 0 or c % 64 or f == 0
            or f % 64 or wu.shape != (f, c) or wd.shape != (c, f)
            or bu.shape != (f,) or bd.shape != (c,) or ls.shape != (c,)):
        raise ValueError(
            f"mlp_fused kernel: unsupported x={tuple(x_ln.shape)} "
            f"wu={tuple(wu.shape)} wd={tuple(wd.shape)}")
    x_ln, wu, bu, wd, bd, res, ls = (_build.aligned16(t) for t in tensors)
    with _build.launch(mlp_fused):
        out = torch.empty_like(res)
        h = torch.empty((*x_ln.shape[:-1], f), device=x_ln.device,
                        dtype=torch.bfloat16)
        lib = _build.load_library()
        code = lib.s3od_mlp_fused(
            x_ln.data_ptr(), wu.data_ptr(), bu.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), res.data_ptr(), ls.data_ptr(), out.data_ptr(),
            h.data_ptr(), rows, c, f, _build.stream_ptr(x_ln),
        )
        _build.check(code, "mlp_fused")
    return out, h


mlp_fused.launches = 0


def _mlp_fused_op(
        x_ln: torch.Tensor, wu: torch.Tensor, bu: torch.Tensor,
        wd: torch.Tensor, bd: torch.Tensor, res: torch.Tensor,
        ls: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _build.op_outputs(_mlp_fused(x_ln, wu, bu, wd, bd, res, ls))


def _mlp_fused_fake(x_ln, wu, bu, wd, bd, res, ls):
    return (res.new_empty(res.shape),
            x_ln.new_empty((*x_ln.shape[:-1], wu.shape[0])))


_build.register_op("mlp_fused", _mlp_fused_op, _mlp_fused_fake)


@register_flop_formula(torch.ops.s3od.mlp_fused)
def _mlp_fused_flops(x_shape, wu_shape, *args, out_shape=None, **kwargs):
    rows = 1
    for s in x_shape[:-1]:
        rows *= s
    return 4 * rows * x_shape[-1] * wu_shape[0]


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
