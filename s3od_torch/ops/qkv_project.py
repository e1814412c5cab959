"""K2: fused QKV projection + RoPE, head-major output (CUDA) and its plain
version.

Replaces the TPU kernel `s3od_tpu/ops/qkv_project.py:_kernel` (via
`qkv_project_rope`). The kernel source and its design note are in
`s3od_torch/csrc/qkv_project.cu`.

The weight is the fused nn.Linear-layout (3C, C) matrix — the q, k and v
projection weights stacked — with the fused (3C,) bias whose key segment
is zero (DINOv3 has no key bias). The TPU kernel's head-pair packing is a
lane layout of the TPU and is not ported.

Two kernels, chosen by an explicit dispatch on D in the C entry point
(`kernel_route`): at D = 64 (ViT-B, ViT-L) a warp-specialised TMA +
wgmma GEMM with the RoPE in its epilogue (`plan` mirrors its launch); at
D = 32 (the tiny checkpoints) the mma.sync kernel.

The kernel is also the registered op `s3od::qkv_project_rope`
(`_build.via_ops`), whose implementation is `_qkv_project_rope`, with the
FLOP formula of its product, 2 B N C 3C.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp

# The D = 64 kernel's launch (`csrc/qkv_project.cu`), mirrored so that the
# CPU tests can check it at the shapes the repo's configs give it.
ROW_TILE = 128               # tokens of a tile: two consumer warpgroups
K_TILE = 64                  # input channels a pipeline stage
TILE_WIDTHS = (192, 128, 64)  # output columns of a tile: whole heads
STAGES = 4
PRODUCER_REGS, CONSUMER_REGS = 40, 232  # a producer and two consumer warpgroups
SMS = 132                    # streaming multiprocessors of one H100 SXM
MAX_SMEM = 232448            # bytes of shared memory one H100 block may use
REGISTERS = 65536            # 32-bit registers of one SM


def kernel_route(d: int) -> str:
    """Which kernel the C entry point runs at head dim `d`."""
    return {64: "wgmma", 32: "mma.sync"}.get(d, "none")


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of one block at tile width `bn`: 1024 bytes
    of alignment slack, the ring of x (128 x 64) and W (bn x 64) bf16
    stages, the two consumers' 64 x bn bf16 staging tiles, a full and an
    empty mbarrier per stage."""
    return (1024 + STAGES * (ROW_TILE + bn) * K_TILE * 2 + 2 * 64 * bn * 2
            + 2 * STAGES * 8)


def pick_bn(c: int, row_tiles: int, sms: int = SMS) -> int:
    """The kernel's `pick_bn`: of the tile widths that divide c (so that a
    tile holds whole heads of one of q, k, v), the one whose waves over
    `sms` blocks cost least (waves x width), the wider on a tie."""
    best, best_cost = 0, 0
    for bn in TILE_WIDTHS:
        if c % bn:
            continue
        cost = -(-(row_tiles * (3 * c // bn)) // sms) * bn
        if best == 0 or cost < best_cost:
            best, best_cost = bn, cost
    return best


def plan(b: int, n: int, c: int, sms: int = SMS) -> dict:
    """The D = 64 launch at x (b, n, c): tiles of 128 tokens of one batch
    element (`row_tiles` a batch element; the last reaches past N, whose
    rows load as zeros and are not stored) by `bn` columns (`col_tiles`
    over the 3C outputs), the persistent grid, K blocks, shared memory,
    and the fp32 accumulator registers a consumer thread holds."""
    row_tiles = -(-n // ROW_TILE)
    bn = pick_bn(c, b * row_tiles, sms)
    col_tiles = 3 * c // bn
    tiles = b * row_tiles * col_tiles
    return {"row_tiles": row_tiles, "bn": bn, "col_tiles": col_tiles,
            "heads_per_tile": bn // 64, "tiles": tiles,
            "grid": min(tiles, sms), "k_blocks": c // K_TILE,
            "smem": smem_bytes(bn), "acc_regs": bn // 2}


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
    C <= 1024, D in {32, 64} (`kernel_route`)."""
    if _build.via_ops():
        return torch.ops.s3od.qkv_project_rope(x, weight, bias, cos, sin,
                                               int(num_heads), float(scale))
    return _qkv_project_rope(x, weight, bias, cos, sin, num_heads, scale)


def _qkv_project_rope(x, weight, bias, cos, sin, num_heads: int, scale: float):
    """`qkv_project_rope`'s implementation, and its op's."""
    if x.device.type == "cpu":
        return qkv_project_rope_plain(x, weight, bias, cos, sin, num_heads,
                                      scale)
    b, n, c = x.shape
    d = c // num_heads
    if (x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16
            or bias.dtype != torch.bfloat16):
        raise ValueError("qkv_project_rope kernel: bf16 x, weight, bias only")
    if (n % 64 or c % 64 or c > 1024 or d * num_heads != c
            or kernel_route(d) == "none"):
        raise ValueError(
            f"qkv_project_rope kernel: unsupported N={n} C={c} H={num_heads}")
    if weight.shape != (3 * c, c) or bias.shape != (3 * c,):
        raise ValueError("qkv_project_rope kernel: weight (3C, C), bias (3C,)")
    if cos.shape != (n, d) or sin.shape != (n, d) or cos.dtype != torch.float32:
        raise ValueError("qkv_project_rope kernel: fp32 (N, D) tables")
    x, weight, bias, cos, sin = (_build.aligned16(t)
                                 for t in (x, weight, bias, cos, sin))
    with _build.launch(qkv_project_rope):
        q, k, v = (torch.empty((b, num_heads, n, d), device=x.device,
                               dtype=x.dtype) for _ in range(3))
        lib = _build.load_library()
        code = lib.s3od_qkv_project_rope(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            b, n, c, num_heads, d, float(scale), _build.stream_ptr(x),
        )
        _build.check(code, "qkv_project_rope")
    return q, k, v


qkv_project_rope.launches = 0


def _qkv_project_rope_op(
        x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
        cos: torch.Tensor, sin: torch.Tensor, num_heads: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _build.op_outputs(_qkv_project_rope(x, weight, bias, cos, sin,
                                               num_heads, scale))


def _qkv_project_rope_fake(x, weight, bias, cos, sin, num_heads, scale):
    b, n, c = x.shape
    shape = (b, num_heads, n, c // num_heads)
    return tuple(x.new_empty(shape) for _ in range(3))


_build.register_op("qkv_project_rope", _qkv_project_rope_op, _qkv_project_rope_fake)


@register_flop_formula(torch.ops.s3od.qkv_project_rope)
def _qkv_project_rope_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    b, n, c = x_shape
    return 2 * b * n * c * w_shape[0]


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
