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

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import mm_f32
from s3od_torch.profiling import span

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


# The backward's elementwise pass (`rope_bwd`): tokens a program.
BWD_TOKENS = 64


def rope_bwd_plain(gq, gk, gv, cos, sin, scale: float):
    """Plain version of `rope_bwd`. gq, gk, gv (B, H, N, D): the
    cotangents of q, k, v; cos, sin (N, D) fp32. RoPE's transpose in
    fp32: dt = g cos - rotate_half(g sin), the rounding before the
    rotation passing the cotangent through, and q's pre-scale applied to
    gq. Returns dy (B * N, 3C), the cotangent of the projection's output
    in its (3, H, D) column order, rounded once to gq's dtype, and its
    column sums in fp32."""
    b, h, n, d = gq.shape
    cos_f, sin_f = cos.float(), sin.float()

    def unrope(g):
        return g * cos_f - rotate_half(g * sin_f)

    dy = torch.stack([unrope(gq.float() * scale), unrope(gk.float()),
                      gv.float()])                      # (3, B, H, N, D)
    dy = dy.permute(1, 3, 0, 2, 4).reshape(b * n, 3 * h * d)
    return dy.to(gq.dtype), dy.sum(0)


@functools.lru_cache(maxsize=1)
def _triton_rope_bwd():
    import triton
    import triton.language as tl

    @triton.jit
    def _rope_bwd(GQ, GK, GV, COS, SIN, DY, PART, N, H, scale,
                  BLOCK_N: tl.constexpr, D: tl.constexpr):
        pid = tl.program_id(0)              # batch element x token block
        which = tl.program_id(1) // H       # 0 q, 1 k, 2 v
        hh = tl.program_id(1) % H
        blocks = tl.cdiv(N, BLOCK_N)
        b = pid // blocks
        ns = (pid % blocks) * BLOCK_N + tl.arange(0, BLOCK_N)
        j = tl.arange(0, D)
        p = (j + D // 2) % D                # the partner rotate_half pairs
        m = (ns < N)[:, None]
        src = ((b * H + hh) * N + ns).to(tl.int64)[:, None] * D
        tab = ns.to(tl.int64)[:, None] * D
        if which == 2:
            dt = tl.load(GV + src + j[None, :], mask=m, other=0.0).to(tl.float32)
        else:
            if which == 0:
                g = tl.load(GQ + src + j[None, :], mask=m, other=0.0).to(tl.float32) * scale
                gp = tl.load(GQ + src + p[None, :], mask=m, other=0.0).to(tl.float32) * scale
            else:
                g = tl.load(GK + src + j[None, :], mask=m, other=0.0).to(tl.float32)
                gp = tl.load(GK + src + p[None, :], mask=m, other=0.0).to(tl.float32)
            cs = tl.load(COS + tab + j[None, :], mask=m, other=0.0)
            sp = tl.load(SIN + tab + p[None, :], mask=m, other=0.0)
            sign = tl.where(j < D // 2, 1.0, -1.0)
            dt = g * cs + sign[None, :] * gp * sp
        col = (which * H + hh) * D + j
        dst = ((b * N + ns).to(tl.int64) * (3 * H * D))[:, None] + col[None, :]
        tl.store(DY + dst, dt.to(DY.dtype.element_ty), mask=m)
        tl.store(PART + pid.to(tl.int64) * (3 * H * D) + col, tl.sum(dt, axis=0))

    return triton, _rope_bwd


def rope_bwd(gq, gk, gv, cos, sin, scale: float):
    """K2's backward pass: RoPE's transpose of q's and k's cotangents, v's
    copied, into the projection's (B * N, 3C) layout, and the column sums
    — `rope_bwd_plain` as one Triton kernel on CUDA tensors (bf16
    cotangents, fp32 tables, D a power of two), the plain version on CPU
    tensors.
    Memory-bound: each cotangent read once (with its partner half from
    L1/L2) and dy written once (at ViT-B 1024² b4, 2 x 76.7 MB, ~0.05 ms
    at 3.35 TB/s). One program is BWD_TOKENS tokens of one head of one of
    q, k, v; the column sums go through a (programs along the tokens,
    3C) fp32 buffer summed after, not atomics."""
    if gq.device.type == "cpu":
        return rope_bwd_plain(gq, gk, gv, cos, sin, scale)
    b, h, n, d = gq.shape
    if (gk.shape != gq.shape or gv.shape != gq.shape or d & (d - 1)
            or cos.shape != (n, d) or sin.shape != (n, d)
            or cos.dtype != torch.float32 or sin.dtype != torch.float32):
        raise ValueError(f"rope_bwd kernel: unsupported g {tuple(gq.shape)}")
    gq, gk, gv, cos, sin = (t.contiguous() for t in (gq, gk, gv, cos, sin))
    blocks = b * -(-n // BWD_TOKENS)
    with _build.launch(rope_bwd):
        dy = torch.empty((b * n, 3 * h * d), device=gq.device, dtype=gq.dtype)
        part = torch.empty((blocks, 3 * h * d), device=gq.device,
                           dtype=torch.float32)
        triton, kernel = _triton_rope_bwd()
        with _build.triton_cache():
            kernel[(blocks, 3 * h)](gq, gk, gv, cos, sin, dy, part, n, h,
                                    float(scale), BLOCK_N=BWD_TOKENS, D=d,
                                    num_warps=4)
    return dy, part.sum(0)


rope_bwd.launches = 0


def qkv_project_rope_vjp(gq, gk, gv, x, weight, bias, cos, sin,
                         scale: float, needs):
    """The vjp of `qkv_project_rope_plain` with respect to x, weight and
    bias (None where `needs` is False): the op is linear in the product
    y = x W^T + b, so nothing is recomputed. dy, Σ dy = `rope_bwd`;
    dx = dy W; dW = dy^T x; db = Σ dy. Each product takes operands in the
    input dtype and accumulates in fp32 (`mm_f32`); each gradient is
    rounded once."""
    n_x, n_w, n_b = needs
    dy, db = rope_bwd(gq, gk, gv, cos, sin, scale)
    dx = mm_f32(dy, weight).to(x.dtype).view(x.shape) if n_x else None
    dw = (mm_f32(dy.t(), x.reshape(-1, x.shape[-1])).to(weight.dtype)
          if n_w else None)
    return dx, dw, db.to(bias.dtype) if n_b else None


class _QKVProjectRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, cos, sin, num_heads, scale):
        ctx.save_for_backward(x, weight, bias, cos, sin)
        ctx.scale = scale
        return qkv_project_rope(x, weight, bias, cos, sin, num_heads, scale)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if any(ctx.needs_input_grad[3:5]):
            raise NotImplementedError(
                "qkv_project_rope: the RoPE tables take no gradient")
        saved = ctx.saved_tensors  # before the span, as in `_MLPFused`
        with span("s3od.vjp.qkv_project_rope"):
            return (*qkv_project_rope_vjp(gq, gk, gv, *saved, ctx.scale,
                                          ctx.needs_input_grad[:3]),
                    None, None, None, None)


# Differentiable `qkv_project_rope`: K2 forward, `qkv_project_rope_vjp`
# backward (the vjp of `_bwd_rule`'s linear reference, written out); the
# q pre-scale reaches dq.
qkv_project_rope_autograd = _QKVProjectRope.apply
