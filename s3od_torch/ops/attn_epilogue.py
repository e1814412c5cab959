"""K4: attention epilogue — o_proj over the heads, + bias, x ls1,
+ residual, then LayerNorm(norm2) of the rounded new stream (CUDA) — and
its plain version.

Replaces the TPU kernel `s3od_tpu/ops/attn_epilogue.py:_kernel` (via
`attn_epilogue`). The kernel source and its design note are in
`s3od_torch/csrc/attn_epilogue.cu`.

Two kernels, chosen by an explicit dispatch on D in the C entry point
(`kernel_route`): at D = 64 (ViT-S/B/L) a TMA + wgmma GEMM whose 64-row
tiles are split along the columns over a 2-block cluster that shares the
LayerNorm statistics (`plan` mirrors its launch); at D = 32 (the tiny
checkpoints) the mma.sync kernel.

The kernel is also the registered op `s3od::attn_epilogue`
(`_build.via_ops`), whose implementation is `_attn_epilogue`, with the
FLOP formula of its product, 2 B N C^2.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import mm_f32, scale_rows
from s3od_torch.ops.layernorm import layer_norm_plain
from s3od_torch.profiling import span

# The D = 64 kernel's launch (`csrc/attn_epilogue.cu`), mirrored so that
# the CPU tests can check it at the shapes the repo's configs give it.
ROW_TILE = 64                # rows (tokens of one batch element) a tile
K_TILE = 64                  # K a pipeline stage: one head
MAX_STAGES = 4
CLUSTER = 2                  # blocks of a cluster: a row's two halves
MAX_SMEM = 232448            # bytes of shared memory one H100 block may use
REGISTERS = 65536            # 32-bit registers of one SM
# C -> (consumer warpgroups, columns each): C / 2 a block, in warpgroups
# of at most 256 columns (a wgmma's widest), whole 64-column atoms.
WIDTHS = {128: (1, 64), 256: (1, 128), 384: (1, 192), 512: (1, 256),
          768: (2, 192), 1024: (2, 256)}


def kernel_route(d: int) -> str:
    """Which kernel the C entry point runs at head dim `d`."""
    return {64: "cluster wgmma", 32: "mma.sync"}.get(d, "none")


def regs(nc: int) -> tuple[int, int]:
    """Registers a producer and a consumer thread may hold beside `nc`
    consumer warpgroups: `setmaxnreg`'s split at two; at one there is no
    `setmaxnreg`, and each of the 256 threads may hold 255."""
    return {1: (255, 255), 2: (24, 240)}[nc]


def plan(b: int, n: int, c: int, d: int = 64) -> dict:
    """The launch at x (b, n, c) and head dim d. At D = 32 the mma.sync
    kernel (32 rows x all C a block, two cp.async stages). At D = 64 the
    cluster kernel: 64-row tiles (`row_tiles`), each split over a pair of
    blocks of `block_cols` columns (`blocks` in all before the persistent
    grid's cap), `consumers` warpgroups of `wn` columns a block; the
    ring's stages, shared memory (ring, x staging, the bf16 vectors, the
    statistics, the barriers), and Wo bytes read from L2 a row."""
    if kernel_route(d) == "mma.sync":
        rows_b, ldk = 32, 40
        return {"route": "mma.sync", "block_cols": c, "consumers": 0,
                "grid": b * n // rows_b,
                "smem": 2 * (2 * rows_b * ldk + 2 * (c + 16) * ldk),
                "wo_l2_bytes_a_row": 2 * c * c / rows_b}
    nc, wn = WIDTHS[c]
    bw = nc * wn
    stage = ROW_TILE * K_TILE * 2 + bw * K_TILE * 2
    tail = 4 * bw * 2 + 2 * nc * ROW_TILE * 8 + (2 * MAX_STAGES + 4) * 8
    fixed = 1024 + ROW_TILE * bw * 2 + tail
    stages = min(MAX_STAGES, (MAX_SMEM - fixed) // stage)
    row_tiles = b * n // ROW_TILE
    return {"route": "cluster wgmma", "block_cols": bw, "consumers": nc,
            "wn": wn, "stages": stages, "smem": fixed + stages * stage,
            "row_tiles": row_tiles, "blocks": CLUSTER * row_tiles,
            "acc_regs": wn // 2, "wo_l2_bytes_a_row": 2 * c * c / ROW_TILE}


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
    raise: all bf16, N a multiple of 64; D = 64 with C in `WIDTHS`, or
    D = 32 with C a multiple of 64 up to 1024 (`kernel_route`)."""
    if _build.via_ops():
        return torch.ops.s3od.attn_epilogue(a, wo, bo, x, ls, lw, lb,
                                            float(eps))
    return _attn_epilogue(a, wo, bo, x, ls, lw, lb, eps)


def _attn_epilogue(a, wo, bo, x, ls, lw, lb, eps: float):
    """`attn_epilogue`'s implementation, and its op's."""
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
    route = kernel_route(d)
    width_ok = c in WIDTHS if route == "cluster wgmma" else c % 64 == 0 and c <= 1024
    if (n % 64 or not width_ok or d * h != c or route == "none"
            or a.shape != (b * h, n, d) or wo.shape != (c, c)
            or any(t.shape != (c,) for t in (bo, ls, lw, lb))):
        raise ValueError(
            f"attn_epilogue kernel: unsupported a={tuple(a.shape)} "
            f"x={tuple(x.shape)}")
    a, wo, bo, x, ls, lw, lb = (_build.aligned16(t) for t in tensors)
    with _build.launch(attn_epilogue):
        xn = torch.empty_like(x)
        hn = torch.empty_like(x)
        lib = _build.load_library()
        code = lib.s3od_attn_epilogue(
            a.data_ptr(), wo.data_ptr(), bo.data_ptr(), x.data_ptr(),
            ls.data_ptr(), lw.data_ptr(), lb.data_ptr(), xn.data_ptr(),
            hn.data_ptr(), b, n, c, h, d, float(eps), _build.stream_ptr(x),
        )
        _build.check(code, "attn_epilogue")
    return xn, hn


attn_epilogue.launches = 0


def _attn_epilogue_op(
        a: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, x: torch.Tensor,
        ls: torch.Tensor, lw: torch.Tensor, lb: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    return _build.op_outputs(_attn_epilogue(a, wo, bo, x, ls, lw, lb, eps))


def _attn_epilogue_fake(a, wo, bo, x, ls, lw, lb, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape)


_build.register_op("attn_epilogue", _attn_epilogue_op, _attn_epilogue_fake)


@register_flop_formula(torch.ops.s3od.attn_epilogue)
def _attn_epilogue_flops(a_shape, wo_shape, bo_shape, x_shape, *args,
                         out_shape=None, **kwargs):
    b, n, c = x_shape
    return 2 * b * n * c * wo_shape[0]


# The backward's elementwise pass (`ln_bwd`): rows a program.
BWD_ROWS = 16


def ln_bwd_plain(xn, gx, gh, lw, eps: float):
    """Plain version of `ln_bwd`. xn (..., C): the op's first output x';
    gx, gh: the cotangents of x' and of LayerNorm(x'); lw (C,). With
    LayerNorm's statistics recomputed from x' as the forward takes them
    (fp32 mean and E[x^2], the variance clamped at 0), returns
    dxn = gx + LayerNorm's input cotangent in fp32, rounded once to xn's
    dtype, as (rows, C), and (3, C) fp32 column sums: Σ gh·ŷ (dlw), Σ gh
    (dlb) and Σ dxn (before its rounding)."""
    c = xn.shape[-1]
    x = xn.reshape(-1, c).float()
    gh2 = gh.reshape(-1, c).float()
    m1 = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - m1 * m1
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    y = (x - m1) * rstd
    dy = gh2 * lw.float()
    dvar = (dy * y).mean(-1, keepdim=True) * (var >= 0)
    d = gx.reshape(-1, c).float() + rstd * (dy - dy.mean(-1, keepdim=True)
                                            - y * dvar)
    return d.to(xn.dtype), torch.stack([(gh2 * y).sum(0), gh2.sum(0), d.sum(0)])


@functools.lru_cache(maxsize=1)
def _triton_ln_bwd():
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_bwd(XN, GX, GH, LW, DXN, PART, R, C, eps, ROWS: tl.constexpr,
                BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        cm = cols < C
        lw = tl.load(LW + cols, mask=cm, other=0.0).to(tl.float32)
        sum_gy = tl.zeros([BLOCK], tl.float32)
        sum_g = tl.zeros([BLOCK], tl.float32)
        sum_d = tl.zeros([BLOCK], tl.float32)
        for i in range(ROWS):
            row = pid * ROWS + i
            m = cm & (row < R)
            off = row.to(tl.int64) * C + cols
            x = tl.load(XN + off, mask=m, other=0.0).to(tl.float32)
            m1 = tl.sum(x, axis=0) / C
            var = tl.sum(x * x, axis=0) / C - m1 * m1
            rstd = 1.0 / tl.sqrt(tl.maximum(var, 0.0) + eps)
            y = tl.where(m, (x - m1) * rstd, 0.0)
            gh = tl.load(GH + off, mask=m, other=0.0).to(tl.float32)
            dy = gh * lw
            dvar = tl.where(var >= 0, tl.sum(dy * y, axis=0) / C, 0.0)
            dx = rstd * (dy - tl.sum(dy, axis=0) / C - y * dvar)
            d = tl.where(m, tl.load(GX + off, mask=m, other=0.0).to(tl.float32)
                         + dx, 0.0)
            tl.store(DXN + off, d.to(DXN.dtype.element_ty), mask=m)
            sum_gy += gh * y
            sum_g += gh
            sum_d += d
        base = PART + pid.to(tl.int64) * 3 * C + cols
        tl.store(base, sum_gy, mask=cm)
        tl.store(base + C, sum_g, mask=cm)
        tl.store(base + 2 * C, sum_d, mask=cm)

    return triton, _ln_bwd


def ln_bwd(xn, gx, gh, lw, eps: float):
    """K4's backward pass: LayerNorm's backward on x' with the cotangent
    of x' added, and the column sums — `ln_bwd_plain` as one Triton
    kernel on CUDA tensors (bf16, C up to 1024), the plain version on CPU
    tensors. Memory-bound: three reads and one write of (rows, C) bf16
    (at ViT-B 1024² b4, ~102 MB, ~0.03 ms at 3.35 TB/s). One program
    walks BWD_ROWS rows, one row at a time across its C lanes, keeping
    the column sums in registers; they go through a (programs, 3, C) fp32
    buffer summed after, not atomics."""
    if xn.device.type == "cpu":
        return ln_bwd_plain(xn, gx, gh, lw, eps)
    c = xn.shape[-1]
    if (c > 1024 or gx.shape != xn.shape or gh.shape != xn.shape
            or lw.shape != (c,)):
        raise ValueError(f"ln_bwd kernel: unsupported x' {tuple(xn.shape)}")
    xn, gx, gh, lw = (t.contiguous() for t in (xn, gx, gh, lw))
    rows = xn.numel() // c
    programs = -(-rows // BWD_ROWS)
    with _build.launch(ln_bwd):
        dxn = torch.empty((rows, c), device=xn.device, dtype=xn.dtype)
        part = torch.empty((programs, 3, c), device=xn.device,
                           dtype=torch.float32)
        triton, kernel = _triton_ln_bwd()
        with _build.triton_cache():
            kernel[(programs,)](xn, gx, gh, lw, dxn, part, rows, c, float(eps),
                                ROWS=BWD_ROWS, BLOCK=triton.next_power_of_2(c),
                                num_warps=4)
    return dxn, part.sum(0)


ln_bwd.launches = 0


def attn_epilogue_vjp(gx, gh, a, wo, bo, ls, lw, lb, xn, eps: float, needs):
    """The vjp of `attn_epilogue_plain` at its inputs against gx and gh
    (the cotangents of x' and LayerNorm(x')), one gradient per input
    (a, wo, bo, x, ls, lw, lb) in its dtype, None where `needs` is False.
    x' (the op's output) stands in for the residual input: LayerNorm's
    statistics come from it, and the out-projection t = a Wo^T + bo is
    not recomputed. dxn, Σ = `ln_bwd`; dx = dxn; dlw, dlb from Σ;
    da = dxn (ls ⊙ Wo), back to the head-major layout; S = dxn^T a
    (fp32); dWo = ls ⊙ S; dbo = ls ⊙ Σ dxn; dls = Σ_in Wo ⊙ S +
    bo ⊙ Σ dxn, which is Σ_rows dxn ⊙ t. Each product takes operands in
    the input dtype and accumulates in fp32 (`mm_f32`)."""
    n_a, n_wo, n_bo, n_x, n_ls, n_lw, n_lb = needs
    b, n, c = xn.shape
    h = a.shape[0] // b
    d = c // h
    dxn, sums = ln_bwd(xn, gx, gh, lw, eps)
    grads = [None] * 7
    if n_a:
        da = mm_f32(dxn, scale_rows(ls, wo)).view(b, n, h, d)
        grads[0] = (torch.empty((b, h, n, d), device=a.device, dtype=a.dtype)
                    .copy_(da.permute(0, 2, 1, 3)).view(a.shape))
        del da
    if n_wo or n_ls:
        a2 = a.reshape(b, h, n, d).permute(0, 2, 1, 3).reshape(b * n, c)
        s = mm_f32(dxn.t(), a2)
        del a2
    # a bf16 operand times an fp32 one is computed in fp32
    if n_wo:
        grads[1] = (s * ls.float()[:, None]).to(wo.dtype)
    if n_bo:
        grads[2] = (sums[2] * ls).to(bo.dtype)
    if n_x:
        grads[3] = dxn.view(xn.shape)
    if n_ls:
        grads[4] = ((wo * s).sum(1) + bo * sums[2]).to(ls.dtype)
    if n_lw:
        grads[5] = sums[0].to(lw.dtype)
    if n_lb:
        grads[6] = sums[1].to(lb.dtype)
    return tuple(grads)


class _AttnEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, wo, bo, x, ls, lw, lb, eps):
        xn, hn = attn_epilogue(a, wo, bo, x, ls, lw, lb, eps)
        ctx.save_for_backward(a, wo, bo, ls, lw, lb, xn)
        ctx.eps = eps
        return xn, hn

    @staticmethod
    def backward(ctx, gx, gh):
        saved = ctx.saved_tensors  # before the span, as in `_MLPFused`
        with span("s3od.vjp.attn_epilogue"):
            return (*attn_epilogue_vjp(gx, gh, *saved, ctx.eps,
                                       ctx.needs_input_grad[:7]), None)


# Differentiable `attn_epilogue` -> (x', h): K4 forward, `attn_epilogue_vjp`
# backward (the vjp of `_bwd_rule`'s reference, written out).
attn_epilogue_autograd = _AttnEpilogue.apply
