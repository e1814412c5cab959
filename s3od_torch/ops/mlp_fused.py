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

import functools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import mm_f32, scale_rows
from s3od_torch.profiling import span

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


# The backward's elementwise pass (`gelu_bwd`): tiles of rows x F columns.
BWD_ROWS, BWD_COLS = 64, 128


def gelu_bwd_plain(u, dh, bu):
    """Plain version of `gelu_bwd`. u (rows, F) fp32: the up-projection
    recomputed without its bias; dh (rows, F) fp32: the hidden's
    cotangent; bu (F,). With z = u + bu in fp32, returns du = dh *
    gelu_erf'(z) and h = gelu_erf(z), both rounded once to bu's dtype (h
    at the forward's rounding point), and du's column sums in fp32."""
    z = u + bu.float()
    cdf = 0.5 * (1.0 + torch.erf(z * 2.0**-0.5))
    du = dh * (cdf + z * torch.exp(-0.5 * z * z) * (2.0 * torch.pi) ** -0.5)
    return du.to(bu.dtype), F.gelu(z, approximate="none").to(bu.dtype), du.sum(0)


@functools.lru_cache(maxsize=1)
def _triton_gelu_bwd():
    import triton
    import triton.language as tl

    @triton.jit
    def _gelu_bwd(U, DH, BU, DU, H, PART, R, F, BLOCK_R: tl.constexpr,
                  BLOCK_F: tl.constexpr):
        pr = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
        rows = pr * BLOCK_R + tl.arange(0, BLOCK_R)
        cmask = cols < F
        mask = (rows < R)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * F + cols[None, :]
        bu = tl.load(BU + cols, mask=cmask, other=0.0).to(tl.float32)
        z = tl.load(U + offs, mask=mask, other=0.0) + bu[None, :]
        dh = tl.load(DH + offs, mask=mask, other=0.0)
        cdf = 0.5 * (1.0 + tl.math.erf(z * 0.70710678118654752))
        du = dh * (cdf + z * tl.exp(-0.5 * z * z) * 0.3989422804014327)
        tl.store(DU + offs, du.to(DU.dtype.element_ty), mask=mask)
        tl.store(H + offs, (z * cdf).to(H.dtype.element_ty), mask=mask)
        tl.store(PART + pr.to(tl.int64) * F + cols, tl.sum(du, axis=0),
                 mask=cmask)

    return triton, _gelu_bwd


def gelu_bwd(u, dh, bu):
    """K5's backward pass over the hidden: one read of u and dh, one write
    of du and h, and du's column sums — `gelu_bwd_plain` as one Triton
    kernel on CUDA tensors (fp32 u and dh, bf16 bu), the plain version
    on CPU tensors. Memory-bound: 8 bytes in and 4 out an element (at
    ViT-B 1024² b4, (16640, 3072): 613 MB, 0.18 ms at 3.35 TB/s). The
    column sums go through a (row tiles, F) fp32 buffer summed after,
    not atomics, so the gradient is the same from run to run."""
    if u.device.type == "cpu":
        return gelu_bwd_plain(u, dh, bu)
    rows, f = u.shape
    if (u.dtype != torch.float32 or dh.dtype != torch.float32
            or dh.shape != u.shape or bu.shape != (f,)):
        raise ValueError(f"gelu_bwd kernel: fp32 u, dh {tuple(u.shape)}, "
                         f"bias {tuple(bu.shape)}")
    u, dh, bu = u.contiguous(), dh.contiguous(), bu.contiguous()
    tiles = -(-rows // BWD_ROWS)
    with _build.launch(gelu_bwd):
        du = torch.empty(u.shape, device=u.device, dtype=bu.dtype)
        h = torch.empty_like(du)
        part = torch.empty((tiles, f), device=u.device, dtype=torch.float32)
        triton, kernel = _triton_gelu_bwd()
        with _build.triton_cache():
            kernel[(tiles, triton.cdiv(f, BWD_COLS))](
                u, dh, bu, du, h, part, rows, f, BLOCK_R=BWD_ROWS,
                BLOCK_F=BWD_COLS, num_warps=8)
    return du, h, part.sum(0)


gelu_bwd.launches = 0


def mlp_fused_vjp(g, x_ln, wu, bu, wd, bd, res, ls, needs):
    """The vjp of `mlp_fused_plain` at its inputs against g (the output's
    cotangent), one gradient per input in its dtype, None where `needs`
    is False. With u = x Wu^T (recomputed: the only product that is),
    h = gelu(u + bu), t = h Wd^T + bd, out = res + t ⊙ ls:

    dh = g (ls ⊙ Wd); du, h, Σ du = `gelu_bwd`; dx = du Wu;
    dWu = du^T x; dbu = Σ du; S = g^T h (fp32); dWd = ls ⊙ S;
    dbd = ls ⊙ Σ g; dres = g; dls = Σ_f Wd ⊙ S + bd ⊙ Σ g, which is
    Σ_rows g ⊙ t without recomputing t.

    Each product takes operands in the input dtype and accumulates in
    fp32 (`mm_f32`), and each gradient is rounded once."""
    n_x, n_wu, n_bu, n_wd, n_bd, n_res, n_ls = needs
    c = x_ln.shape[-1]
    x2, g2 = x_ln.reshape(-1, c), g.reshape(-1, c)
    grads = [None] * 7
    if n_x or n_wu or n_bu or n_wd or n_ls:
        u = mm_f32(x2, wu.t())
        dh = mm_f32(g2, scale_rows(ls, wd))
        du, h, dbu = gelu_bwd(u, dh, bu)
        del u, dh
        if n_x:
            grads[0] = mm_f32(du, wu).to(x_ln.dtype).view(x_ln.shape)
        if n_wu:
            grads[1] = mm_f32(du.t(), x2).to(wu.dtype)
        if n_bu:
            grads[2] = dbu.to(bu.dtype)
        del du
    gs = g2.sum(0, dtype=torch.float32) if n_bd or n_ls else None
    s = mm_f32(g2.t(), h) if n_wd or n_ls else None
    # a bf16 operand times an fp32 one is computed in fp32
    if n_wd:
        grads[3] = (s * ls.float()[:, None]).to(wd.dtype)
    if n_bd:
        grads[4] = (gs * ls).to(bd.dtype)
    if n_res:
        grads[5] = g.to(res.dtype)
    if n_ls:
        grads[6] = ((wd * s).sum(1) + bd * gs).to(ls.dtype)
    return tuple(grads)


class _MLPFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_ln, wu, bu, wd, bd, res, ls):
        ctx.save_for_backward(x_ln, wu, bu, wd, bd, res, ls)
        return mlp_fused(x_ln, wu, bu, wd, bd, res, ls)

    @staticmethod
    def backward(ctx, g):
        # Unpacked before the span: under per-block remat the first unpack
        # replays the block's forward, which is not this vjp's work.
        saved = ctx.saved_tensors
        with span("s3od.vjp.mlp_fused"):
            return mlp_fused_vjp(g, *saved, ctx.needs_input_grad)


# Differentiable `mlp_fused`: K5 forward, `mlp_fused_vjp` backward (the
# vjp of `_bwd_rule`'s reference, written out).
mlp_fused_autograd = _MLPFused.apply
