"""The DPT mask heads' logits tail: from the fused 3x3 conv's output,
before its bias, to the masks' logits. The 3x3's bias, the ReLU, the
block-diagonal 1x1 conv (one (1, inter) filter a head) and its bias, as
one Triton pass (`mask_logits`), with its backward as a second
(`mask_logits_bwd`), and the plain versions of both.

Replaces no TPU kernel: the JAX package writes the tail as a dense 1x1
conv on the training path (`s3od_tpu/models/dpt.py:389-395`) and leaves it
to XLA. Eager PyTorch runs it as the bias in the 3x3's epilogue, a ReLU
pass over the full-resolution hidden map, cuDNN's grouped 1x1 conv, and in
the backward cuDNN's grouped direct dgrad (which writes the hidden map's
gradient), the ReLU's `threshold_backward` (a second full-size pass), the
1x1's weight gradient and a 96-channel bias reduction over the 3x3's
output gradient.

Bound on the H100: memory. At ViT-B 1024^2, batch 4 (3 heads of 32
channels), the forward reads the (4, 96, 1024, 1024) bf16 `pre` once (805
MB) and writes the (4, 3, 1024, 1024) logits (25 MB): 0.83 GB, 0.25 ms at
3.35 TB/s. The backward reads `pre` and the logits' gradient and writes
`pre`'s gradient once: 1.64 GB, 0.49 ms. Nothing of the hidden map is
written in either direction. On the card the decoder's maps reach the
head channels_last, so the passes read and write every map at its own
strides and keep its memory format (an NCHW copy of `pre` each way, and
an NCHW gradient that sent the decoder's backward through format
conversions, cost ~24 ms a training step). A program is one image and
64 pixels, and takes all heads' channels of them at once, so on a
channels_last map its tile is one contiguous run; the forward sums each
head's channels in registers, the backward sums the tile's gradient, and
its products with the logits' gradient, over the pixels into
per-program fp32 partials of the three parameter gradients, summed
afterwards (no atomics). On an H100 80GB at 700 W the forward takes 0.34
ms (73% of the bound) and the backward 0.78 ms (63%); a tile a head read
0.40 / 0.85 ms.

Precision: bf16 in and out, fp32 inside. The forward adds the 3x3's bias
to the bf16 `pre` in fp32 and rounds the logits once; the backward
rounds `pre`'s gradient once (dm w, a product of two bf16 values, is
exact in fp32, so it equals the chain's bf16 dgrad) and keeps the
parameter gradients in fp32 until they are cast to the parameters'
dtype.

`triton` is imported only when a kernel launches. CPU tensors take the
plain versions. The forward is also the op `s3od::mask_logits`
(`_build.via_ops`), so that the serving graphs export through it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build

# pixels of a program, and its warps (both passes)
BLOCK, WARPS = 64, 2


# ----------------------------------------------------------------------------
# The plain versions
# ----------------------------------------------------------------------------


def mask_logits_plain(pre, b_fused, w1, b1):
    """The logits (B, n, H, W) in `pre`'s dtype: b1[g] + sum_c w1[g, c]
    relu(pre[:, g inter + c] + b_fused[g inter + c]), in fp32. pre (B,
    n inter, H, W); b_fused (n inter,); w1 (n, inter); b1 (n,)."""
    n, inter = w1.shape
    h = F.relu(pre.float() + b_fused.float()[:, None, None])
    return F.conv2d(h, w1.float().reshape(n, inter, 1, 1), b1.float(),
                    groups=n).to(pre.dtype)


def mask_logits_bwd_plain(dm, pre, b_fused, w1):
    """Plain version of `mask_logits_bwd`, in fp32. dm: the logits'
    gradient (B, n, H, W). Returns (dpre in `pre`'s dtype, and in fp32
    db_fused (n inter,), dw1 (n, inter), db1 (n,)): dpre = dm[g] w1[g, c]
    [pre + b_fused > 0]; dw1 the sum over pixels of dm relu(pre +
    b_fused); db_fused of dpre; db1 of dm."""
    n, inter = w1.shape
    s = pre.float() + b_fused.float()[:, None, None]
    dmc = dm.float().repeat_interleave(inter, dim=1)
    d = torch.where(s > 0, dmc * w1.float().reshape(-1)[:, None, None], 0.0)
    dw1 = (dmc * s.clamp_min(0)).sum((0, 2, 3)).reshape(n, inter)
    return (d.to(pre.dtype), d.sum((0, 2, 3)), dw1,
            dm.float().sum((0, 2, 3)))


# ----------------------------------------------------------------------------
# The Triton passes
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _triton_kernels():
    import triton
    import triton.language as tl

    # Both kernels: program (pixel block, image b), a tile of (pixels, all
    # heads' channels), the channels padded to NP heads (a power of two)
    # of INTER and masked. PRE, DPRE (B, N INTER, HW) and M, DM (B, N, HW)
    # are read and written at their own (batch, channel, pixel) strides,
    # so channels_last and NCHW run without a copy (Triton specializes the
    # unit stride and coalesces the tile along it); BF (N INTER,), W1
    # (N INTER,) and B1 (N,) are fp32.

    @triton.jit
    def _fwd(PRE, BF, W1, B1, M, HW, SXB, SXC, SXP, SMB, SMC, SMP,
             N: tl.constexpr, NP: tl.constexpr, INTER: tl.constexpr,
             BLOCK: tl.constexpr):
        b = tl.program_id(1).to(tl.int64)
        p = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        pp = p.to(tl.int64)[:, None]
        keep = (p < HW)[:, None]
        c = tl.arange(0, NP * INTER)
        cm = c < N * INTER
        g = tl.arange(0, NP)
        x = tl.load(PRE + b * SXB + pp * SXP + (c * SXC)[None, :],
                    mask=keep & cm[None, :], other=0.0).to(tl.float32)
        h = tl.maximum(x + tl.load(BF + c, mask=cm, other=0.0)[None, :], 0.0)
        hw = h * tl.load(W1 + c, mask=cm, other=0.0)[None, :]
        m = (tl.sum(tl.reshape(hw, (BLOCK, NP, INTER)), axis=2)
             + tl.load(B1 + g, mask=g < N, other=0.0)[None, :])
        tl.store(M + b * SMB + pp * SMP + (g * SMC)[None, :],
                 m.to(M.dtype.element_ty), mask=keep & (g < N)[None, :])

    @triton.jit
    def _bwd(PRE, BF, W1, DM, DPRE, PART, HW, SXB, SXC, SXP, SDB, SDC, SDP,
             N: tl.constexpr, NP: tl.constexpr, INTER: tl.constexpr,
             BLOCK: tl.constexpr):
        b = tl.program_id(1).to(tl.int64)
        p = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        pp = p.to(tl.int64)[:, None]
        keep = (p < HW)[:, None]
        c = tl.arange(0, NP * INTER)
        cm = c < N * INTER
        g = tl.arange(0, NP)
        dm = tl.load(DM + b * SDB + pp * SDP + (g * SDC)[None, :],
                     mask=keep & (g < N)[None, :], other=0.0).to(tl.float32)
        # each head's gradient beside its INTER channels
        dmc = tl.reshape(tl.broadcast_to(dm[:, :, None], (BLOCK, NP, INTER)),
                         (BLOCK, NP * INTER))
        at = b * SXB + pp * SXP + (c * SXC)[None, :]
        s = (tl.load(PRE + at, mask=keep & cm[None, :], other=0.0).to(tl.float32)
             + tl.load(BF + c, mask=cm, other=0.0)[None, :])
        d = tl.where(s > 0.0, dmc * tl.load(W1 + c, mask=cm, other=0.0)[None, :],
                     0.0)
        tl.store(DPRE + at, d.to(DPRE.dtype.element_ty), mask=keep & cm[None, :])
        # the program's partials: dw1 (N INTER), db_fused (N INTER), db1 (N)
        pid = tl.program_id(1) * tl.num_programs(0) + tl.program_id(0)
        part = PART + pid.to(tl.int64) * (2 * N * INTER + N)
        tl.store(part + c, tl.sum(dmc * tl.maximum(s, 0.0), axis=0), mask=cm)
        tl.store(part + N * INTER + c, tl.sum(d, axis=0), mask=cm)
        tl.store(part + 2 * N * INTER + g, tl.sum(dm, axis=0), mask=g < N)

    return triton, _fwd, _bwd


def _layout(pre, b_fused, w1, b1=None):
    """(B, n, inter, H W) after the checks the kernels need: a bf16
    (B, n inter, H, W) `pre`, a power-of-two `inter`."""
    n, inter = w1.shape
    if (pre.dtype != torch.bfloat16 or pre.dim() != 4
            or pre.shape[1] != n * inter or inter & (inter - 1)
            or tuple(b_fused.shape) != (n * inter,)
            or (b1 is not None and tuple(b1.shape) != (n,))):
        raise ValueError(f"mask_logits kernel: unsupported pre {pre.dtype} "
                         f"{tuple(pre.shape)}, w1 {tuple(w1.shape)}")
    bsz, _, h, w = pre.shape
    return bsz, n, inter, h * w


def _pixel_strides(t) -> Tuple[int, int, int]:
    """The (batch, channel, pixel) strides of a 4-D NCHW or channels_last
    tensor, whose H and W flatten into one pixel axis either way."""
    sb, sc, sh, sw = t.stride()
    return sb, sc, (sw if t.shape[3] > 1 else sh)


def _channels_last(t) -> bool:
    return (not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _dense(t):
    """`t` if it is NCHW or channels_last, else an NCHW copy."""
    return t if t.is_contiguous() or _channels_last(t) else t.contiguous()


def _fp32(*ts):
    return tuple(t.detach().float().reshape(-1).contiguous() for t in ts)


def mask_logits(pre, b_fused, w1, b1):
    """`mask_logits_plain` as one Triton pass on CUDA tensors: pre a bf16
    (B, n inter, H, W), the fused 3x3's output before its bias, NCHW or
    channels_last; b_fused (n inter,), w1 (n, inter), b1 (n,) of any float
    dtype. Returns the logits (B, n, H, W) bf16, in `pre`'s memory format.
    CPU tensors take the plain version."""
    if _build.via_ops():
        return torch.ops.s3od.mask_logits(pre, b_fused, w1, b1)
    return _mask_logits(pre, b_fused, w1, b1)


def _mask_logits(pre, b_fused, w1, b1):
    """`mask_logits`'s implementation, and its op's."""
    if pre.device.type == "cpu":
        return mask_logits_plain(pre, b_fused, w1, b1)
    bsz, n, inter, hw = _layout(pre, b_fused, w1, b1)
    pre = _dense(pre)
    fmt = (torch.channels_last if _channels_last(pre)
           else torch.contiguous_format)
    with _build.launch(mask_logits):
        out = torch.empty((bsz, n, *pre.shape[2:]), device=pre.device,
                          dtype=pre.dtype, memory_format=fmt)
        triton, kernel, _ = _triton_kernels()
        with _build.triton_cache():
            kernel[(triton.cdiv(hw, BLOCK), bsz)](
                pre, *_fp32(b_fused, w1, b1), out, hw, *_pixel_strides(pre),
                *_pixel_strides(out), N=n, NP=triton.next_power_of_2(n),
                INTER=inter, BLOCK=BLOCK, num_warps=WARPS)
    return out


mask_logits.launches = 0


def mask_logits_bwd(dm, pre, b_fused, w1):
    """`mask_logits`'s backward, `mask_logits_bwd_plain` as one Triton pass
    on CUDA tensors: reads dm (B, n, H, W) and the saved bf16 `pre`, writes
    dpre once, in `pre`'s memory format; db_fused, dw1 and db1 (fp32) from
    per-program fp32 partial sums, summed after."""
    if pre.device.type == "cpu":
        return mask_logits_bwd_plain(dm, pre, b_fused, w1)
    bsz, n, inter, hw = _layout(pre, b_fused, w1)
    if tuple(dm.shape) != (bsz, n, *pre.shape[2:]):
        raise ValueError(f"mask_logits_bwd kernel: unsupported dm "
                         f"{tuple(dm.shape)}")
    pre, dm = _dense(pre), _dense(dm)
    with _build.launch(mask_logits_bwd):
        triton, _, kernel = _triton_kernels()
        grid = (triton.cdiv(hw, BLOCK), bsz)
        dpre = torch.empty_like(pre)
        part = torch.empty((grid[0] * bsz, 2 * n * inter + n),
                           device=pre.device, dtype=torch.float32)
        with _build.triton_cache():
            kernel[grid](pre, *_fp32(b_fused, w1), dm, dpre, part, hw,
                         *_pixel_strides(pre), *_pixel_strides(dm), N=n,
                         NP=triton.next_power_of_2(n), INTER=inter,
                         BLOCK=BLOCK, num_warps=WARPS)
    sums = part.sum(0)
    c = n * inter
    return dpre, sums[c: 2 * c], sums[:c].reshape(n, inter), sums[2 * c:]


mask_logits_bwd.launches = 0


def _mask_logits_op(pre: torch.Tensor, b_fused: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    return _build.op_outputs(_mask_logits(pre, b_fused, w1, b1))


def _mask_logits_fake(pre, b_fused, w1, b1):
    return pre.new_empty((pre.shape[0], w1.shape[0], *pre.shape[2:]))


_build.register_op("mask_logits", _mask_logits_op, _mask_logits_fake)


@register_flop_formula(torch.ops.s3od.mask_logits)
def _mask_logits_flops(pre_shape, *args, out_shape=None, **kwargs):
    """The block-diagonal 1x1 conv's products, as for the grouped conv."""
    bsz, c, h, w = pre_shape
    return 2 * bsz * c * h * w


class _MaskLogits(torch.autograd.Function):
    """`mask_logits` forward, `mask_logits_bwd` backward. Saves `pre`
    (the bf16 3x3 output the chain's ReLU kept as its output) and the
    3x3's bias and the 1x1's weights: no fp32 copy, no hidden map."""

    @staticmethod
    def forward(ctx, pre, b_fused, w1, b1):
        ctx.save_for_backward(pre, b_fused, w1)
        ctx.b1_dtype = b1.dtype
        return mask_logits(pre, b_fused, w1, b1)

    @staticmethod
    def backward(ctx, dm):
        pre, b_fused, w1 = ctx.saved_tensors
        dpre, db_fused, dw1, db1 = mask_logits_bwd(dm, pre, b_fused, w1)
        grads = (dpre, db_fused.to(b_fused.dtype), dw1.to(w1.dtype),
                 db1.to(ctx.b1_dtype))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def mask_logits_autograd(pre, b_fused, w1, b1) -> torch.Tensor:
    """The logits, differentiable. CUDA bf16 takes the kernels through
    `_MaskLogits` (without a gradient it runs the forward pass alone, and
    `torch.export` records the op `s3od::mask_logits`); every other route
    the plain version under autograd, as float32 exact mode launches none
    of the port's kernels."""
    if not (pre.is_cuda and pre.dtype == torch.bfloat16):
        return mask_logits_plain(pre, b_fused, w1, b1)
    return _MaskLogits.apply(pre, b_fused, w1, b1)
