"""K10: the fused mask-head tail (CUDA) and its plain version.

Replaces the TPU kernel `s3od_tpu/ops/experimental/mask_tail.py:_kernel`
(via `mask_tail`). The kernel source and its design note are in
`s3od_torch/csrc/mask_tail.cu`.

Given x, the mask head's transposed-conv output before its ReLU:
    h1  = relu(conv3x3(relu(x), w1) + b1)     C_in -> C_in, rounded once
    h2  = relu(conv3x3(h1, w0) + b0)          C_in -> C_mid, rounded once
    out = h2 @ k1 + bk                        C_mid -> n_out, rounded once
Rounding points (the TPU kernel's): each product accumulates in fp32; each
bias is read in the compute dtype and added to the fp32 accumulator
before that layer's one rounding, so the unfused chain — which rounds
the conv and the bias add separately — is not bit-equal to it. h1 is
zero outside the image (its ring is masked after the ReLU), as the second
conv's zero padding needs. The output is (B, H, W, n_out) logits in x's
dtype.

Layout: x is (B, H, W, C_in) in NHWC *logical* order with any strides;
the decoder hands in its NCHW tensor as a `permute(0, 2, 3, 1)` view and
gets an output in the same memory order back (`_empty_like_layout`).
Weights HWIO, as in the JAX package. There is no backward, as in JAX:
training keeps the unfused path.

The kernel streams rows through persistent 2-block clusters
(`mask_tail_plan` mirrors its work split for the CPU tests, and
`mask_tail_streamed` computes the function in the kernel's order: strips
of 62 output columns, rolling windows of 3 input rows and 3 h1 rows,
restarted at each run's start and strip change).

The kernel is also the registered op `s3od::mask_tail` (`_build.via_ops`),
whose implementation is `_mask_tail`; its output keeps x's memory order
on every device, and its FLOP formula counts its three products, as the
plain version's two convs and one matmul count them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.experimental.winograd import _empty_like_layout, _in_layout

# (C_in, C_mid) the kernel is built for: the mask head of every ViT config
# but the tiny test ones (inter 32: 64 -> 96).
KERNEL_WIDTHS = (64, 96)
MAX_OUT = 4

# The kernel's tiling (`csrc/mask_tail.cu`): a strip of 62 output columns
# takes 64 h1 positions (one m64 tile) and 66 input pixels; rings of 4
# input rows and 5 h1 rows; one cluster of 2 blocks per pair of SMs.
STRIP = 62
H1_POSITIONS, INPUT_PIXELS = STRIP + 2, STRIP + 4
INPUT_SLOTS, H1_SLOTS = 4, 5
CLUSTERS = 66           # resident on the H100's 132 SMs, one block an SM
MAX_SMEM = 232448       # bytes of shared memory one H100 block may use


def _block_smem() -> int:
    """A block's dynamic shared memory, as `Layout` lays it out: 1024
    bytes of alignment slack, w1's 32 output channels and all of w0 as
    bf16 (9 taps x c_in rows), the two rings of bf16 rows (an h1 row
    padded by 64 bytes that conv2's dropped rows read), b1's 32, b0, k1
    and bk in fp32, and 18 mbarriers."""
    cin, cmid = KERNEL_WIDTHS
    weights = 2 * 9 * cin * (cin // 2 + cmid)
    rings = (2 * INPUT_SLOTS * INPUT_PIXELS * cin
             + 2 * H1_SLOTS * H1_POSITIONS * cin + 64)
    floats = 4 * (cin // 2 + cmid + cmid * MAX_OUT + MAX_OUT)
    return 1024 + weights + rings + floats + 8 * 2 * (INPUT_SLOTS + H1_SLOTS)


def mask_tail_plan(batch: int, h: int, w: int, clusters: int = CLUSTERS) -> dict:
    """K10's work split at (batch, h, w): the (image, strip, row) items,
    row fastest, cut into `clusters` equal contiguous runs (fewer where
    there are fewer items), each run into segments of one (image, strip).
    A segment of `rows` output rows from y0 computes h1 rows y0 - 1 ..
    y0 + rows (its window restarts: 2 rows beyond its outputs) from input
    rows y0 - 2 .. y0 + rows + 1 (4 beyond). Also: a block's shared memory,
    the share of output columns computed past the canvas's width
    (`output_waste`) and the h1 and input rows the runs compute."""
    strips = -(-w // STRIP)
    items = batch * strips * h
    clusters = min(clusters, items)
    runs = []
    for c in range(clusters):
        start, end = items * c // clusters, items * (c + 1) // clusters
        segments, idx = [], start
        while idx < end:
            img, r = divmod(idx, strips * h)
            strip, y0 = divmod(r, h)
            rows = min(end - idx, h - y0)
            segments.append({"image": img, "strip": strip, "y0": y0,
                             "rows": rows, "h1_rows": (y0 - 1, y0 + rows),
                             "input_rows": (y0 - 2, y0 + rows + 1)})
            idx += rows
        runs.append({"start": start, "end": end, "segments": segments})
    return {"strips": strips, "items": items, "clusters": clusters,
            "runs": runs, "smem": _block_smem(),
            "output_waste": strips * STRIP / w - 1,
            "h1_rows": sum(sg["rows"] + 2 for r in runs for sg in r["segments"]),
            "input_rows": sum(sg["rows"] + 4 for r in runs
                              for sg in r["segments"])}


def mask_tail_streamed(x, w1, b1, w0, b0, k1, bk, clusters: int = CLUSTERS):
    """K10's function in the kernel's order (`mask_tail_plan`): per
    segment, each input row is ReLU'd once over the strip's 66 pixels
    (zero outside the image); each h1 row is 9 products of a 3-row input
    window shifted by 0, 1, 2 pixels, bias, ReLU, zero outside the image,
    rounded once; each output row 9 products of a 3-row h1 window, then the
    1x1 on the rounded h2. Accumulation in fp32 as the kernel's; only the
    order of the sums differs from `mask_tail_plain`. Returns (out, plan)."""
    dt = x.dtype
    w1, b1, w0, b0, k1, bk = (t.to(dt) for t in (w1, b1, w0, b0, k1, bk))
    w1f, w0f, k1f = w1.float(), w0.float(), k1.float()
    b1f, b0f, bkf = b1.float(), b0.float(), bk.float()
    bsz, h, w, cin = x.shape
    plan = mask_tail_plan(bsz, h, w, clusters)
    out = x.new_zeros(bsz, h, w, k1.shape[-1])

    def input_row(img, z, c0):
        row = x.new_zeros(INPUT_PIXELS, cin)
        lo, hi = max(c0 - 2, 0), min(c0 + STRIP + 2, w)
        if 0 <= z < h and lo < hi:
            row[lo - (c0 - 2): hi - (c0 - 2)] = torch.relu(x[img, z, lo:hi])
        return row

    def window_product(rows, wts, width):
        acc = 0.0
        for dy in range(3):
            for dx in range(3):
                acc = acc + rows[dy][dx: dx + width].float() @ wts[dy, dx]
        return acc

    cols = torch.arange(H1_POSITIONS)
    for run in plan["runs"]:
        for sg in run["segments"]:
            img, y0, rows = sg["image"], sg["y0"], sg["rows"]
            c0 = sg["strip"] * STRIP
            inside = ((c0 - 1 + cols >= 0) & (c0 - 1 + cols < w))[:, None]
            ins = [input_row(img, y0 - 2 + k, c0) for k in range(2)]
            h1s = []
            for j in range(rows + 2):
                ins = ins[-2:] + [input_row(img, y0 + j, c0)]
                zr = y0 - 1 + j
                if 0 <= zr < h:
                    v = torch.relu(window_product(ins, w1f, H1_POSITIONS) + b1f)
                    h1s.append(torch.where(inside, v, 0.0).to(dt))
                else:
                    h1s.append(x.new_zeros(H1_POSITIONS, cin))
                if j < 2:
                    continue
                i = j - 2
                h2 = torch.relu(window_product(h1s[-3:], w0f, STRIP) + b0f).to(dt)
                o = (h2.float() @ k1f + bkf).to(dt)
                n = min(STRIP, w - c0)
                out[img, y0 + i, c0: c0 + n] = o[:n]
    return out, plan


def _conv3x3(x, w, b):
    """NHWC 3x3 'same' conv, fp32 accumulation of x's-dtype products, bias
    added in fp32: the fp32 accumulator before the rounding."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float().permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1) + b.float()


def mask_tail_plain(x, w1, b1, w0, b0, k1, bk):
    """Plain version of K10. x (B, H, W, C_in); w1 (3, 3, C_in, C_in), w0
    (3, 3, C_in, C_mid), k1 (C_mid, n_out); biases (C_in,), (C_mid,),
    (n_out,). The weights are cast to x's dtype first."""
    dt = x.dtype
    cast = lambda t: t.to(dt)
    w1, b1, w0, b0, k1, bk = map(cast, (w1, b1, w0, b0, k1, bk))
    h1 = torch.relu(_conv3x3(torch.relu(x), w1, b1)).to(dt)
    h2 = torch.relu(_conv3x3(h1, w0, b0)).to(dt)
    return (torch.matmul(h2.float(), k1.float()) + bk.float()).to(dt)


def mask_tail(x, w1, b1, w0, b0, k1, bk):
    """The fused tail. CPU tensors take the plain version. CUDA tensors
    launch the kernel or raise: bf16 x (B, H, W, C_in) with (C_in, C_mid)
    = `KERNEL_WIDTHS` and n_out <= 4."""
    if _build.via_ops():
        return torch.ops.s3od.mask_tail(x, w1, b1, w0, b0, k1, bk)
    return _mask_tail(x, w1, b1, w0, b0, k1, bk)


def _mask_tail(x, w1, b1, w0, b0, k1, bk):
    """`mask_tail`'s implementation, and its op's."""
    if x.device.type == "cpu":
        return mask_tail_plain(x, w1, b1, w0, b0, k1, bk)
    bsz, h, w, cin = x.shape
    cmid, nout = w0.shape[-1], k1.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError("mask_tail kernel: bf16 inputs only")
    if ((cin, cmid) != KERNEL_WIDTHS or not 1 <= nout <= MAX_OUT
            or tuple(w1.shape) != (3, 3, cin, cin)
            or tuple(w0.shape) != (3, 3, cin, cmid)
            or tuple(k1.shape) != (cmid, nout) or tuple(b1.shape) != (cin,)
            or tuple(b0.shape) != (cmid,) or tuple(bk.shape) != (nout,)
            or not x.numel()):
        raise ValueError(f"mask_tail kernel: unsupported x={tuple(x.shape)} "
                         f"w1={tuple(w1.shape)} w0={tuple(w0.shape)} "
                         f"k1={tuple(k1.shape)}")
    w1, b1, w0, b0, k1, bk = (_build.aligned16(t.to(x.dtype).contiguous())
                              for t in (w1, b1, w0, b0, k1, bk))
    with _build.launch(mask_tail):
        out = _empty_like_layout(x, nout)
        lib = _build.load_library()
        code = lib.s3od_mask_tail(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w0.data_ptr(),
            b0.data_ptr(), k1.data_ptr(), bk.data_ptr(), out.data_ptr(),
            bsz, h, w, cin, cmid, nout, *x.stride(), *out.stride(),
            _build.stream_ptr(x))
        _build.check(code, "mask_tail")
    return out


mask_tail.launches = 0


def _mask_tail_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w0: torch.Tensor, b0: torch.Tensor, k1: torch.Tensor,
                  bk: torch.Tensor) -> torch.Tensor:
    return _in_layout(_mask_tail(x, w1, b1, w0, b0, k1, bk), x)


def _mask_tail_fake(x, w1, b1, w0, b0, k1, bk):
    return _empty_like_layout(x, k1.shape[-1])


_build.register_op("mask_tail", _mask_tail_op, _mask_tail_fake)


@register_flop_formula(torch.ops.s3od.mask_tail)
def _mask_tail_flops(x_shape, w1_shape, b1_shape, w0_shape, b0_shape,
                     k1_shape, *args, out_shape=None, **kwargs):
    bsz, h, w, cin = x_shape
    cmid, nout = k1_shape
    return 2 * bsz * h * w * (9 * cin * cin + 9 * cin * cmid + cmid * nout)
