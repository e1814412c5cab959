"""E2: LayerNorm statistics variants: the port of
`benchmarks/exp_layernorm.py`.

  base    : fp32 mean, then the mean of squared deviations (two passes;
            plain PyTorch, the script's XLA variant)
  mxu     : mean and mean of squares as products with a (C, 128) matrix
            whose first column is 1/C (plain PyTorch, the script's XLA
            variant; here the product goes to cuBLAS)
  kernel  : the single-pass kernel (CUDA, `s3od_torch/csrc/exp_layernorm.cu`),
            the port of the script's Pallas `_ln_kernel`: per row, fp32
            mean and mean of squares, var = E[x^2] - E[x]^2 with NO clamp
            at 0 (unlike K1, `s3od_torch/ops/layernorm.py`), rsqrt(var +
            eps), fp32 affine, out in x's dtype; no mean or rstd outputs.

Bound on the H100: no products; each row is read once and written once,
2 * 2 * C bytes (8 x 4104 x 768 at the default: 101 MB, 0.030 ms at 3.35
TB/s), so it is memory-bound: the kernel's design note says how it keeps
bytes in flight.

    python -m s3od_torch.experiments.exp_layernorm [--batch 8] [--n 4104] \
        [--c 768] [--device cuda]

prints the max differences of mxu and the kernel against base, the
kernel's max|kernel - plain| / max|plain| and ||kernel - plain|| /
||plain||, and the time of each variant
and of the kernel's plain version (between CUDA events on the card);
`main` returns those numbers.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from s3od_torch import _build
from s3od_torch.experiments.flash_variants import errors
from s3od_torch.profiling import slope_time
from s3od_torch.utils import resolve_device

EPS = 1e-5


def layer_norm_base_plain(x, w, b, eps: float = EPS):
    """The script's `base`: two-pass fp32 statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def layer_norm_mxu_plain(x, w, b, eps: float = EPS):
    """The script's `mxu`: E[x] and E[x^2] as fp32 products with `ones2`."""
    c = x.shape[-1]
    ones2 = torch.zeros((c, 128), dtype=torch.float32, device=x.device)
    ones2[:, 0] = 1.0 / c
    xf = x.float()
    m1 = torch.matmul(xf, ones2)[..., :1]
    m2 = torch.matmul(xf * xf, ones2)[..., :1]
    y = (xf - m1) * torch.rsqrt(m2 - m1 * m1 + eps)
    return (y * w + b).to(x.dtype)


def layer_norm_single_pass_plain(x, w, b, eps: float = EPS):
    """Plain version of E2: single-pass statistics, var unclamped."""
    xf = x.float()
    m1 = xf.mean(-1, keepdim=True)
    m2 = (xf * xf).mean(-1, keepdim=True)
    y = (xf - m1) * torch.rsqrt(m2 - m1 * m1 + eps)
    return (y * w.float() + b.float()).to(x.dtype)


# The kernel's launch (`csrc/exp_layernorm.cu`), mirrored so that the CPU
# tests can check it.
BULK_WARPS = 8               # consumer warps a block: rows a stage
BULK_RING_BYTES = 98304      # the ring's target size
MAX_SMEM = 232448            # bytes of shared memory one H100 block may use


def plan(rows: int, c: int) -> dict:
    """The launch at x (rows, c): a lane's 16-byte vectors of a row
    (`vectors`, the template instance) and the lanes left idle, whether w
    and b stay in registers, the ring's stages and shared memory, and
    `blocks` before the persistent grid's cap at what the card holds."""
    vectors = -(-c // 256)
    stage = BULK_WARPS * 2 * c
    stages = min(4, max(2, BULK_RING_BYTES // stage))
    return {"vectors": vectors, "idle_lanes": 32 * vectors - c // 8,
            "weights_held": vectors <= 4, "stages": stages,
            "smem": stages * stage + 2 * stages * 8,
            "blocks": -(-rows // BULK_WARPS)}


def layer_norm_single_pass(x, w, b, eps: float = EPS):
    """E2 -> y. CPU tensors take the plain version; CUDA tensors launch the
    CUDA kernel (bf16 x, fp32 (C,) w and b, C a multiple of 8 up to 4096)
    or raise."""
    if x.device.type == "cpu":
        return layer_norm_single_pass_plain(x, w, b, eps)
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or c % 8 or not 0 < c <= 4096 or x.numel() == 0:
        raise ValueError(f"layer_norm_single_pass kernel: unsupported {x.dtype} C={c}")
    if (w.shape != (c,) or b.shape != (c,) or w.dtype != torch.float32
            or b.dtype != torch.float32):
        raise ValueError("layer_norm_single_pass kernel: w, b must be fp32 (C,)")
    x2, w, b = (_build.aligned16(t) for t in (x.reshape(-1, c), w, b))
    with _build.launch(layer_norm_single_pass):
        y = torch.empty_like(x2)
        lib = _build.load_library()
        code = lib.s3od_ln_single_pass(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), x2.shape[0], c,
            float(eps), _build.stream_ptr(x2))
        _build.check(code, "layer_norm_single_pass")
    return y.view(x.shape)


layer_norm_single_pass.launches = 0


def inputs(batch: int, n: int, c: int, device):
    """The script's inputs from default_rng(0): x = 2 N(0, 1) + 0.5 in
    bf16, w and b ~ N(0, 1) in fp32."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((batch, n, c)) * 2 + 0.5)
                         .astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((c,)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((c,)).astype(np.float32)).to(device)
    return x, w, b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=4104)
    ap.add_argument("--c", type=int, default=768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, w, b = inputs(args.batch, args.n, args.c, dev)
    print(f"device: {dev}  {args.batch}x{args.n}x{args.c}", file=sys.stderr)

    variants = {
        "base": lambda: layer_norm_base_plain(x, w, b),
        "mxu": lambda: layer_norm_mxu_plain(x, w, b),
        "kernel": lambda: layer_norm_single_pass(x, w, b),
        "plain": lambda: layer_norm_single_pass_plain(x, w, b),
    }
    a, m, k, p = (variants[v]().float() for v in variants)
    res = {"maxdiff_mxu": float((a - m).abs().max()),
           "maxdiff_kernel": float((a - k).abs().max()), **errors(k, p),
           "rel_norm_vs_plain": float((k - p).norm() / p.norm().clamp_min(1e-30))}
    print(f"maxdiff mxu {res['maxdiff_mxu']:.2e}  kernel "
          f"{res['maxdiff_kernel']:.2e}  kernel vs plain {res['rel_vs_plain']:.2e} "
          f"(relative norm {res['rel_norm_vs_plain']:.2e})")

    rb = lambda o: float(o[:, ::64, ::128].float().sum())
    for name, fn in variants.items():
        t = slope_time(fn, rb, device=dev)
        res[f"{name}_ms"] = t * 1e3
        print(f"{name:6s}: {t*1e3:7.3f} ms")
    return res


if __name__ == "__main__":
    main()
