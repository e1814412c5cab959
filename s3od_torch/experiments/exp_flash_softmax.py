"""E1: flash forward-kernel softmax variants: the port of
`benchmarks/exp_flash_softmax.py`.

The TPU kernel (`make_kernel` -> `kernel`) is the online-softmax flash
forward on a (bh, nq, nk) grid: running m and l, an fp32 accumulator, a
zero key bias, no lse, no mask. Variants:

  base     : s = q k^T scale, p = exp(s - m)
  exp2     : s = q k^T (scale log2 e), p = exp2(s - m)
  exp2_bf16: p = exp2(bf16(s - m)), itself bf16, and l sums those values

Here every variant is one launch of the shared CUDA forward
(`flash_variants.py`), which streams 128-key tiles whatever the TPU's
blocks were; the plain version keeps the TPU kernel's key blocks.

    python -m s3od_torch.experiments.exp_flash_softmax [--bh 96] \
        [--n 4104] [--block-q 456] [--device cuda]

prints, per variant, the card's time (slope of in-order calls between
CUDA events), the max difference against `base`, max|kernel - plain| /
max|plain| and the plain version's time; `main` returns those numbers.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from s3od_torch import _build
from s3od_torch.experiments import flash_variants as fv
from s3od_torch.profiling import slope_time
from s3od_torch.utils import resolve_device

VARIANTS = ("base", "exp2", "exp2_bf16")


def softmax_for(variant: str, scale: float) -> fv.Softmax:
    if variant not in VARIANTS:
        raise ValueError(f"flash_softmax: unknown variant {variant!r}")
    if variant == "base":
        return fv.Softmax(online=True, mult=scale)
    return fv.Softmax(online=True, base2=True, bf16_arg=variant == "exp2_bf16",
                      mult=scale * fv.LOG2E)


def flash_softmax_plain(q, k, v, scale: float, variant: str, block_k: int = 0):
    """Plain version of E1: q, k, v (BH, N, D) -> o (BH, N, D), over key
    blocks of `block_k` (default N, the script's)."""
    n = k.shape[1]
    if block_k and n % block_k:
        raise ValueError(f"flash_softmax: N={n} is not a multiple of "
                         f"block_k={block_k}")
    return fv.attention_plain(q, k, v, None, softmax_for(variant, scale),
                              block_k)[0]


def flash_softmax(q, k, v, scale: float, variant: str):
    """E1 forward -> o. CPU tensors take the plain version (one key block);
    CUDA tensors launch the kernel (bf16 (BH, N, 64), any N) or raise."""
    if q.device.type == "cpu":
        return flash_softmax_plain(q, k, v, scale, variant)
    fv.check_inputs("flash_softmax", q, k, v)
    with _build.launch(flash_softmax):
        o, _ = fv.launch(q, k, v, None, softmax_for(variant, scale), want_lse=False)
    return o


flash_softmax.launches = 0


def inputs(bh: int, n: int, device, d: int = fv.HEAD_DIM):
    """The script's inputs from default_rng(0): q, k ~ 0.3 N(0, 1) and
    v ~ N(0, 1), in bf16."""
    rng = np.random.default_rng(0)
    return tuple(
        torch.from_numpy((rng.standard_normal((bh, n, d)) * s).astype(np.float32))
        .to(device=device, dtype=torch.bfloat16) for s in (0.3, 0.3, 1.0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bh", type=int, default=96)
    ap.add_argument("--n", type=int, default=4104)
    ap.add_argument("--block-q", type=int, default=456)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.n % args.block_q:
        raise ValueError(f"--n {args.n} must be a multiple of --block-q "
                         f"{args.block_q}, as on the TPU's grid")

    q, k, v = inputs(args.bh, args.n, dev)
    scale = 64 ** -0.5
    print(f"device: {dev}  shape {tuple(q.shape)}", file=sys.stderr)

    ref, res = None, {}
    rb = lambda o: float(o[:, ::64, :].float().sum())
    for variant in VARIANTS:
        fn = lambda _v=variant: flash_softmax(q, k, v, scale, _v)
        plain = lambda _v=variant: flash_softmax_plain(q, k, v, scale, _v)
        outf = fn().float()
        if ref is None:
            ref = outf
        md = float((outf - ref).abs().max())
        t = slope_time(fn, rb, device=dev)
        t_plain = slope_time(plain, rb, n_small=1, n_large=3, repeats=1, device=dev)
        res[variant] = {"ms": t * 1e3, "plain_ms": t_plain * 1e3,
                        "maxdiff_vs_base": md, **fv.errors(outf, plain())}
        print(f"{variant:10s}: {t*1e3:7.3f} ms   maxdiff vs base {md:.2e}   "
              f"vs plain {res[variant]['rel_vs_plain']:.2e}   "
              f"(plain {t_plain*1e3:.3f} ms)")
    return res


if __name__ == "__main__":
    main()
