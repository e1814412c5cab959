"""E4: single-K-block flash forward variants: the port of
`benchmarks/exp_flash_single.py`.

The TPU kernel (`make_run` -> `kernel`) computes, per block of query rows
against all keys, one softmax with lse. Its variants strip passes from the
softmax:

  base          : row max, scale applied on s in the kernel
  nomax_inscale : static bound, exp(min(s, 40) - 40), in-kernel scale
  nomax_clip2   : exp(clip(s, -20, 40) - 40), the production form
  min_eps       : the min form with l + 1e-30
  nomax         : the min form with q * scale (fp32 -> bf16) outside

lse = m + log l with m = 40 for the static variants. Here every variant is
one launch of the shared CUDA forward (`flash_variants.py`).

    python -m s3od_torch.experiments.exp_flash_single [--bh 96] [--n 4104] \
        [--block-q 456] [--device cuda]

prints, per variant, the card's time (slope of in-order calls between
CUDA events), the max difference against `base`, max|kernel - plain| /
max|plain| of o and max|kernel - plain| of lse, and the plain version's
time; `main` returns those numbers.
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

CLAMP = 40.0
VARIANTS = ("base", "nomax_inscale", "nomax_clip2", "min_eps", "nomax")


def softmax_for(variant: str, scale: float) -> fv.Softmax:
    if variant not in VARIANTS:
        raise ValueError(f"flash_single: unknown variant {variant!r}")
    if variant == "base":
        return fv.Softmax(online=True, mult=scale)
    mult = 1.0 if variant == "nomax" else scale
    lo = CLAMP - 60.0 if variant == "nomax_clip2" else -float("inf")
    eps = 1e-30 if variant == "min_eps" else 0.0
    return fv.Softmax(online=False, mult=mult, lo=lo, hi=CLAMP, l_eps=eps)


def _prepare(q, variant, scale):
    """`nomax` folds the scale into q outside the kernel, in fp32."""
    if variant == "nomax":
        return (q.float() * scale).to(q.dtype)
    return q


def flash_single_plain(q, k, v, bias, scale: float, variant: str):
    """Plain version of E4: q, k, v (BH, N, D), bias (N,) or (1, N) fp32 ->
    (o (BH, N, D), lse (BH, N) fp32)."""
    bias = bias.reshape(-1).float()
    return fv.attention_plain(_prepare(q, variant, scale), k, v, bias,
                              softmax_for(variant, scale))


def flash_single(q, k, v, bias, scale: float, variant: str):
    """E4 forward -> (o, lse). CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 (BH, N, 64), any N) or raise."""
    if q.device.type == "cpu":
        return flash_single_plain(q, k, v, bias, scale, variant)
    bias = bias.reshape(-1)
    fv.check_inputs("flash_single", q, k, v, bias)
    with _build.launch(flash_single):
        out = fv.launch(_prepare(q, variant, scale), k, v, bias,
                        softmax_for(variant, scale), want_lse=True)
    return out


flash_single.launches = 0


def inputs(bh: int, n: int, device, d: int = fv.HEAD_DIM):
    """The script's inputs: q, k, v ~ N(0, 1) in bf16 from
    default_rng(0), and a zero key bias with -1e30 on the last 3 keys."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, d)).astype(np.float32))
               .to(device=device, dtype=torch.bfloat16) for _ in range(3))
    bias = torch.zeros(n, dtype=torch.float32)
    bias[n - 3:] = -1e30
    return q, k, v, bias.to(device)


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

    bh, n, d = args.bh, args.n, fv.HEAD_DIM
    q, k, v, bias = inputs(bh, n, dev)
    scale = d ** -0.5
    print(f"device: {dev}  bh={bh} n={n}", file=sys.stderr)

    outs, res = {}, {}
    rb = lambda r: float(r[0][:1, :1, :].float().sum())
    for variant in VARIANTS:
        run = lambda _v=variant: flash_single(q, k, v, bias, scale, _v)
        plain = lambda _v=variant: flash_single_plain(q, k, v, bias, scale, _v)
        t = slope_time(run, rb, n_small=3, n_large=13, device=dev)
        t_plain = slope_time(plain, rb, n_small=1, n_large=3, repeats=1, device=dev)
        (o, lse), (o_ref, lse_ref) = run(), plain()
        outs[variant] = o.float()
        diff = float((outs[variant] - outs["base"]).abs().max())
        res[variant] = {"ms": t * 1e3, "plain_ms": t_plain * 1e3,
                        "maxdiff_vs_base": diff, **fv.errors(o, o_ref),
                        "lse_max_abs_err": fv.errors(lse, lse_ref)["max_abs_err"]}
        print(f"{variant:8s}: {t*1e3:.2f} ms   maxdiff vs base {diff:.2e}   "
              f"vs plain {res[variant]['rel_vs_plain']:.2e}, lse "
              f"{res[variant]['lse_max_abs_err']:.2e}   (plain {t_plain*1e3:.2f} ms)")
    return res


if __name__ == "__main__":
    main()
