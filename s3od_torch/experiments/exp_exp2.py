"""E3: exp against exp2 on the card: the port of `benchmarks/exp_exp2.py`.

  A. throughput (E3b, `csrc/exp_loop.cu`): a grid of programs each
     applying exp, exp2 or a static-softmax tail 16 times to a resident
     fp32 block (the kernel's note says why it is CUDA);
  B/C. the static-bound forward in base 2 (E3a, `_exp2_flash`: one launch
     of the shared CUDA forward, `flash_variants.py`) against the port's
     K3/K6 (`s3od_torch.ops.flash_attention.flash_attention`, base e) at
     the DIS shape (12, 16389, 64) and the 1024^2 ViT shape (96, 4101, 64),
     the scale folded into q in bf16 and K3/K6 padding to 64 as they do.

E3a's function includes the TPU's padding: q is scaled in bf16, the
sequence is padded to n_pad (the larger of `_pick_blocks`' two blocks, a
copy of `s3od_tpu/ops/flash_attention.py:_pick_blocks`), keys at or past
n_valid get the bias -1e30 and so weigh exp2(lo2 - hi2) = e^-80 after the
clip, s2 = s log2 e + bias, p = exp2(clip(s2, lo2, hi2) - hi2) with the
+-40 bound times log2 e, and lse = hi2 ln 2 + ln l.

    python -m s3od_torch.experiments.exp_exp2 [--device cuda]

prints what the script prints, each time taken between CUDA events on the
card, beside each kernel's agreement with its plain version (E3b:
bit-equal, inf positions equal; E3a: max|kernel - plain| / max|plain|);
`main` returns those numbers and the plain versions' times.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from s3od_torch import _build
from s3od_torch.experiments import flash_variants as fv
from s3od_torch.ops import flash_attention as fa
from s3od_torch.profiling import slope_time
from s3od_torch.utils import resolve_device

LOG2E = fv.LOG2E
HI2 = fa.SOFTMAX_BOUND_HI * LOG2E
LO2 = fa.SOFTMAX_BOUND_LO * LOG2E
REPS = 16
OUT_BLOCKS = 8  # program i writes output block i mod 8
LOOP_VARIANTS = ("mul (baseline)", "exp", "exp2", "clip+sub+exp (kernel tail)",
                 "fma+clip+sub+exp2")
SHAPES = (("DIS-2048", 16389, 12), ("ViT-1024", 4101, 96))  # (tag, N, BH)
LOOP_BLOCK, LOOP_PROGRAMS = 512, 256


def pick_blocks(n: int, d: int):
    """Copy of `s3od_tpu/ops/flash_attention.py:_pick_blocks` (the TPU's
    VMEM rule), which fixes E3a's padded length."""
    nq = -(-n // 512)
    block_q = -(-(-(-n // nq)) // 8) * 8
    n_pad = nq * block_q
    if block_q * n_pad * 4 <= 8 * 1024 * 1024:
        return block_q, n_pad
    n_pad512 = -(-n // 512) * 512
    return 512, 2048 if n_pad512 % 2048 == 0 else 512


# ---------------------------------------------------------------------------
# E3a: the static-bound forward in base 2
# ---------------------------------------------------------------------------

SOFTMAX = fv.Softmax(online=False, base2=True, mult=LOG2E, lo=LO2, hi=HI2)


def _scaled(q, scale):
    """q * scale in q's dtype, the scale rounded to it first (JAX's
    `q * jnp.asarray(scale, q.dtype)`)."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


def padded_len(n: int, block_q: int, block_k: int) -> int:
    blk = max(block_q, block_k)
    return -(-n // blk) * blk


def key_bias(n: int, n_valid: int, device):
    bias = torch.zeros(n, dtype=torch.float32, device=device)
    bias[n_valid:] = fa.NEG_INF
    return bias


def exp2_flash_plain(q, k, v, scale: float, block_q: int, block_k: int,
                     n_valid: int):
    """Plain version of E3a: pads q, k, v with zeros to n_pad as the TPU
    launch does, masks keys at or past n_valid with -1e30, runs the static
    base-2 softmax over key blocks of `block_k` and slices back to n ->
    (o (BH, n, D), lse (BH, n) fp32)."""
    n = q.shape[1]
    n_pad = padded_len(n, block_q, block_k)
    q = _scaled(q, scale)
    if n_pad != n:
        q, k, v = (F.pad(t, (0, 0, 0, n_pad - n)) for t in (q, k, v))
    o, lse = fv.attention_plain(q, k, v, key_bias(n_pad, n_valid, q.device),
                                SOFTMAX, block_k)
    return o[:, :n], lse[:, :n]


def exp2_flash(q, k, v, scale: float, block_q: int, block_k: int,
               n_valid: int):
    """E3a forward -> (o, lse). CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 (BH, N, 64)) or raise. The kernel
    reads the n real keys only: the n_pad - n padded keys are zero keys
    under the -1e30 bias, whose weight it adds to l per row."""
    if q.device.type == "cpu":
        return exp2_flash_plain(q, k, v, scale, block_q, block_k, n_valid)
    n = q.shape[1]
    if not 0 < n_valid <= n:
        raise ValueError(f"exp2_flash: n_valid {n_valid} outside (0, {n}]")
    fv.check_inputs("exp2_flash", q, k, v)
    n_pad = padded_len(n, block_q, block_k)
    with _build.launch(exp2_flash):
        out = fv.launch(_scaled(q, scale), k, v, key_bias(n, n_valid, q.device),
                        SOFTMAX, want_lse=True, extra_keys=n_pad - n)
    return out


exp2_flash.launches = 0


# ---------------------------------------------------------------------------
# E3b: the throughput loop
# ---------------------------------------------------------------------------


def _loop_step(variant: str):
    return {
        "mul (baseline)": lambda a: a * 1.0000001,
        "exp": torch.exp,
        "exp2": torch.exp2,
        "clip+sub+exp (kernel tail)": lambda a: torch.exp(
            a.clamp(-40.0, 40.0) - 40.0),
        "fma+clip+sub+exp2": lambda a: torch.exp2(
            (a * LOG2E + 0.0).clamp(-57.7, 57.7) - 57.7),
    }[variant]


def exp_loop_plain(x, variant: str, reps: int = REPS):
    """Plain version of E3b: x (B, B) fp32 -> (8B, B), f^reps(x) in each of
    the 8 output blocks."""
    f = _loop_step(variant)
    a = x.float()
    for _ in range(reps):
        a = f(a)
    return a.repeat(OUT_BLOCKS, 1)


def exp_loop(x, variant: str, programs: int = LOOP_PROGRAMS, reps: int = REPS):
    """E3b -> (8B, B). CPU tensors take the plain version; CUDA tensors
    launch the kernel (fp32 (B, B), programs >= 8: every program does its
    block's full work) or raise."""
    if x.device.type == "cpu":
        return exp_loop_plain(x, variant, reps)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != x.shape[1]:
        raise ValueError("exp_loop kernel: fp32 (B, B) x only")
    if variant not in LOOP_VARIANTS or programs < OUT_BLOCKS:
        raise ValueError(f"exp_loop kernel: variant {variant!r}, "
                         f"programs {programs} (>= {OUT_BLOCKS})")
    x = x.contiguous()
    b = x.shape[0]
    with _build.launch(exp_loop):
        out = torch.empty((OUT_BLOCKS * b, b), device=x.device, dtype=torch.float32)
        lib = _build.load_library()
        code = lib.s3od_exp_loop(x.data_ptr(), out.data_ptr(), b * b, programs,
                                 reps, LOOP_VARIANTS.index(variant),
                                 _build.stream_ptr(x))
        _build.check(code, "exp_loop")
    return out


exp_loop.launches = 0


def loop_errors(got, ref):
    """(inf positions equal, `fv.errors` over the finite outputs; zeros
    where none is finite)."""
    got, ref = got.float(), ref.float()
    same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(ref)))
    fin = torch.isfinite(ref)
    if not bool(fin.any()):
        return same_inf, {"max_abs_err": 0.0, "rel_vs_plain": 0.0}
    return same_inf, fv.errors(got[fin], ref[fin])


# ---------------------------------------------------------------------------
# The script
# ---------------------------------------------------------------------------


def static_flash(q, k, v, scale: float):
    """The port's K3/K6 on (BH, n, D), the scale folded into q in bf16,
    padded to its multiple of 64 with n_valid = n -> o (BH, n, D)."""
    n = q.shape[1]
    n_pad = fa.flash_seq_len(n)
    q = _scaled(q, scale)
    if n_pad != n:
        q, k, v = (F.pad(t, (0, 0, 0, n_pad - n)) for t in (q, k, v))
    return fa.flash_attention(q, k, v, n)[0][:, :n]


def inputs(device):
    """The script's inputs from default_rng(0), in its order: x (B, B) fp32
    uniform in [-40, 0] for section A, then per shape of sections B/C q, k,
    v ~ (0.5, 0.5, 1) N(0, 1) in bf16 -> (x, {tag: (q, k, v)})."""
    rng = np.random.default_rng(0)
    b = LOOP_BLOCK
    x = torch.from_numpy(rng.uniform(-40, 0, (b, b)).astype(np.float32)).to(device)
    flash = {}
    for tag, n, bh in SHAPES:
        flash[tag] = tuple(
            torch.from_numpy((rng.standard_normal((bh, n, fv.HEAD_DIM)) * s)
                             .astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for s in (0.5, 0.5, 1.0))
    return x, flash


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x, flash = inputs(dev)
    res = {"loop": {}, "flash": {}}

    # ---- A. raw exponential throughput --------------------------------
    n_elem = LOOP_PROGRAMS * REPS * x.numel()
    rb = lambda o: float(o[::64, ::64].sum())
    for name in LOOP_VARIANTS:
        run = lambda _n=name: exp_loop(x, _n, LOOP_PROGRAMS)
        plain = lambda _n=name: exp_loop_plain(x, _n)
        t = slope_time(run, rb, n_small=2, n_large=10, device=dev)
        t_plain = slope_time(plain, rb, n_small=1, n_large=3, repeats=1, device=dev)
        got, ref = run(), plain()
        same_inf, err = loop_errors(got, ref)
        res["loop"][name] = {"ms": t * 1e3, "plain_ms": t_plain * 1e3,
                             "gelem_s": n_elem / t / 1e9,
                             "bit_equal": bool(torch.equal(got, ref)),
                             "inf_positions_equal": same_inf,
                             "inf_share": float(torch.isinf(ref).float().mean()),
                             **err}
        print(f"[loop {name:28s}] {t*1e3:7.3f} ms  "
              f"({n_elem/t/1e9:7.1f} Gelem/s)  vs plain {err['rel_vs_plain']:.2e}, bit-equal: "
              f"{res['loop'][name]['bit_equal']}, inf positions equal: {same_inf}")

    # ---- B/C. the base-2 forward against K3/K6 -------------------------
    for tag, (q, k, v) in flash.items():
        bh, n, d = q.shape
        block_q, block_k = pick_blocks(n, d)
        base = lambda: static_flash(q, k, v, d ** -0.5)
        exp2 = lambda: exp2_flash(q, k, v, d ** -0.5, block_q, block_k, n)
        plain = lambda: exp2_flash_plain(q, k, v, d ** -0.5, block_q, block_k, n)
        (o_exp2, lse), (o_ref, lse_ref) = exp2(), plain()
        md = float((base().float() - o_exp2.float()).abs().max())
        err = fv.errors(o_exp2, o_ref)
        print(f"[{tag}] numerics maxdiff exp2-vs-static: {md:.5f}   "
              f"exp2 vs plain {err['rel_vs_plain']:.2e}")
        rb = lambda o: float(o[:, ::512, ::16].float().sum())
        rb2 = lambda r: rb(r[0])
        t_base = slope_time(base, rb, n_small=2, n_large=8, device=dev)
        t_exp2 = slope_time(exp2, rb2, n_small=2, n_large=8, device=dev)
        t_plain = slope_time(plain, rb2, n_small=1, n_large=3, repeats=1, device=dev)
        res["flash"][tag] = {"static_ms": t_base * 1e3, "ms": t_exp2 * 1e3,
                             "plain_ms": t_plain * 1e3, "maxdiff": md, **err,
                             "lse_max_abs_err": fv.errors(lse, lse_ref)["max_abs_err"],
                             "blocks": [block_q, block_k]}
        print(f"[{tag}] static(exp) {t_base*1e3:7.3f} ms   "
              f"exp2 {t_exp2*1e3:7.3f} ms   "
              f"({t_base/t_exp2:.2f}x, blocks {block_q}/{block_k}; plain "
              f"{t_plain*1e3:.3f} ms)")
    return res


if __name__ == "__main__":
    main()
