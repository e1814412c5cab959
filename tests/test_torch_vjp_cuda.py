"""On the card: the written-out backwards of K2, K4 and K5 (bf16 operands,
fp32 accumulation on the tensor cores, one Triton pass each) against the
fp32 vjp of their plain versions, at ViT-B 1024² b4 and at a ViT-L
teacher bucket (768 x 1344: 4037 tokens padded to 4096, b1), with a
planted 1% fault caught; each Triton pass against its plain version at
ragged sizes and at the training step's. The file imports no JAX: the
card's tests run without it.

    python3 chip_smoke.py -k vjp
"""

import pytest
import torch

from s3od_torch.models.dinov3 import _full_tables
from s3od_torch.ops import attn_epilogue as ae
from s3od_torch.ops import autograd as ops_autograd
from s3od_torch.ops import mlp_fused as mf
from s3od_torch.ops import qkv_project as qp
from s3od_torch.ops.autograd import plain_vjp
import _vjp_cases as vc  # tests/ is on sys.path under pytest
from _cuda import cuda  # noqa: F401

pytestmark = pytest.mark.cuda

# (batch, tokens, heads, head dim); F = 4C
SHAPES = {"vitb-1024-b4": (4, 4160, 12, 64),
          "vitl-768x1344-b1": (1, 4096, 16, 64)}
# ||pass - plain|| / ||plain|| of each bf16 output of a pass (dy, dxn, du,
# h): the two round the same fp32 values to bf16 and differ only where
# erf's, exp's or rsqrt's last fp32 bits do, so few elements move by one
# bf16 step, 2^-8 relative at most (4.7e-6 to 1.1e-5 in two runs at ViT-B
# 1024^2 b4 on an H100 80GB HBM3 at 700 W); the planted x 1.01 reads 1e-2.
# VJP_SUM_TOL: the fp32 column sums, which differ in summation order alone
# (1.5e-7 to 1.9e-7 there); a thousandth of the planted x 1.01.
VJP_NORM_TOL = 2.0**-8
VJP_SUM_TOL = 1e-5
# (batch, rows, C) of the passes: ragged rows at the tiny, ViT-B and ViT-L
# widths; ViT-B 1024^2 b4, the training step's
PASS_CASES = {"tiny": (3, 1000, 64), "vitb": (3, 1000, 768), "vitl": (3, 1000, 1024),
              "vitb-1024-b4": (4, 4160, 768)}
GRID = {4160: 64}  # the RoPE grid of a padded sequence length


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("op", vc.OPS)
def test_vjp_matches_fp32_plain_vjp_on_cuda(cuda, op, shape, monkeypatch):
    """The bf16 backward through the autograd wrapper (its Triton pass
    launched once, `plain_vjp` never called) against `plain_vjp` of the
    plain version in fp32 on the card; one gradient times 1.01 fails."""
    fn, plain, args, cots = vc.vjp_case(op, *SHAPES[shape], device=cuda,
                                        seed=11)

    def refuse(*a, **k):
        raise AssertionError("plain_vjp called")

    monkeypatch.setattr(ops_autograd, "plain_vjp", refuse)
    before = vc.PASSES[op].launches
    gots = vc.grads(fn, args, cots)
    torch.cuda.synchronize()
    assert vc.PASSES[op].launches == before + 1
    refs = plain_vjp(plain, [a.float() for a in args], [True] * len(args),
                     [c.float() for c in cots])
    vc.check_bf16(gots, refs, args)
    planted = list(gots)
    planted[1] = planted[1] * 1.01
    with pytest.raises(AssertionError):
        vc.check_bf16(planted, refs, args)


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_vjp_passes_match_plain_on_cuda(cuda, case):
    """Each Triton pass against its plain version on the same card inputs,
    at ragged row counts (the last tile part empty) and the tiny, ViT-B
    and ViT-L widths, and at the training step's ViT-B 1024^2 b4 shapes
    (RoPE at 4 x 12 heads of 4160 tokens): one launch a call, the bf16
    outputs within VJP_NORM_TOL, the fp32 column sums within VJP_SUM_TOL,
    a planted x 1.01 on each caught."""
    b, rows, c = PASS_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(12)
    bf = torch.bfloat16

    def r(*s, scale=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*s, generator=gen, device=cuda) * scale
                + mean).to(dtype)

    def close(got, ref, tol):
        for g, rr in zip(got, ref):
            assert g.dtype == rr.dtype and g.shape == rr.shape
            assert vc.rel_norm(g, rr) < tol, vc.rel_norm(g, rr)

    def held(kernel, plain, args, n_bf16):
        before = kernel.launches
        got = kernel(*args)
        assert kernel.launches == before + 1
        ref = plain(*args)
        assert all(t.dtype == bf for t in got[:n_bf16])
        close(got[:n_bf16], ref[:n_bf16], VJP_NORM_TOL)
        close(got[n_bf16:], ref[n_bf16:], VJP_SUM_TOL)
        for i, tol in ((0, VJP_NORM_TOL), (n_bf16, VJP_SUM_TOL)):
            with pytest.raises(AssertionError):
                close([got[i] * 1.01], [ref[i]], tol)

    f = 4 * c
    held(mf.gelu_bwd, mf.gelu_bwd_plain,
         (r(b * rows, f, scale=2, dtype=torch.float32),
          r(b * rows, f, dtype=torch.float32), r(f, scale=0.1)), 2)
    xn, lw = r(b, rows, c, scale=2, mean=0.5), r(c, scale=0.3, mean=1.0)
    held(ae.ln_bwd, ae.ln_bwd_plain, (xn, r(b, rows, c), r(b, rows, c), lw, 1e-6), 1)
    ropes = ((64, rows),) if rows in GRID else ((64, 192), (32, 100))
    for d, n in ropes:
        h = max(1, c // d)
        if n in GRID:
            cos, sin = _full_tables(GRID[n], GRID[n], d, 100.0, 5, n, cuda)
        else:
            theta = torch.rand(n, d // 2, generator=gen, device=cuda) * 3
            cos, sin = torch.cat([theta.cos()] * 2, 1), torch.cat([theta.sin()] * 2, 1)
        held(qp.rope_bwd, qp.rope_bwd_plain,
             (r(b, h, n, d), r(b, h, n, d), r(b, h, n, d), cos, sin, d**-0.5), 1)
    torch.cuda.synchronize()
