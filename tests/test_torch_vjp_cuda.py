"""On the card: the written-out backwards of K2, K4 and K5 (bf16 operands,
fp32 accumulation on the tensor cores, one Triton pass each) against the
fp32 vjp of their plain versions, at ViT-B 1024² b4 and at a ViT-L
teacher bucket (768 x 1344: 4037 tokens padded to 4096, b1), with a
planted 1% fault caught; each Triton pass against its plain version at
ragged sizes. The file imports no JAX: the card's tests run without it.

    python -m pytest tests/test_torch_vjp_cuda.py -m cuda
"""

import pytest
import torch

from s3od_torch.ops import attn_epilogue as ae
from s3od_torch.ops import autograd as ops_autograd
from s3od_torch.ops import mlp_fused as mf
from s3od_torch.ops import qkv_project as qp
from s3od_torch.ops.autograd import plain_vjp
import _vjp_cases as vc  # tests/ is on sys.path under pytest

# (batch, tokens, heads, head dim); F = 4C
SHAPES = {"vitb-1024-b4": (4, 4160, 12, 64),
          "vitl-768x1344-b1": (1, 4096, 16, 64)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton passes run on the card only)")
    return torch.device("cuda")


@pytest.mark.cuda
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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 768, 1024])
def test_vjp_passes_match_plain_on_cuda(cuda, c):
    """Each Triton pass against its plain version on the same card inputs,
    at ragged row counts (the last tile part empty) and the tiny, ViT-B
    and ViT-L widths: the bf16 outputs within one bf16 rounding at most
    (the passes differ only in erf's and rsqrt's last fp32 bits), the
    fp32 column sums by summation order."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    bf = torch.bfloat16

    def r(*s, scale=1.0, mean=0.0, dtype=bf):
        return (torch.randn(*s, generator=gen, device=cuda) * scale
                + mean).to(dtype)

    def close(got, ref, tol):
        for g, rr in zip(got, ref):
            assert g.dtype == rr.dtype and g.shape == rr.shape
            assert vc.rel_norm(g, rr) < tol, vc.rel_norm(g, rr)

    rows, f = 1000, 4 * c
    gelu_in = (r(rows, f, scale=2, dtype=torch.float32),
               r(rows, f, dtype=torch.float32), r(f, scale=0.1))
    got = mf.gelu_bwd(*gelu_in)
    ref = mf.gelu_bwd_plain(*gelu_in)
    close(got[:2], ref[:2], 2.0**-8)
    close(got[2:], ref[2:], 1e-5)
    xn, lw = r(3, rows, c, scale=2, mean=0.5), r(c, scale=0.3, mean=1.0)
    ln_in = (xn, r(3, rows, c), r(3, rows, c), lw, 1e-6)
    got = ae.ln_bwd(*ln_in)
    ref = ae.ln_bwd_plain(*ln_in)
    close(got[:1], ref[:1], 2.0**-8)
    close(got[1:], ref[1:], 1e-5)
    for d, n in ((64, 192), (32, 100)):
        h = max(1, c // d)
        theta = torch.rand(n, d // 2, generator=gen, device=cuda) * 3
        cos, sin = torch.cat([theta.cos()] * 2, 1), torch.cat([theta.sin()] * 2, 1)
        rope_in = (r(2, h, n, d), r(2, h, n, d), r(2, h, n, d), cos, sin, d**-0.5)
        got = qp.rope_bwd(*rope_in)
        ref = qp.rope_bwd_plain(*rope_in)
        close(got[:1], ref[:1], 2.0**-8)
        close(got[1:], ref[1:], 1e-5)
    torch.cuda.synchronize()
