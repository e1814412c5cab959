"""The inputs that K2's, K4's and K5's written-out backwards are held to,
shared by the CPU tests (`test_torch_training.py`) and the card's
(`test_torch_vjp_cuda.py`, which imports no JAX). Imported by its bare
name: pytest puts `tests/` on sys.path, and a package named `tests`
elsewhere on the path would shadow this directory."""

from __future__ import annotations

import torch

from s3od_torch.ops import attn_epilogue as ae
from s3od_torch.ops import mlp_fused as mf
from s3od_torch.ops import qkv_project as qp

# Each bf16 gradient against the fp32 vjp of the plain version at the same
# bf16 inputs, by relative norm: the gradient's own rounding and the
# roundings of the products' bf16 operands (du and h, dy, dxn, ls ⊙ W) are
# each at most 2^-8 relative (bf16's unit roundoff), independent, and so
# add to well under two of them; 2^-7 still fails a gradient off by 1%.
BF16_VJP_TOL = 2.0**-7
OPS = ("qkv_project_rope", "attn_epilogue", "mlp_fused")
# each op's Triton pass, launched once a backward on the card
PASSES = {"qkv_project_rope": qp.rope_bwd, "attn_epilogue": ae.ln_bwd,
          "mlp_fused": mf.gelu_bwd}


def rel_norm(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / (ref.norm() + 1e-30))


def vjp_case(op, b, n, h, d, dtype=torch.bfloat16, device="cpu", seed=47):
    """(the autograd wrapper, its plain version, the differentiable
    inputs, the cotangents) of one op at batch b, n tokens, h heads of
    dim d (F = 4C): weights at 1/sqrt(fan-in), layerscales and LayerNorm
    weights around 1, RoPE angles in [0, 3)."""
    c = h * d
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                + mean).to(dtype)

    if op == "qkv_project_rope":
        theta = torch.rand(n, d // 2, generator=gen, device=device) * 3
        cos = torch.cat([theta.cos()] * 2, 1)
        sin = torch.cat([theta.sin()] * 2, 1)
        return (lambda *a: qp.qkv_project_rope_autograd(*a, cos, sin, h, d**-0.5),
                lambda *a: qp.qkv_project_rope_plain(*a, cos, sin, h, d**-0.5),
                (r(b, n, c), r(3 * c, c, scale=c**-0.5), r(3 * c, scale=0.1)),
                tuple(r(b, h, n, d) for _ in range(3)))
    if op == "attn_epilogue":
        return (lambda *a: ae.attn_epilogue_autograd(*a, 1e-6),
                lambda *a: ae.attn_epilogue_plain(*a, 1e-6),
                (r(b * h, n, d), r(c, c, scale=c**-0.5), r(c, scale=0.1),
                 r(b, n, c), r(c, scale=0.3, mean=1.0),
                 r(c, scale=0.3, mean=1.0), r(c, scale=0.1)),
                (r(b, n, c), r(b, n, c)))
    f = 4 * c
    return (mf.mlp_fused_autograd, mf.mlp_fused_plain,
            (r(b, n, c), r(f, c, scale=c**-0.5), r(f, scale=0.1),
             r(c, f, scale=f**-0.5), r(c, scale=0.1), r(b, n, c),
             r(c, scale=0.3, mean=1.0)),
            (r(b, n, c),))


def grads(fn, args, cots, needs=None):
    """The autograd wrapper's gradients of `args` (those `needs` marks,
    all by default) against `cots`."""
    needs = needs or [True] * len(args)
    leaves = [a.clone().requires_grad_(need) for a, need in zip(args, needs)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, [l for l in leaves if l.requires_grad], cots)


def check_bf16(gots, refs, args):
    """Each gradient in bf16, its input's shape, finite, and within
    `BF16_VJP_TOL` of the fp32 reference."""
    for i, (got, ref) in enumerate(zip(gots, refs)):
        assert got.dtype == torch.bfloat16 and got.shape == args[i].shape, i
        assert torch.isfinite(got).all(), i
        assert rel_norm(got, ref) < BF16_VJP_TOL, (i, rel_norm(got, ref))
