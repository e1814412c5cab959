"""Gradients of the forward kernels that have no backward kernel.

The JAX package differentiates K1, K2, K4 and K5 through `custom_vjp`
rules written in plain XLA (`layernorm.py:111`, `qkv_project.py:163`,
`attn_epilogue.py:116`, `mlp_fused.py:162`): the forward runs the Pallas
kernel, the backward recomputes a plain reference and takes its vjp. The
port's `torch.autograd.Function`s call the kernel wrapper in the forward.
Their backwards come in two kinds:

- K2, K4 and K5 (`qkv_project.py`, `attn_epilogue.py`, `mlp_fused.py`)
  write their vjp out: only the products the gradients need, each with
  operands in the input dtype and fp32 accumulation (`mm_f32`; bf16 on
  the card runs on the tensor cores), around one fused elementwise pass
  each (a Triton kernel on the card, its plain version on the CPU).
- K1 (`layernorm.py`, no product) and the Winograd convolutions
  (`experimental/winograd.py`) take `plain_vjp` of the kernel's plain
  version: plain PyTorch, not kernels.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def plain_vjp(fn: Callable, inputs: Sequence, needs: Sequence[bool], grads):
    """Vector-Jacobian product of `fn` at `inputs` against `grads` (one
    per output of `fn`, None for an output without cotangent), by torch
    autograd on a recompute. Returns one gradient per input, None where
    `needs` is False."""
    with torch.enable_grad():
        args = [x.detach().requires_grad_(need) if torch.is_tensor(x) else x
                for x, need in zip(inputs, needs)]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [a for a, need in zip(args, needs) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if need else None for need in needs)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D) with fp32 accumulation, returned in fp32 for the
    caller's one rounding. On CUDA, bf16 operands go to the tensor cores
    with an fp32 output (`aten::mm.dtype`), so no split-K partial is
    rounded to bf16. Elsewhere, and for fp32 operands, both are widened
    first: a product of two bf16 values is exact in fp32, so the sums are
    the same (`aten::mm.dtype` has no CPU kernel)."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def scale_rows(ls: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ls ⊙ W: W's rows (output channels) scaled by the layerscale in
    fp32, rounded once to W's dtype — the operand of a product that
    carries the layerscale into it."""
    return (w * ls.float()[:, None]).to(w.dtype)
