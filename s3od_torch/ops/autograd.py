"""Gradients of the forward kernels that have no backward kernel.

The JAX package differentiates K1, K2, K4 and K5 through `custom_vjp`
rules written in plain XLA (`layernorm.py:111`, `qkv_project.py:163`,
`attn_epilogue.py:116`, `mlp_fused.py:162`): the forward runs the Pallas
kernel, the backward recomputes a plain reference and takes its vjp. The
port does the same with `torch.autograd.Function`s whose forward calls the
kernel wrapper and whose backward is `plain_vjp` of the kernel's plain
version. These backwards are plain PyTorch, not kernels.
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
