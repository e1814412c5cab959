"""What a checkpointed encoder block keeps for its backward: the remat
policies of `s3od_tpu/models/dinov3.py:289-299`.

`torch.utils.checkpoint` (non-reentrant) runs a block's forward keeping
nothing and recomputes it in the backward, the JAX default policy
(`none`). The other two keep some forward results and reuse them in the
recompute:

- `flash` keeps K3's out and lse of each block (the JAX package names
  them `flash_out` / `flash_lse`, `ops/flash_attention.py:659-666`): the
  recompute re-runs K1, K2, K4 and K5 but not K3, and K8 reads the kept
  tensors. The attention autograd Function asks `kept_or_run` for its
  forward; the checkpoint's two contexts (`context_fn`) make that call
  keep the result in the forward and hand it back in the recompute.
- `dots_flash` keeps also what `jax.checkpoint_policies.dots_saveable`
  keeps. On the kernel route that is nothing more: K2, K4 and K5 are
  kernels, not dot products, and `print_saved_residuals` on the JAX
  block lists only flash_out and flash_lse. On the exact route it is the
  output of every matrix product of the block (the qkv, o_proj, up and
  down projections and both attention products), kept here by selective
  activation checkpointing of `aten.mm`, `aten.addmm`, `aten.bmm` and
  `aten.baddbmm`.

The recompute then produces the same values with the kept tensors in
place of their recomputation, so gradients do not depend on the policy.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

POLICIES = (None, "none", "flash", "dots_flash")

_active = threading.local()

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


class _Kept:
    """The tensors one checkpointed block keeps, in call order."""

    def __init__(self):
        self.tensors: List[Tuple[torch.Tensor, ...]] = []
        self.replay = False


class _Use:
    """Makes `kept` the active store (recording or replaying) while a
    block's forward or its recompute runs."""

    def __init__(self, kept: _Kept, replay: bool):
        self.kept, self.replay = kept, replay

    def __enter__(self):
        self.prev = getattr(_active, "kept", None)
        self.kept.replay = self.replay
        _active.kept = self.kept

    def __exit__(self, *exc):
        _active.kept = self.prev


class _Both:
    def __init__(self, *ctxs):
        self.ctxs = ctxs

    def __enter__(self):
        for c in self.ctxs:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctxs):
            c.__exit__(*exc)


def kept_or_run(fn: Callable[[], Tuple[torch.Tensor, ...]]):
    """fn(), or, inside the recompute of a block whose policy keeps it, the
    tensors its forward call returned (the forward call keeps them)."""
    kept: Optional[_Kept] = getattr(_active, "kept", None)
    if kept is None:
        return fn()
    if kept.replay:
        return kept.tensors.pop(0)
    out = fn()
    kept.tensors.append(tuple(t.detach() for t in out))
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def context_fn(policy: Optional[str], route: str) -> Optional[Callable]:
    """`torch.utils.checkpoint`'s `context_fn` for a block on `route`
    ("kernel" or "exact") under `policy`; None for the default (keep
    nothing). Unknown names raise `ValueError`, as in JAX."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    if policy in (None, "none"):
        return None

    def make():
        kept = _Kept()
        fwd, rec = [_Use(kept, False)], [_Use(kept, True)]
        if policy == "dots_flash" and route == "exact":
            a, b = create_selective_checkpoint_contexts(_dots_policy)
            fwd.append(a)
            rec.append(b)
        return _Both(*fwd), _Both(*rec)

    return make
