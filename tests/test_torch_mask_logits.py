"""The DPT mask heads' logits tail (`s3od_torch/ops/mask_logits.py`) on the
CPU: its plain version against the chain it was moved from, written out
here (`_old_tail`: the fused 3x3 with its bias, the ReLU, the grouped 1x1
conv), in fp32 and bf16; its written-out backward against autograd
through the plain version in fp32; `MaskHead` against the head as it ran
the chain before (`_old_mask_head`), in values and parameter gradients;
and that the CPU and float32 routes launch no kernel. The Triton passes
themselves are held on the card by `tests/test_torch_mask_logits_cuda.py`."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from s3od_torch.models.dpt import MaskHead
from s3od_torch.ops import mask_logits as ml
from s3od_torch.ops.resize import resize_bilinear

HEADS, C_IN, BATCH = 3, 16, 2
# (height, width): a square map, and a ragged one (91 pixels)
SIZES = {"square": (16, 16), "ragged": (7, 13)}


def _case(inter, hw, dtype=torch.float32, seed=5):
    """(feat, k_fused, b_fused, w1, b1) at the scale of the model's head:
    the 3x3's output near zero, so the ReLU cuts about half of it."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dtype)
    c = HEADS * inter
    return (r(BATCH, C_IN, *hw), r(c, C_IN, 3, 3, scale=0.1), r(c, scale=0.1),
            r(HEADS, inter, scale=0.3), r(HEADS, scale=0.3))


def _old_tail(feat, k_fused, b_fused, w1, b1):
    """The chain as `MaskHead` ran it: the fused 3x3 with its bias, the
    ReLU, and the 1x1 convs as one grouped conv, in the input's dtype."""
    n, inter = w1.shape
    hidden = F.relu(F.conv2d(feat, k_fused, b_fused, padding=1))
    return F.conv2d(hidden, w1.reshape(n, inter, 1, 1), b1, groups=n)


def _ulp(t) -> float:
    """One bf16 ulp at the largest magnitude of `t`."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("inter", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_forward_matches_old_chain(dtype, inter, size):
    """The fused 3x3 without its bias, then `mask_logits_plain`, against
    the old chain: within 1e-6 of max|old| in fp32; within one bf16 ulp
    of its scale in bf16 (the bias now meets the bf16 3x3 output in fp32,
    and the 1x1 reads the ReLU in fp32 before the one rounding)."""
    feat, k, b, w1, b1 = _case(inter, SIZES[size], dtype)
    old = _old_tail(feat, k, b, w1, b1)
    new = ml.mask_logits_plain(F.conv2d(feat, k, padding=1), b, w1, b1)
    assert new.dtype == dtype and new.shape == old.shape == (
        BATCH, HEADS, *SIZES[size])
    err = float((new.float() - old.float()).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-6 * float(old.abs().max()), err
    else:
        assert err <= _ulp(old), (err, _ulp(old))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("inter", [8, 32])
def test_plain_backward_matches_autograd(inter, size):
    """`mask_logits_bwd_plain` against fp32 autograd through
    `mask_logits_plain`: dpre, db_fused, dw1 and db1 within 1e-5 of each
    gradient's scale."""
    feat, k, b, w1, b1 = _case(inter, SIZES[size])
    pre = F.conv2d(feat, k, padding=1)
    dm = torch.randn(BATCH, HEADS, *SIZES[size],
                     generator=torch.Generator().manual_seed(9))
    leaves = [t.clone().requires_grad_() for t in (pre, b, w1, b1)]
    ml.mask_logits_plain(*leaves).backward(dm)
    got = ml.mask_logits_bwd_plain(dm, pre, b, w1)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        ref = leaf.grad
        assert float((g - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    # the ReLU cut part of the map: dpre is zero there, and only there
    s = pre + b[:, None, None]
    assert 0.2 < float((s > 0).float().mean()) < 0.8
    assert torch.equal(got[0] == 0, (s <= 0) | (dm.repeat_interleave(inter, 1)
                                                * w1.reshape(-1)[:, None, None] == 0))


def _seeded_head(inter, seed=2):
    torch.manual_seed(seed)
    head = MaskHead(2 * C_IN, inter, HEADS)
    with torch.no_grad():
        for p in head.parameters():  # biases off zero, the ReLUs half open
            p.mul_(1.5).add_(0.05 * torch.randn_like(p))
    return head


def _old_mask_head(head, path1, target_hw):
    """`MaskHead.forward`'s unfused branch as it ran the tail before: the
    fused 3x3 with its bias, the ReLU, the grouped 1x1 conv."""
    up, heads = head.upsample_2x, head.mask_heads
    feat = F.conv2d(path1, head.output_conv1.weight, head.output_conv1.bias,
                    padding=1)
    feat = F.conv_transpose2d(feat, up[0].weight, up[0].bias, 2, 1)
    feat = F.relu(F.conv2d(F.relu(feat), up[2].weight, up[2].bias, padding=1))
    feat = resize_bilinear(feat, target_hw, antialias=True)
    k = torch.cat([h[0].weight for h in heads])
    b = torch.cat([h[0].bias for h in heads])
    w1 = torch.cat([h[2].weight for h in heads])
    return _old_tail(feat, k, b, w1.reshape(HEADS, -1),
                     torch.cat([h[2].bias for h in heads]))


@pytest.mark.parametrize("inter", [8, 32])
def test_mask_head_matches_old_chain(inter):
    """`MaskHead` on the CPU (the plain route) against the old chain, fp32:
    the logits within 1e-6 of their scale and every parameter's gradient
    within 1e-5 of its own, on a loss that weighs each pixel."""
    head = _seeded_head(inter)
    path1 = torch.randn(BATCH, 2 * C_IN, 6, 5,
                        generator=torch.Generator().manual_seed(4))
    target = (24, 20)
    wts = torch.randn(BATCH, HEADS, *target,
                      generator=torch.Generator().manual_seed(6))

    def run(fn):
        head.zero_grad()
        out = fn()
        (out * wts).sum().backward()
        return out.detach(), {n: p.grad.clone() for n, p in head.named_parameters()}

    new, g_new = run(lambda: head(path1, target))
    old, g_old = run(lambda: _old_mask_head(head, path1, target))
    assert new.shape == (BATCH, HEADS, *target)
    assert float((new - old).abs().max()) <= 1e-6 * float(old.abs().max())
    assert g_new.keys() == g_old.keys()
    for name, ref in g_old.items():
        err = float((g_new[name] - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (name, err)


def test_cpu_and_float32_launch_nothing():
    """The CPU route, in fp32 and bf16, and a float32 call: the plain
    version under autograd, no launch of either pass."""
    before = (ml.mask_logits.launches, ml.mask_logits_bwd.launches)
    head = _seeded_head(8)
    for dtype in (torch.float32, torch.bfloat16):
        path1 = torch.randn(1, 2 * C_IN, 4, 4).to(dtype)
        head.to(dtype)(path1, (8, 8)).float().sum().backward()
    feat, k, b, w1, b1 = _case(8, (5, 5))
    pre = F.conv2d(feat, k, padding=1).requires_grad_()
    ml.mask_logits_autograd(pre, b, w1, b1).sum().backward()
    assert pre.grad is not None
    assert (ml.mask_logits.launches, ml.mask_logits_bwd.launches) == before
