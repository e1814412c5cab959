"""On the card: the DPT mask heads' logits tail pass (`mask_logits`) and
its backward (`mask_logits_bwd`) against their plain versions at ViT-B's
widths (3 heads of 32 channels) at 1024^2 batch 4 and 2048^2 batch 1, at
the tiny configs' width (8 channels a head) and at a ragged pixel count,
channels_last (as the decoder runs) and NCHW; planted 1% faults caught;
two backwards equal; and the launches of a ViT-B 1024^2 b4 training step.
The file imports no JAX.

    python3 chip_smoke.py -k mask_logits
"""

import math

import pytest
import torch

from s3od_torch.ops import mask_logits as ml
from s3od_torch.ops.precision import set_exact_float32

from _cuda import (cuda, fixture_batch, rel_norm, seeded_model,  # noqa: F401
                   tf32_restored)

pytestmark = pytest.mark.cuda

HEADS = 3
# (batch, channels a head, height, width, channels_last)
CASES = {"vitb-1024-b4": (4, 32, 1024, 1024, True),
         "vitb-1024-b4-nchw": (4, 32, 1024, 1024, False),
         "vitb-2048-b1": (1, 32, 2048, 2048, True),
         "tiny-inter8": (2, 8, 256, 256, True),
         "ragged": (3, 32, 37, 53, True), "ragged-nchw": (3, 32, 37, 53, False)}
# ||kernel - plain|| / ||plain|| of the logits: both sum the same fp32
# terms and round once to bf16, in another order, so they differ by one
# bf16 ulp on a small share of the pixels; a tenth of the planted x 1.01
FWD_NORM_TOL = 1e-3
# the same of each parameter gradient, fp32 sums over up to 4M pixels in
# another order (per-program partials against torch's reduction); a
# hundredth of the planted x 1.01
PARAM_NORM_TOL = 1e-4


def _case(batch, inter, h, w, channels_last, dev, seed=11):
    """(pre, b_fused, w1, b1, dm): the 3x3's output near zero so the ReLU
    cuts about half of it, bf16 as the model casts its weights at use;
    the maps in the memory format asked for."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev)
                               * scale).to(torch.bfloat16)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    c = HEADS * inter
    return (r(batch, c, h, w).contiguous(memory_format=fmt), r(c, scale=0.3),
            r(HEADS, inter, scale=0.3), r(HEADS, scale=0.3),
            r(batch, HEADS, h, w, scale=1e-3).contiguous(memory_format=fmt))


def _format(t):
    return (torch.channels_last if not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _exact(fn, *args):
    """`fn(*args)` with TF32 off (the plain forward's 1x1 is a cuDNN
    conv, which runs float32 in TF32 by default)."""
    with tf32_restored():
        set_exact_float32()
        return fn(*args)


def _ulp(t) -> float:
    """One bf16 ulp at the largest magnitude of `t`."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


def _forward_close(got, ref) -> None:
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert float((got.float() - ref.float()).abs().max()) <= _ulp(ref)
    assert rel_norm(got, ref) <= FWD_NORM_TOL, rel_norm(got, ref)


def _backward_close(got, ref) -> None:
    """dpre within one bf16 ulp of its scale (the same exact fp32 product
    rounded once, so equal but for the ReLU's edge) and by FWD_NORM_TOL;
    the three parameter gradients by PARAM_NORM_TOL."""
    dpre, params = got[0], got[1:]
    assert dpre.dtype == torch.bfloat16 and dpre.shape == ref[0].shape
    assert torch.isfinite(dpre).all()
    assert float((dpre.float() - ref[0].float()).abs().max()) <= _ulp(ref[0])
    assert rel_norm(dpre, ref[0]) <= FWD_NORM_TOL, rel_norm(dpre, ref[0])
    for g, r in zip(params, ref[1:]):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert rel_norm(g, r) <= PARAM_NORM_TOL, rel_norm(g, r)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_plain_on_cuda(cuda, case):
    """The logits against the plain version on the card, bf16: within one
    bf16 ulp of their scale and FWD_NORM_TOL, in `pre`'s memory format,
    one launch; x 1.01 fails."""
    pre, b_fused, w1, b1, _ = _case(*CASES[case], cuda)
    before = ml.mask_logits.launches
    got = ml.mask_logits(pre, b_fused, w1, b1)
    torch.cuda.synchronize()
    assert ml.mask_logits.launches == before + 1
    assert got.is_contiguous(memory_format=_format(pre))
    ref = _exact(ml.mask_logits_plain, pre, b_fused, w1, b1)
    _forward_close(got, ref)
    with pytest.raises(AssertionError):
        _forward_close((got.float() * 1.01).to(torch.bfloat16), ref)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_plain_on_cuda(cuda, case):
    """dpre, db_fused, dw1 and db1 against the plain backward on the card,
    dpre in `pre`'s memory format, one launch; a second call gives the
    same four bit for bit (partials summed in a fixed order, no atomics);
    each output x 1.01 fails."""
    pre, b_fused, w1, _, dm = _case(*CASES[case], cuda)
    before = ml.mask_logits_bwd.launches
    got = ml.mask_logits_bwd(dm, pre, b_fused, w1)
    torch.cuda.synchronize()
    assert ml.mask_logits_bwd.launches == before + 1
    assert got[0].stride() == pre.stride()
    ref = ml.mask_logits_bwd_plain(dm, pre, b_fused, w1)
    _backward_close(got, ref)
    again = ml.mask_logits_bwd(dm, pre, b_fused, w1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in range(4):
        faulty = list(got)
        faulty[i] = (got[i].float() * 1.01).to(got[i].dtype)
        with pytest.raises(AssertionError):
            _backward_close(faulty, ref)


def test_autograd_matches_fp32_autograd_on_cuda(cuda):
    """The autograd route at ViT-B 1024^2 b1 with fp32 master weights
    cast to bf16 at use, as `MaskHead` runs it: one launch each way, the
    gradients of `pre` and of the fp32 leaves against fp32 autograd of the
    plain version on the same bf16 values."""
    pre, b_fused, w1, b1, dm = _case(1, 32, 1024, 1024, True, cuda)
    masters = [t.float().requires_grad_() for t in (b_fused, w1, b1)]
    pre = pre.requires_grad_()
    fwd, bwd = ml.mask_logits.launches, ml.mask_logits_bwd.launches
    out = ml.mask_logits_autograd(pre, *(t.to(torch.bfloat16) for t in masters))
    gots = torch.autograd.grad(out, [pre, *masters], dm)
    torch.cuda.synchronize()
    assert (ml.mask_logits.launches - fwd, ml.mask_logits_bwd.launches - bwd) == (1, 1)
    leaves = [pre.detach().float().requires_grad_(), *(
        t.detach().clone().requires_grad_() for t in masters)]
    refs = _exact(lambda: torch.autograd.grad(ml.mask_logits_plain(*leaves),
                                              leaves, dm.float()))
    for got, ref, leaf in zip(gots, refs, [pre, *masters]):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        # dpre rounds to bf16 once; the parameters' gradients take bf16's
        # rounding of the fp32 sums, as the chain's cuDNN gradients did
        assert rel_norm(got, ref) <= 2.0**-8, rel_norm(got, ref)


def test_train_step_launches_on_cuda(cuda):
    """`train_step` at ViT-B, 1024^2, batch 4, bf16: each pass once a
    step, and the loss finite."""
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    model = seeded_model(4)
    opt = Optimizer(model, 1e-4, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    batch = fixture_batch(4, 1024)
    for i in range(2):
        fwd, bwd = ml.mask_logits.launches, ml.mask_logits_bwd.launches
        loss = float(train_step(model, opt, loss_module, batch, 0, i,
                                generator=torch.Generator().manual_seed(i),
                                compute_dtype=torch.bfloat16)["loss"])
        assert (ml.mask_logits.launches - fwd,
                ml.mask_logits_bwd.launches - bwd) == (1, 1)
        assert math.isfinite(loss)
