"""On the card: the MMDiT's q/k RMSNorm + RoPE + q scale + head layout
pass (`qk_norm_rope`) and its backward (`qk_norm_rope_bwd`) against their
plain versions at FLUX.1-dev's widths (24 heads of 128): one source of
4608 tokens (a single block), the joint (512, 4096) pair of a dual block,
the concept pair (13 concept tokens beside 4096 image tokens), 4101
tokens padded to 4160 and a batch of two (512, 1536) pairs; planted 1%
faults caught; and the launches of a
LoRA step through a small MMDiT at D = 128. The file imports no JAX.

    python3 chip_smoke.py -k qk_norm_rope
"""

import math

import pytest
import torch

from s3od_torch.ops import flash_attention as fa
from s3od_torch.ops import qk_norm_rope as qr

from _cuda import cuda, rel_norm  # noqa: F401

pytestmark = pytest.mark.cuda

HEADS, HEAD_DIM = 24, 128
# (batch, tokens of each source)
CASES = {"single-4608": (1, (4608,)), "joint-512-4096": (1, (512, 4096)),
         "concept-13-4096": (1, (13, 4096)), "ragged-4101": (1, (4101,)),
         "batch2-512-1536": (2, (512, 1536))}
# ||kernel - plain|| / ||plain|| of the forward's outputs: the two round
# the same fp32 values to bf16 and differ where the rsqrt's last bits or
# a fused multiply-add move a value across a rounding boundary, one bf16
# ulp (2^-8 relative at most) on a small share of the elements; a tenth
# of the planted x 1.01
FWD_NORM_TOL = 1e-3
BF16_VJP_TOL = 2.0**-7  # as `tests/_vjp_cases.py`


def _case(batch, sizes, dev, seed=21):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0, mean=0.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale
                + mean).to(torch.bfloat16)

    width = 3 * HEADS * HEAD_DIM
    sources = [(r(batch, n, width, scale=1.5), r(HEAD_DIM, scale=0.3, mean=1.0),
                r(HEAD_DIM, scale=0.3, mean=1.0)) for n in sizes]
    n = sum(sizes)
    theta = torch.rand(n, HEAD_DIM // 2, generator=gen, device=dev) * 40
    cos = torch.repeat_interleave(theta.cos(), 2, -1)
    sin = torch.repeat_interleave(theta.sin(), 2, -1)
    return sources, cos, sin, fa.flash_seq_len(n)


def _ulp(t) -> float:
    """One bf16 ulp at the largest magnitude of `t`."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


def _forward_close(gots, refs) -> None:
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert got.is_contiguous() and torch.isfinite(got).all()
        assert float((got.float() - ref.float()).abs().max()) <= _ulp(ref)
        assert rel_norm(got, ref) <= FWD_NORM_TOL, rel_norm(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_plain_on_cuda(cuda, case):
    """q, k, v against the plain version (the eager chain) on the card,
    bf16: max error within one bf16 ulp of each output's scale, relative
    norm within FWD_NORM_TOL, the padded rows zero, one launch; q x 1.01
    fails."""
    sources, cos, sin, n_pad = _case(*CASES[case], cuda)
    scale = HEAD_DIM**-0.5
    before = qr.qk_norm_rope.launches
    got = qr.qk_norm_rope(sources, cos, sin, scale, n_pad)
    torch.cuda.synchronize()
    assert qr.qk_norm_rope.launches == before + 1
    ref = qr.qk_norm_rope_plain(sources, cos, sin, scale, n_pad)
    _forward_close(got, ref)
    n = sum(CASES[case][1])
    assert all(not t[:, n:].any() for t in got)
    with pytest.raises(AssertionError):
        _forward_close([(got[0].float() * 1.01).to(torch.bfloat16)], ref[:1])


@pytest.mark.parametrize("weight_grads", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_fp32_autograd_on_cuda(cuda, case, weight_grads):
    """The autograd wrapper's bf16 gradients (one backward launch) against
    autograd through the plain version in fp32 on the card, by relative
    norm within 2^-7; the norm weights' gradients where they require
    grad, none computed where they do not; one gradient x 1.01 fails."""
    sources, cos, sin, n_pad = _case(*CASES[case], cuda)
    scale = HEAD_DIM**-0.5
    leaves = [[src[0].clone().requires_grad_()]
              + [w.clone().requires_grad_(weight_grads) for w in src[1:]]
              for src in sources]
    outs = qr.qk_norm_rope_autograd(leaves, cos, sin, scale, n_pad)
    gen = torch.Generator(device=cuda).manual_seed(4)
    cots = [torch.randn(o.shape, generator=gen, device=cuda).to(o.dtype)
            for o in outs]
    flat = [t for src in leaves for t in src if t.requires_grad]
    before = qr.qk_norm_rope_bwd.launches
    gots = torch.autograd.grad(outs, flat, cots)
    torch.cuda.synchronize()
    assert qr.qk_norm_rope_bwd.launches == before + 1
    assert len(gots) == len(sources) * (3 if weight_grads else 1)
    ref_leaves = [[t.detach().float().requires_grad_(t.requires_grad)
                   for t in src] for src in leaves]
    ref_outs = qr.qk_norm_rope_plain(ref_leaves, cos, sin, scale, n_pad)
    refs = torch.autograd.grad(
        ref_outs, [t for src in ref_leaves for t in src if t.requires_grad],
        [c.float() for c in cots])
    for got, ref, leaf in zip(gots, refs, flat):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert torch.isfinite(got).all()
        assert rel_norm(got, ref) < BF16_VJP_TOL, rel_norm(got, ref)
    assert rel_norm(gots[0] * 1.01, refs[0]) >= BF16_VJP_TOL


def test_lora_step_launches_on_cuda(cuda):
    """A LoRA step through a small MMDiT at D = 128 and 1088 tokens (1024
    image + 64 text, K7's route): one forward and one backward launch per
    block, 2 x (dual + single) in all, and one K7 per attention."""
    from s3od_torch.datagen import lora as L
    from s3od_torch.datagen.diffusion import make_img_ids
    from s3od_torch.models import mmdit as tm

    cfg = tm.MMDiTConfig(hidden_size=256, num_heads=2, num_dual_blocks=2,
                         num_single_blocks=3, text_dim=64, pooled_dim=32,
                         in_channels=16, axes_dims=(16, 56, 56),
                         feature_taps=(1,))
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = tm.init_mmdit(cfg, gen, dtype=torch.bfloat16)
    lcfg = L.LoRAConfig()
    lora = L.init_lora_params(gen, model, lcfg)
    step = L.make_lora_train_step(model, lcfg, L.lora_optimizer(lora, 1e-4))
    batch = {"latents": torch.randn(1, 1024, 16, device=cuda),
             "txt": torch.randn(1, 64, 64, device=cuda),
             "pooled": torch.randn(1, 32, device=cuda),
             "img_ids": torch.from_numpy(make_img_ids(32, 32)).to(cuda),
             "txt_ids": torch.zeros(64, 3, device=cuda)}
    blocks = cfg.num_dual_blocks + cfg.num_single_blocks
    fwd, bwd = qr.qk_norm_rope.launches, qr.qk_norm_rope_bwd.launches
    k7 = fa.flash_attention_online.launches
    loss = step(lora, batch, gen)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert qr.qk_norm_rope.launches - fwd == blocks
    assert qr.qk_norm_rope_bwd.launches - bwd == blocks
    assert fa.flash_attention_online.launches - k7 == blocks
