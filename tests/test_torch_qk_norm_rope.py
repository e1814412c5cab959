"""The MMDiT's q/k RMSNorm + RoPE + q scale + head layout step
(`s3od_torch/ops/qk_norm_rope.py`) on the CPU: its plain version against
the eager chain it was moved from, written out here (`_eager_chain`), in
values and gradients; its written-out backward against autograd through
the plain version in fp32; K7's head-major entry against
`multi_head_attention`'s flash route; and the MMDiT's forward against the
blocks as they ran the chain before (`_old_dual`, `_old_single`), bit for
bit. The Triton passes themselves are held on the card by
`tests/test_torch_qk_norm_rope_cuda.py`."""

from __future__ import annotations

import pytest
import torch

from s3od_torch.models import mmdit as tm
from s3od_torch.ops import attention as xa
from s3od_torch.ops import flash_attention as fa
from s3od_torch.ops import qk_norm_rope as qr

# (tokens of each source): one source on a multiple of 64, two, and two
# whose 77 tokens pad to 128
CASES = {"one": (64,), "two": (24, 40), "padded": (7, 70)}
HEADS, HEAD_DIM, BATCH = 4, 24, 2  # the tiny MMDiT's heads


def _case(sizes, dtype=torch.bfloat16, seed=3):
    """(sources, cos, sin, n_pad): linear outputs at the scale the tiny
    model gives them, norm weights around 1, the tiny config's RoPE tables
    over (id, y, x) coordinates."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0, mean=0.0: (
        torch.randn(*s, generator=gen) * scale + mean).to(dtype)
    width = 3 * HEADS * HEAD_DIM
    sources = [(r(BATCH, n, width, scale=2.0), r(HEAD_DIM, scale=0.3, mean=1.0),
                r(HEAD_DIM, scale=0.3, mean=1.0)) for n in sizes]
    n = sum(sizes)
    ids = torch.randint(0, 40, (n, 3), generator=gen).float()
    cos, sin = tm.rope_from_ids(ids, tm.tiny_mmdit_config().axes_dims, 1e4)
    return sources, cos, sin, fa.flash_seq_len(n)


def _eager_chain(sources, cos, sin, scale, n_pad):
    """The chain as the MMDiT ran it: each stream's qkv output split into
    heads and RMS-normalised in fp32, the streams concatenated, the pairs
    rotated in fp32, q times the scale rounded to its dtype, then
    (B*H, n_pad, D) with zero rows."""
    def rms(x, w):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
        return (y * w.float()).to(x.dtype)

    def rot(t):
        tf = t.float()
        x2 = tf.reshape(*tf.shape[:-1], -1, 2)
        pairs = torch.stack([-x2[..., 1], x2[..., 0]], -1).reshape(tf.shape)
        return (tf * cos[None, :, None] + pairs * sin[None, :, None]).to(t.dtype)

    def bhnd(t):
        b, n, h, d = t.shape
        t = t.transpose(1, 2).reshape(b * h, n, d)
        return torch.nn.functional.pad(t, (0, 0, 0, n_pad - n))

    qs, ks, vs = [], [], []
    for qkv, wq, wk in sources:
        q, k, v = qkv.reshape(*qkv.shape[:-1], 3, HEADS, HEAD_DIM).unbind(-3)
        qs.append(rms(q, wq)), ks.append(rms(k, wk)), vs.append(v)
    q, k = rot(torch.cat(qs, 1)), rot(torch.cat(ks, 1))
    q = q * float(torch.tensor(scale, dtype=q.dtype))
    return bhnd(q), bhnd(k), bhnd(torch.cat(vs, 1))


def _leaves(sources):
    return [[t.clone().requires_grad_() for t in src] for src in sources]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_eager_chain(case):
    """`qk_norm_rope_plain` equals the chain, bit for bit, in its outputs
    (padded rows zero) and in the gradients of the linear outputs and the
    norm weights, in bf16."""
    sources, cos, sin, n_pad = _case(CASES[case])
    scale = HEAD_DIM**-0.5
    got_leaves, ref_leaves = _leaves(sources), _leaves(sources)
    got = qr.qk_norm_rope_plain(got_leaves, cos, sin, scale, n_pad)
    ref = _eager_chain(ref_leaves, cos, sin, scale, n_pad)
    n = sum(CASES[case])
    for g, r in zip(got, ref):
        assert g.shape == (BATCH * HEADS, n_pad, HEAD_DIM)
        assert g.dtype == torch.bfloat16 and torch.equal(g, r)
        assert not g[:, n:].any()
    cots = [torch.randn(g.shape, generator=torch.Generator().manual_seed(i)
                        ).to(g.dtype) for i, g in enumerate(got)]
    flat_g = [t for src in got_leaves for t in src]
    flat_r = [t for src in ref_leaves for t in src]
    for a, b in zip(torch.autograd.grad(got, flat_g, cots),
                    torch.autograd.grad(ref, flat_r, cots)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weight_grads", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_written_out_backward_matches_fp32_autograd(case, weight_grads):
    """The autograd wrapper's bf16 gradients (on the CPU: the plain
    forward and `qk_norm_rope_bwd_plain`) against autograd through the
    plain version in fp32, by relative norm within 2^-7 (the rule of the
    other written-out backwards, `tests/_vjp_cases.py`); the norm weights'
    gradients only where they require grad; one gradient x 1.01 fails."""
    sources, cos, sin, n_pad = _case(CASES[case])
    scale = HEAD_DIM**-0.5
    leaves = [[src[0].clone().requires_grad_()]
              + [w.clone().requires_grad_(weight_grads) for w in src[1:]]
              for src in sources]
    outs = qr.qk_norm_rope_autograd(leaves, cos, sin, scale, n_pad)
    gen = torch.Generator().manual_seed(5)
    cots = [torch.randn(o.shape, generator=gen).to(o.dtype) for o in outs]
    flat = [t for src in leaves for t in src if t.requires_grad]
    gots = torch.autograd.grad(outs, flat, cots)
    if not weight_grads:
        assert len(gots) == len(sources)
    ref_leaves = [[t.detach().float().requires_grad_(t.requires_grad)
                   for t in src] for src in leaves]
    ref_outs = qr.qk_norm_rope_plain(ref_leaves, cos, sin, scale, n_pad)
    refs = torch.autograd.grad(
        ref_outs, [t for src in ref_leaves for t in src if t.requires_grad],
        [c.float() for c in cots])

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    for got, ref, leaf in zip(gots, refs, flat):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        assert rel(got, ref) < 2.0**-7, rel(got, ref)
    assert rel(gots[0] * 1.01, refs[0]) >= 2.0**-7


def test_flash_heads_entry_is_the_flash_route():
    """K7 through `flash_attention_heads` on the plain version's outputs
    equals `multi_head_attention`'s flash route on the chain's (B, N, H,
    D) tensors, bit for bit, padded rows and `n_valid` included (CPU: K7's
    plain version)."""
    sources, cos, sin, n_pad = _case(CASES["padded"])
    n = sum(CASES["padded"])
    scale = HEAD_DIM**-0.5
    parts = [qr.qk_norm_heads(qkv, wq, wk, HEAD_DIM) for qkv, wq, wk in sources]
    q, k, v = (torch.cat(t, 1) for t in zip(*parts))
    q, k = qr.apply_rope(q, k, cos, sin)
    ref = xa.multi_head_attention(q, k, v, scale=scale, impl="flash")
    got = xa.flash_attention_heads(
        *qr.qk_norm_rope_plain(sources, cos, sin, scale, n_pad), BATCH, n)
    assert got.shape == (BATCH, n, HEADS, HEAD_DIM) and torch.equal(got, ref)
    with pytest.raises(ValueError):
        xa.flash_attention_heads(*qr.qk_norm_rope_plain(
            sources, cos, sin, scale, n_pad + 64), BATCH, n)


# ----------------------------------------------------------------------------
# The MMDiT's forward, against its blocks as they were
# ----------------------------------------------------------------------------


def _old_heads(x, attn_qkv, qk_norm, d):
    y = tm._linear(x, attn_qkv).reshape(*x.shape[:-1], 3, -1, d)
    q, k, v = y.unbind(-3)
    return qr.rms_norm(q, qk_norm.q), qr.rms_norm(k, qk_norm.k), v


def _old_dual(blk, img, txt, concept, temb, concept_temb, rope_ti, rope_ci,
              attn_impl):
    d = blk.head_dim
    shift_i, scale_i, gate_i, shift_mi, scale_mi, gate_mi = tm._modulation(
        temb, blk.img_mod, 6)
    shift_t, scale_t, gate_t, shift_mt, scale_mt, gate_mt = tm._modulation(
        temb, blk.txt_mod, 6)
    qi, ki, vi = _old_heads(tm._mod(img, shift_i, scale_i), blk.img_attn.qkv,
                            blk.img_attn.qk_norm, d)
    qt, kt, vt = _old_heads(tm._mod(txt, shift_t, scale_t), blk.txt_attn.qkv,
                            blk.txt_attn.qk_norm, d)
    q, k = qr.apply_rope(torch.cat([qt, qi], 1), torch.cat([kt, ki], 1),
                         *rope_ti)
    attn = xa.multi_head_attention(q, k, torch.cat([vt, vi], 1),
                                   scale=d**-0.5, impl=attn_impl)
    n_txt = txt.shape[1]
    attn_t = tm._linear(attn[:, :n_txt].flatten(2), blk.txt_attn.proj)
    attn_i = tm._linear(attn[:, n_txt:].flatten(2), blk.img_attn.proj)
    new_concept, maps_vecs = None, None
    if concept is not None:
        eff = concept_temb if concept_temb is not None else temb
        sc, scc, gc, smc, sccm, gcm = tm._modulation(eff, blk.txt_mod, 6)
        qc, kc, vc = _old_heads(tm._mod(concept, sc, scc), blk.txt_attn.qkv,
                                blk.txt_attn.qk_norm, d)
        q2, k2 = qr.apply_rope(torch.cat([qc, qi], 1),
                               torch.cat([kc, ki], 1), *rope_ci)
        cattn = xa.multi_head_attention(q2, k2, torch.cat([vc, vi], 1),
                                        scale=d**-0.5, impl=attn_impl)
        attn_c = tm._linear(cattn[:, :concept.shape[1]].flatten(2),
                            blk.img_attn.proj)
        maps_vecs = (attn_c, attn_i)
        dt = concept.dtype
        concept = concept + gc[:, None].to(dt) * attn_c
        ff_c = blk._mlp(tm._mod(concept, smc, sccm), blk.txt_mlp)
        new_concept = concept + gcm[:, None].to(dt) * ff_c
    dt = img.dtype
    img = img + gate_i[:, None].to(dt) * attn_i
    img = img + gate_mi[:, None].to(dt) * blk._mlp(
        tm._mod(img, shift_mi, scale_mi), blk.img_mlp)
    txt = txt + gate_t[:, None].to(dt) * attn_t
    txt = txt + gate_mt[:, None].to(dt) * blk._mlp(
        tm._mod(txt, shift_mt, scale_mt), blk.txt_mlp)
    return img, txt, new_concept, maps_vecs


def _old_single(blk, x, temb, rope, attn_impl):
    shift, scale, gate = tm._modulation(temb, blk.mod, 3)
    x_n = tm._mod(x, shift, scale)
    q, k, v = _old_heads(x_n, blk.qkv, blk.qk_norm, blk.head_dim)
    q, k = qr.apply_rope(q, k, *rope)
    attn = xa.multi_head_attention(q, k, v, scale=blk.head_dim**-0.5,
                                   impl=attn_impl).flatten(2)
    mlp = torch.nn.functional.gelu(tm._linear(x_n, blk.mlp_in),
                                   approximate="tanh")
    out = tm._linear(torch.cat([attn, mlp], -1), blk.proj_out)
    return x + gate[:, None].to(x.dtype) * out


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("with_concepts", [False, True])
def test_mmdit_forward_on_cpu_is_unchanged(with_concepts, impl):
    """The tiny MMDiT's bf16 forward on the CPU (the eager chain; "flash"
    runs K7's plain version) equals the same forward with every block run
    as it ran before the chain moved into `ops/qk_norm_rope.py`, bit for
    bit: velocity, taps, concept maps and streams."""
    from s3od_torch.datagen.diffusion import make_img_ids

    cfg = tm.tiny_mmdit_config()
    model = tm.init_mmdit(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith((".q", ".k")):
                prm.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(
                    len(name)))
    gen = torch.Generator().manual_seed(1)
    f = lambda *s: torch.randn(*s, generator=gen)
    ph, pw, n_txt = 4, 6, 8
    inp = dict(latents=f(1, ph * pw, cfg.in_channels),
               txt=f(1, n_txt, cfg.text_dim), pooled=f(1, cfg.pooled_dim),
               timestep=torch.full((1,), 0.7),
               img_ids=torch.from_numpy(make_img_ids(ph, pw)),
               txt_ids=torch.zeros(n_txt, 3), guidance=torch.full((1,), 3.5))
    if with_concepts:
        inp.update(concepts=f(1, 3, cfg.text_dim),
                   pooled_concepts=f(1, cfg.pooled_dim))

    def old(blk, *args):
        return (_old_dual if isinstance(blk, tm.DualBlock) else _old_single)(
            blk, *args)

    with torch.no_grad():
        got = model(attn_impl=impl, **inp)
        ref = model(attn_impl=impl, run_block=old, **inp)
    for key in ("output", "image_out", "concept_out", "concept_maps"):
        if ref[key] is None:
            assert got[key] is None
        else:
            assert torch.equal(got[key], ref[key]), key
    assert all(torch.equal(g, r) for g, r in zip(got["features"],
                                                  ref["features"]))
