"""On the card: each kernel of the port (K1-K10) against its plain PyTorch
version in bf16, at the shapes the main paths give it (DINOv3 ViT-S, -B
and -L at 1024^2, batch 1, 4 and 16; ViT-B at 2048^2: 16389 tokens padded
to 16448; the tiny checkpoints' D = 32; the FLUX.1-dev MMDiT's D = 128;
the decoder's convs at 1024^2 and 2048^2) and at ragged ones, with the
adversarial inputs of each (logits at +-1000 scale, row maxima near the
+-40 window, rows of near-zero variance, NHWC and H-innermost memory),
one launch counted per call and planted faults caught. The file imports
no JAX: run it on the card with

    python3 chip_smoke.py -k kernels
"""

import pytest
import torch

from s3od_torch.models.dinov3 import _full_tables
from s3od_torch.ops import attn_epilogue as ae
from s3od_torch.ops import flash_attention as fa
from s3od_torch.ops import layernorm as ln
from s3od_torch.ops import mlp_fused as mf
from s3od_torch.ops import qkv_project as qp
from s3od_torch.ops.experimental import mask_tail as mt
from s3od_torch.ops.experimental import winograd as wg

from _cuda import (B16, DEC_CALL_TOL, FLASH_NORM_TOL, K8D_CALL_TOL,  # noqa: F401
                   close, cuda, planted, rel_norm)

pytestmark = pytest.mark.cuda

# ||kernel - plain|| / ||plain|| of K1's and K4's outputs per call: the two
# round the same fp32 values, summed in another order, to bf16 (K4 ~4e-5
# on the H100); half the planted x 1.01 (1.0e-2), which REL_TOL alone sits
# on the edge of (as on K3 and K2)
LN_NORM_TOL = 5e-3
# ||kernel q, k, v - plain|| / ||plain|| of each K2 call: the two round the
# same fp32 values to bf16 (the sums in another order), about 6e-5 on the
# H100; half the planted q x 1.01 (1.0e-2), which REL_TOL alone sits on
# the edge of
K2_NORM_TOL = 5e-3
# ||launch - plain half|| / ||plain half|| of each K5 launch on its own
# inputs: the kernel and the plain version round the same fp32 sums, which
# differ only in their order; the planted hidden x 1.01 reads 1e-2
K5_HALF_TOL = 5e-3
# ||kernel - plain|| / ||plain|| of K10's out on random inputs: 1.5x the
# worst measured on an H100 80GB HBM3 at 700 W (2.76e-4, NHWC memory). Both
# round h1, h2 and out to bf16 after fp32 sums in different orders, and a
# few outputs in a thousand land one bf16 step apart; the planted out x
# 1.01 reads 1.0e-2
K10_NORM_TOL = 4.2e-4

# (batch, tokens, width, heads) of the encoders' blocks: ragged and small,
# the tiny checkpoints' D = 32, ViT-S, -B and -L at 1024^2, ViT-B at batch
# 4 and 16 and at 2048^2
ENCODER = {"d32-192": (2, 192, 128, 4), "d64-192": (2, 192, 256, 4),
           "d64-320-b2": (2, 320, 768, 12), "tiny-1024": (2, 4160, 64, 2),
           "vits-1024": (1, 4160, 384, 6), "vitb-1024": (1, 4160, 768, 12),
           "vitb-1024-b4": (4, 4160, 768, 12), "vitb-1024-b16": (B16, 4160, 768, 12),
           "vitl-1024": (1, 4160, 1024, 16), "vitb-2048": (1, 16448, 768, 12)}
# the RoPE grid of a padded sequence length; others take random tables
GRID = {4160: 64, 16448: 128}


def _gen(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    return gen, randn


def _caught(got, ref, which, **kw):
    with pytest.raises(AssertionError):
        close(planted(got, which), ref, **kw)


@pytest.mark.parametrize("case", list(ENCODER))
def test_layer_norm_matches_plain_on_cuda(cuda, case):
    """K1 (Triton) at every encoder shape: y, mean and rstd by max error
    and relative norm, a planted y x 1.01 caught; Triton's cache lands in
    the build directory."""
    from s3od_torch import _build

    b, n, c, _ = ENCODER[case]
    _, randn = _gen(cuda, 0)
    x = randn(b * n, c, scale=2.0, shift=0.5)
    w, bias = randn(c, scale=0.5, shift=1.0), randn(c, scale=0.2)
    got, ref = ln.layer_norm(x, w, bias, 1e-5), ln.layer_norm_plain(x, w, bias, 1e-5)
    close(got, ref, norm_tol=LN_NORM_TOL)
    _caught(got, ref, 0, norm_tol=LN_NORM_TOL)
    assert (_build.build_dir() / "triton").is_dir()


@pytest.mark.parametrize("case", list(ENCODER))
def test_qkv_project_rope_matches_plain_on_cuda(cuda, case):
    """K2 (the qkv GEMM with RoPE: the `mma.sync` kernel at D = 32, TMA +
    `wgmma` at 64) at every encoder shape, the key bias zero as the
    encoder has it, RoPE on the sequence's own grid: q, k, v by max error
    and relative norm, one launch a call, a planted q x 1.01 caught."""
    b, n, c, h = ENCODER[case]
    d = c // h
    gen, randn = _gen(cuda, 1)
    w, bias = randn(3 * c, c, scale=0.02), randn(3 * c, scale=0.1)
    bias[c: 2 * c] = 0
    if n in GRID:
        cos, sin = _full_tables(GRID[n], GRID[n], d, 100.0, 5, n, cuda)
    else:
        cos, sin = (torch.rand(n, d, generator=gen, device=cuda) for _ in range(2))
    args = (randn(b, n, c), w, bias, cos, sin, h, d**-0.5)
    before = qp.qkv_project_rope.launches
    got = qp.qkv_project_rope(*args)
    assert qp.qkv_project_rope.launches == before + 1
    ref = qp.qkv_project_rope_plain(*args)
    close(got, ref, norm_tol=K2_NORM_TOL)
    _caught(got, ref, 0, norm_tol=K2_NORM_TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("flat", [False, True], ids=["normal", "flat-rows"])
@pytest.mark.parametrize("case", list(ENCODER))
def test_attn_epilogue_matches_plain_on_cuda(cuda, case, flat):
    """K4 (the cluster `wgmma` kernel; `mma.sync` at D = 32) at every
    encoder shape, and on rows of small variance (x = 3 + 1e-3 noise, Wo
    ~ 1e-5, so x' varies along a row only by bo ls, std ~0.1: the variance
    clamp and the cross-block sums matter most there): x' and h by max
    error and relative norm, one launch a call, planted x' x 1.01 and h x
    1.01 caught. On those rows a one-ulp flip of x' (0.0156 at 3; the fp32
    sums round from another order) moves h by ulp / std, past REL_TOL of
    max|h|: there h is held by max error to the plain LayerNorm of the
    kernel's own x', and to the plain h by relative norm."""
    b, n, c, h = ENCODER[case]
    _, randn = _gen(cuda, 5)
    x = randn(b, n, c, scale=1e-3, shift=3.0) if flat else randn(b, n, c)
    args = (randn(b * h, n, c // h, scale=0.5),
            randn(c, c, scale=1e-5 if flat else 0.02), randn(c, scale=0.1), x,
            randn(c, scale=0.5, shift=1.0), randn(c, scale=0.5, shift=1.0),
            randn(c, scale=0.2), 1e-5)
    before = ae.attn_epilogue.launches
    got = ae.attn_epilogue(*args)
    assert ae.attn_epilogue.launches == before + 1
    ref = ae.attn_epilogue_plain(*args)
    if flat:
        assert rel_norm(got[1], ref[1]) <= LN_NORM_TOL
        ref = (ref[0], ln.layer_norm_plain(got[0], *args[5:])[0])
    close(got, ref, norm_tol=LN_NORM_TOL)
    _caught(got, ref, 0, norm_tol=LN_NORM_TOL)
    _caught(got, ref, 1, norm_tol=LN_NORM_TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows,c,f", [
    (100, 64, 128), (100, 64, 256), (300, 1024, 4096), (384, 128, 512),
    (4160, 64, 128), (4160, 384, 1536), (4160, 768, 3072), (4 * 4160, 768, 3072),
    (B16 * 4160, 768, 3072), (4160, 1024, 4096), (16448, 768, 3072)])
def test_mlp_fused_matches_plain_on_cuda(cuda, rows, c, f):
    """K5 (two `wgmma` GEMMs a call) at ragged row counts (the last 128-row
    tile part empty) and every width and batch of the encoders: the output
    against the plain version, each launch against its plain half on its
    own inputs (`mlp_up_plain` on x, `mlp_down_plain` on the kernel's
    hidden) by relative norm, one launch counted per call, a planted
    hidden x 1.01 caught by the up-projection's check."""
    _, randn = _gen(cuda, 2)
    x, res = randn(1, rows, c), randn(1, rows, c)
    wts = (randn(f, c, scale=0.02), randn(f, scale=0.1), randn(c, f, scale=0.02),
           randn(c, scale=0.1))
    ls = randn(c, scale=0.5, shift=1.0)
    before = mf.mlp_fused.launches
    out, hid = mf.mlp_fused(x, *wts, res, ls, return_hidden=True)
    assert mf.mlp_fused.launches == before + 1
    close([out], [mf.mlp_fused_plain(x, *wts, res, ls)])
    up = mf.mlp_up_plain(x, *wts[:2])
    close([hid, out], [up, mf.mlp_down_plain(hid, *wts[2:], res, ls)],
          norm_tol=K5_HALF_TOL)
    _caught([hid], [up], 0, norm_tol=K5_HALF_TOL)
    torch.cuda.synchronize()


def _plain_by_heads(plain, q, k, v, *rest, heads=12):
    """`plain` over groups of `heads` rows of (BH, N, D): bounded memory."""
    parts = [plain(q[i: i + heads], k[i: i + heads], v[i: i + heads],
                   *(t[i: i + heads] if torch.is_tensor(t) else t for t in rest))
             for i in range(0, q.shape[0], heads)]
    return [torch.cat(t) for t in zip(*parts)]


def _cold(q, k):
    """Queries of -0.15 and keys in [5, 5.5 + |k| / 2]: logits of about
    -50 at D = 64 (-25 at D = 32, scaled to -50), every one below -40."""
    q_cold = torch.full_like(q, -0.15 * 64 / q.shape[-1])
    return q_cold, (k.float().abs() * 0.5 + 5.0).to(k.dtype)


def _adversarial(q, k, randn):
    """(label, q, k) of the inputs every flash kernel is held to: as made;
    hot (+-1000-scale q, logits ~ +-8000: every row saturates the +40
    clip); cold (q <= 0 at that scale, k >= 1: every logit below -40, so
    each key below N weighs e^-80 and keys past N none); cool (logits ~
    -50, near the window, where p = exp(min(s - lse, 0)) is small but not
    zero)."""
    q_hot = randn(*q.shape, scale=1000.0)
    return (("normal", q, k), ("hot", q_hot, k),
            ("cold", (-q_hot.float().abs()).to(q.dtype),
             (k.float().abs() + 1.0).to(k.dtype)),
            ("cool", *_cold(q, k)))


# (BH, N, n_valid, D) of K3/K6 and K8: small and ragged, ViT-B at 1024^2
# batch 1, 4 and 16, the tiny checkpoints' D = 32, the teacher's 896 x 1152
# bucket (ViT-L: 4037 tokens) and the 2048^2 length
STATIC = {"d32-192": (8, 192, 185, 32), "d64-192": (8, 192, 185, 64),
          "d32-320": (4, 320, 300, 32), "d64-320": (4, 320, 300, 64),
          "vitb-1024": (12, 4160, 4101, 64), "vitb-1024-b4": (48, 4160, 4101, 64),
          "vitb-1024-b16": (B16 * 12, 4160, 4101, 64),
          "tiny-1024": (12, 4160, 4101, 32), "teacher-896x1152": (16, 4096, 4037, 64),
          "vitb-2048": (12, 16448, 16389, 64), "d32-2048": (12, 16448, 16389, 32)}


@pytest.mark.parametrize("case", list(STATIC))
def test_flash_attention_matches_plain_on_cuda(cuda, case):
    """K3/K6 (the static-bound forward: TMA + `wgmma` at D = 64, `mma.sync`
    at 32) on normal, edge (the largest logit pushed to ~35, near the +40
    end of the window), hot, cold and cool rows: o by max error and
    relative norm, lse in absolute terms, a planted o x 1.01 caught on
    each."""
    bh, n, nv, d = STATIC[case]
    _, randn = _gen(cuda, 3)
    q, k, v = (randn(bh, n, d, scale=s) for s in (0.5 * d**-0.5, 0.5, 1.0))
    smax = float(torch.matmul(q[:4].float(), k[:4].float().transpose(1, 2))
                 [..., :nv].amax())
    cases = _adversarial(q, k, randn) + (("edge", (q.float() * (35.0 / smax))
                                          .to(q.dtype), k),)
    for label, qq, kk in cases:
        got = fa.flash_attention(qq, kk, v, nv)
        ref = _plain_by_heads(fa.flash_attention_plain, qq, kk, v, nv)
        close(got, ref, lse=1, norm_tol=FLASH_NORM_TOL)
        _caught(got, ref, 0, lse=1, norm_tol=FLASH_NORM_TOL)
    torch.cuda.synchronize()


# (BH, N, n_valid, D) of K7: small with n_valid inside the last half-tile,
# at N and inside the first tile; the MMDiT's 1024^2 joint sequence (512 +
# 4096), its concept stream (2 + 4096 padded to 4160), the 832 x 1024
# bucket (512 + 3328), and ViT-L at D = 64
ONLINE = {"d64-320-290": (4, 320, 290, 64), "d64-320-320": (4, 320, 320, 64),
          "d64-320-100": (4, 320, 100, 64), "d128-320-290": (4, 320, 290, 128),
          "d128-320-320": (4, 320, 320, 128), "d128-320-100": (4, 320, 100, 128),
          "mmdit-4608": (24, 4608, 4608, 128), "mmdit-concept": (24, 4160, 4098, 128),
          "mmdit-3840": (24, 3840, 3840, 128), "vitl-1024": (16, 4160, 4101, 64)}


@pytest.mark.parametrize("case", list(ONLINE))
def test_flash_attention_online_matches_plain_on_cuda(cuda, case):
    """K7 (the online-softmax forward) on normal rows and on adversarial
    ones: every query row a_i u and every key c_j u for one unit vector u,
    with c_j rising from -400 to 400 along the keys, so the logits reach
    +-600 and each row's maximum grows tile by tile (a kernel that clipped
    at +-40 is wrong there, one that skipped the rescale overflows); one
    launch counted per call."""
    bh, n, nv, d = ONLINE[case]
    _, randn = _gen(cuda, 7)
    u = torch.nn.functional.normalize(randn(d).float(), dim=0)
    a = torch.linspace(0.5, 1.5, n, device=cuda)[None, :, None]
    c = torch.linspace(-400.0, 400.0, n, device=cuda)[None, :, None]
    adversarial = ((a * u).expand(bh, n, d).to(torch.bfloat16).contiguous(),
                   ((c * u).expand(bh, n, d) + 0.05 * randn(bh, n, d).float())
                   .to(torch.bfloat16))
    v = randn(bh, n, d)
    for q, k in ((randn(bh, n, d, scale=d**-0.5), randn(bh, n, d)), adversarial):
        before = fa.flash_attention_online.launches
        got = fa.flash_attention_online(q, k, v, nv)
        assert fa.flash_attention_online.launches == before + 1
        close(got, fa.flash_attention_online_plain(q, k, v, nv), lse=1)
    torch.cuda.synchronize()


BWD = {**{k: v for k, v in STATIC.items() if k != "vitb-1024-b16"},
       "d128-320-300": (4, 320, 300, 128), "d128-320": (4, 320, 320, 128),
       "mmdit-4608": (24, 4608, 4608, 128), "mmdit-832x1216": (24, 4480, 4464, 128)}


@pytest.mark.parametrize("case", list(BWD))
def test_flash_attention_bwd_matches_plain_on_cuda(cuda, case):
    """K8 (the dkv and dq kernels at D = 64, the single pass at 128,
    `mma.sync` at 32) on the forward's lse (K3's, K7's at D = 128), the
    padded rows' cotangent zero as the tap slice makes it, on normal, hot,
    cold and cool rows (at D = 128, whose forward has no clip, on normal
    rows and one row at 300x), one launch counted a call; dq, dk, dv by max
    error, and on normal rows by relative norm too (FLASH_NORM_TOL at
    D = 64, K8D_CALL_TOL at 128) with a planted dk x 1.01 caught (and dq
    x 1.01 at D = 128). At D = 128 two calls on the same inputs give the
    same dk and dv, and dq within one rounding: its fp32 sum over the key
    blocks runs in another order each call."""
    bh, n, nv, d = BWD[case]
    _, randn = _gen(cuda, 4)
    fwd = fa.flash_attention_online if d == 128 else fa.flash_attention
    scales = (d**-0.5, 1.0, 1.0, 1.0) if d == 128 else (0.5 * d**-0.5, 0.5, 1.0, 1.0)
    q, k, v, g = (randn(bh, n, d, scale=s) for s in scales)
    g[:, nv:] = 0
    tol = {64: FLASH_NORM_TOL, 128: K8D_CALL_TOL}.get(d)
    cases = _adversarial(q, k, randn)
    if d == 128:  # no clip to bound the logits: one row at 300x instead
        q_hot = q.clone()
        q_hot[0, :1] *= 300
        cases = (cases[0], ("hot row", q_hot, k))
    for label, qq, kk in cases:
        o, lse = fwd(qq, kk, v, nv)
        before = fa.flash_attention_bwd.launches
        got = fa.flash_attention_bwd(qq, kk, v, o, lse, g, nv)
        assert fa.flash_attention_bwd.launches == before + 1
        ref = _plain_by_heads(fa.flash_attention_bwd_plain, qq, kk, v, o, lse, g, nv)
        if label != "normal" or tol is None:
            close(got, ref)
            continue
        close(got, ref, norm_tol=tol)
        for which in ((0, 1) if d == 128 else (1,)):
            _caught(got, ref, which, norm_tol=tol)
        if d == 128:
            again = fa.flash_attention_bwd(qq, kk, v, o, lse, g, nv)
            assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
            diff = (again[0].float() - got[0].float()).abs()
            assert float(diff.max()) <= 2.0**-7 * float(got[0].float().abs().max())
            assert float((diff > 0).float().mean()) < 0.01
    torch.cuda.synchronize()


def test_flash_attention_online_autograd_runs_k7_and_k8_on_cuda(cuda):
    """The autograd Function at D = 128: K7 forward and K8 backward, one
    launch each, the output and gradients against the plain versions' on
    the same inputs."""
    _, randn = _gen(cuda, 4)
    q, k, v, g = (randn(4, 320, 128, scale=s) for s in (128**-0.5, 1.0, 1.0, 1.0))
    q[0, :1] *= 300
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k7, k8 = fa.flash_attention_online.launches, fa.flash_attention_bwd.launches
    o = fa.flash_attention_online_autograd(*leaves, 300)
    o.backward(g)
    assert fa.flash_attention_online.launches == k7 + 1
    assert fa.flash_attention_bwd.launches == k8 + 1
    o_ref, lse_ref = fa.flash_attention_online_plain(q, k, v, 300)
    close([o], [o_ref], norm_tol=9e-3)
    close([t.grad for t in leaves],
          fa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, g, 300), norm_tol=9e-3)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_decoder_kernels_match_plain_on_cuda(cuda, layout, monkeypatch):
    """K9a, K9b and K10 against their plain versions in bf16, on NCHW
    memory seen through an NHWC view (the decoder's call) and on NHWC
    memory; shapes with ragged blocks (a partial tile-column block, rows
    not a multiple of the block), batch 2, nonzero biases; one launch
    counted per call, the output in the input's memory order. K9a on both
    routes: fused at K = 128, the two launches at K = 384, in chunks of
    part of an image (a V scratch of 5 tile rows) and of whole images."""
    _, r = _gen(cuda, 4)

    def act(b, h, w, c, scale=1.0):
        if layout == "nchw":
            return r(b, c, h, w, scale=scale).permute(0, 2, 3, 1)
        return r(b, h, w, c, scale=scale)

    x = act(2, 38, 136, 128)
    for k, v_rows in ((128, 5), (384, 5), (384, 2 * 19)):
        monkeypatch.setattr(wg, "V_SCRATCH_BYTES", 16 * v_rows * 68 * 128 * 2)
        plan = wg.conv_plan(2, 38, 136, 128, k, tma=wg.tma_layout(x))
        assert plan["route"] == (wg.FUSED if k == 128 else wg.TWO_LAUNCH)
        w, bias = r(3, 3, 128, k, scale=0.05), r(k, scale=0.1)
        before = wg.winograd_conv.launches
        y = wg.winograd_conv(x, w, bias)
        assert wg.winograd_conv.launches == before + 1
        assert y.permute(0, 3, 1, 2).is_contiguous() == (layout == "nchw")
        close([y], [wg.winograd_conv_plain(x, w, bias)])
    for c in (128, 256):
        x = act(2, 34, 60, c)
        w1, w2 = r(3, 3, c, c, scale=0.03), r(3, 3, c, c, scale=0.03)
        b1, b2 = r(c, scale=0.3), r(c, scale=0.1)
        close([wg.winograd_rcu(x, w1, b1, w2, b2)],
              [wg.winograd_rcu_plain(x, w1, b1, w2, b2)])
    x = act(2, 30, 100, 64, scale=0.5)
    args = (x, r(3, 3, 64, 64, scale=0.05), r(64, scale=0.1),
            r(3, 3, 64, 96, scale=0.05), r(96, scale=0.1), r(96, 3, scale=0.1),
            r(3, scale=0.1))
    before = mt.mask_tail.launches
    got = mt.mask_tail(*args)
    assert mt.mask_tail.launches == before + 1
    close([got], [mt.mask_tail_plain(*args)])
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,s,c,layout", [
    (1, 256, 256, "nchw"), (1, 256, 256, "nhwc"), (2, 128, 256, "nchw"),
    (2, 128, 256, "nhwc"), (1, 512, 256, "nchw")])
def test_winograd_rcu_matches_plain_on_cuda(cuda, b, s, c, layout):
    """K9b (six device launches, one counted) at refinenet1's shape on the
    1024^2 path (1, 256, 256, 256) and the 2048^2 path (1, 512, 512, 256),
    and at batch 2, x in NCHW memory seen through an NHWC view and in NHWC
    memory: the output in x's memory order, by max error and relative
    norm (DEC_CALL_TOL), a planted x 1.01 caught."""
    _, r = _gen(cuda, 6)
    x = r(b, c, s, s).permute(0, 2, 3, 1) if layout == "nchw" else r(b, s, s, c)
    w1, w2 = r(3, 3, c, c, scale=0.03), r(3, 3, c, c, scale=0.03)
    b1, b2 = r(c, scale=0.3), r(c, scale=0.1)
    before = wg.winograd_rcu.launches
    got = wg.winograd_rcu(x, w1, b1, w2, b2)
    assert wg.winograd_rcu.launches == before + 1
    assert got.permute(0, 3, 1, 2).is_contiguous() == (layout == "nchw")
    ref = wg.winograd_rcu_plain(x, w1, b1, w2, b2)
    close([got], [ref], norm_tol=DEC_CALL_TOL)
    _caught([got], [ref], 0, norm_tol=DEC_CALL_TOL)
    torch.cuda.synchronize()


# K9a's shapes on the main paths: the three 3x3 convs the copied rule sends
# to it in a 1024^2 b1 forward, at batch 1 and 16, and one dx conv of the
# training step
@pytest.mark.parametrize("b,s,c,k", [
    (1, 256, 256, 256), (1, 128, 512, 256), (1, 512, 256, 128),
    (B16, 256, 256, 256), (4, 128, 256, 512)],
    ids=["layer1_rn", "layer2_rn", "output_conv1", "layer1_rn-b16",
         "layer2_rn-dx-b4"])
def test_winograd_conv_matches_plain_on_cuda(cuda, b, s, c, k):
    """K9a on NCHW memory seen through an NHWC view (the decoder's call),
    fused where K <= 256, else the transform and GEMM: by max error and
    relative norm (DEC_CALL_TOL), a planted x 1.01 caught."""
    _, r = _gen(cuda, 9)
    x = r(b, c, s, s).permute(0, 2, 3, 1)
    w, bias = r(3, 3, c, k, scale=0.03), r(k, scale=0.1)
    plan = wg.conv_plan(b, s, s, c, k, tma=wg.tma_layout(x))
    assert plan["route"] == (wg.FUSED if k <= 256 else wg.TWO_LAUNCH)
    got, ref = wg.winograd_conv(x, w, bias), wg.winograd_conv_plain(x, w, bias)
    close([got], [ref], norm_tol=DEC_CALL_TOL)
    _caught([got], [ref], 0, norm_tol=DEC_CALL_TOL)
    torch.cuda.synchronize()


def test_winograd_conv_dx_runs_the_kernel_on_cuda(cuda):
    """K9a's autograd on the card: dx through K9a where the rule admits
    the gradient's shape, against the plain version's dx, on the fused
    route (a 128 -> 128 conv, dx 128 -> 128), on the two launches (a 512
    -> 256 conv, whose dx is 256 -> 512) and at the training step's
    layer1_rn (4, 256, 256, 256), by relative norm (DEC_CALL_TOL)."""
    _, r = _gen(cuda, 5)
    x = r(1, 128, 32, 32).permute(0, 2, 3, 1).requires_grad_()
    w, b = r(3, 3, 128, 128, scale=0.05), r(128, scale=0.1)
    assert wg.winograd_available(32, 32, 128, 128) is False
    before = wg.winograd_conv.launches
    y = wg.conv3x3_winograd(x, {"kernel": w, "bias": b})
    torch.autograd.grad(y, x, r(1, 32, 32, 128))
    assert wg.winograd_conv.launches == before + 1  # 32 wide: dx by cuDNN
    for bb, h, w_, c, k in ((2, 16, 128, 128, 128), (2, 16, 128, 512, 256),
                            (4, 256, 256, 256, 256)):
        w, b = r(3, 3, c, k, scale=0.05), r(k, scale=0.1)
        x2 = r(bb, c, h, w_).permute(0, 2, 3, 1).requires_grad_()
        assert wg.winograd_available(h, w_, k, c)
        assert wg.conv_plan(bb, h, w_, k, c)["route"] == (
            wg.TWO_LAUNCH if c > 256 else wg.FUSED)
        before = wg.winograd_conv.launches
        y2 = wg.conv3x3_winograd(x2, {"kernel": w, "bias": b})
        g2 = r(*y2.shape)
        (dx2,) = torch.autograd.grad(y2, x2, g2)
        assert wg.winograd_conv.launches == before + 2  # forward and dx
        ref = wg.winograd_conv_plain(g2, w.flip(0, 1).transpose(2, 3),
                                     torch.zeros(c, device=cuda))
        close([dx2], [ref], norm_tol=DEC_CALL_TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", ["b1-nchw", "b16-nchw", "2048-nchw", "b1-nhwc",
                                    "b1-h-innermost"])
def test_mask_tail_matches_plain_on_cuda(cuda, layout):
    """K10 at the gated paths' shapes and memory orders: 1024^2 at batch 1
    and 16 and 2048^2 on NCHW memory seen through an NHWC view (the
    decoder's), 1024^2 on NHWC memory and on (B, C, W, H) memory seen as
    (B, H, W, C) (H innermost: the element-by-element load); by max error
    and relative norm (K10_NORM_TOL), one launch a call, a planted out x
    1.01 caught."""
    _, r = _gen(cuda, 9)
    ci, cm = 64, 96
    b, s = {"b16-nchw": (B16, 1024), "2048-nchw": (1, 2048)}.get(layout, (1, 1024))
    if layout == "b1-h-innermost":
        x = r(b, ci, s, s, scale=0.5).permute(0, 3, 2, 1)
    else:
        x = r(b, ci, s, s, scale=0.5).permute(0, 2, 3, 1)
        x = x.contiguous() if layout == "b1-nhwc" else x
    args = (x, r(3, 3, ci, ci, scale=0.05), r(ci, scale=0.1),
            r(3, 3, ci, cm, scale=0.05), r(cm, scale=0.1), r(cm, 3, scale=0.1),
            r(3, scale=0.1))
    before = mt.mask_tail.launches
    got = mt.mask_tail(*args)
    assert mt.mask_tail.launches == before + 1
    ref = mt.mask_tail_plain(*args)
    close([got], [ref], norm_tol=K10_NORM_TOL)
    _caught([got], [ref], 0, norm_tol=K10_NORM_TOL)
    torch.cuda.synchronize()
