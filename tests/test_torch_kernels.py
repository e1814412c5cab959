"""s3od_torch kernels K1-K6: each plain PyTorch version against its JAX
Pallas kernel in interpret mode (float32, CPU; K5 also in bf16), the
wrappers' dispatch and shape gates (K8's plain version against the JAX
backward: tests/test_torch_training.py; K9a, K9b and K10's against the
Pallas kernels: tests/test_torch_decoder_kernels.py). On the card each
kernel is held to its plain version by tests/test_torch_kernels_cuda.py.

Tolerances (float32): the same math in the same order up to the
summation order of the products and reductions, so 1e-5 (2e-5 for the
attention, whose rows sum up to 384 exponentials, and for K5, the JAX
test's own tolerance, `tests/test_ops.py:699-730`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.ops import attn_epilogue as ae
from s3od_torch.ops import flash_attention as fa
from s3od_torch.ops import attention as xa
from s3od_torch.ops import layernorm as ln
from s3od_torch.ops import mlp_fused as mf
from s3od_torch.ops import qkv_project as qp


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


# ----------------------------------------------------------------------------
# K1 LayerNorm
# ----------------------------------------------------------------------------


def test_layer_norm_plain_matches_pallas_interpret():
    from s3od_tpu.ops.layernorm import _pallas_forward, layer_norm

    rng = np.random.default_rng(0)
    b, n, c = 2, 128, 256
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ref = layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), 1e-5,
                     impl="pallas", interpret=True)
    _, mean_ref, rstd_ref = _pallas_forward(
        jnp.asarray(x.reshape(-1, c)), jnp.asarray(w), jnp.asarray(bias),
        1e-5, 128, interpret=True)
    y, mean, rstd = ln.layer_norm(_t(x), _t(w), _t(bias), 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(mean.reshape(-1, 1).numpy(),
                               np.asarray(mean_ref), atol=1e-5)
    np.testing.assert_allclose(rstd.reshape(-1, 1).numpy(),
                               np.asarray(rstd_ref), rtol=1e-5)


def test_layer_norm_exact_matches_xla_formula():
    from s3od_tpu.ops.layernorm import _xla_layer_norm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 40, 64)).astype(np.float32) * 3 - 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = _xla_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = ln.layer_norm_exact(_t(x), _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ----------------------------------------------------------------------------
# K2 QKV projection + RoPE
# ----------------------------------------------------------------------------


def _rope_tables(rng, n, d, n_prefix=5):
    theta = rng.uniform(0.1, 2.0, (n - n_prefix, d // 2))
    cos = np.concatenate([np.ones((n_prefix, d // 2)), np.cos(theta)])
    sin = np.concatenate([np.zeros((n_prefix, d // 2)), np.sin(theta)])
    return (np.concatenate([cos, cos], 1).astype(np.float32),
            np.concatenate([sin, sin], 1).astype(np.float32))


@pytest.mark.parametrize("d", [32, 64])
def test_qkv_project_rope_plain_matches_pallas_interpret(d):
    from s3od_tpu.ops.qkv_project import qkv_project_rope

    rng = np.random.default_rng(7)
    b, n, h = 2, 128, 4
    c = h * d
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
    kernel = rng.standard_normal((c, 3 * c)).astype(np.float32) * 0.05
    bias = rng.standard_normal(3 * c).astype(np.float32) * 0.1
    cos, sin = _rope_tables(rng, n, d)
    refs = qkv_project_rope(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
        jnp.asarray(cos), jnp.asarray(sin), num_heads=h, scale=d**-0.5,
        block_n=64, interpret=True)
    gots = qp.qkv_project_rope(_t(x), _t(kernel.T), _t(bias), _t(cos),
                               _t(sin), h, d**-0.5)
    for got, ref, name in zip(gots, refs, "qkv"):
        assert got.shape == (b, h, n, d)
        assert _rel(got.numpy(), ref) < 1e-5, name


# ----------------------------------------------------------------------------
# K3 static-bound attention forward
# ----------------------------------------------------------------------------


def _flash_case(kind):
    rng = np.random.default_rng(3)
    b, n, h, d = 1, 256, 2, 64
    q = rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, n, h, d)).astype(np.float32)
    n_valid = 200 if kind != "full" else n
    if kind == "edge":  # row maxima pushed to ~35, inside the +-40 window
        s = np.einsum("bnhd,bmhd->bhnm", q, k)[..., :n_valid] * d**-0.5
        q = q * (35.0 / s.max())
    return q, k, v, n_valid


@pytest.mark.parametrize("kind", ["full", "masked", "edge"])
def test_flash_attention_plain_matches_pallas_interpret(kind):
    from s3od_tpu.ops.flash_attention import _flash_forward, flash_attention

    q, k, v, n_valid = _flash_case(kind)
    b, n, h, d = q.shape
    scale = d**-0.5
    ref = flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        block_q=128, block_k=256, n_valid=n_valid, interpret=True,
        static_softmax_bound=True)
    bhnd = lambda t: np.ascontiguousarray(
        t.transpose(0, 2, 1, 3).reshape(b * h, n, d))
    qs = bhnd(q * np.float32(scale))
    _, lse_ref = _flash_forward(
        jnp.asarray(qs), jnp.asarray(bhnd(k)), jnp.asarray(bhnd(v)), 1.0,
        128, 256, n_valid, want_lse=True, interpret=True, static_bound=True)
    o, lse = fa.flash_attention(_t(qs), _t(bhnd(k)), _t(bhnd(v)), n_valid)
    got = o.numpy().reshape(b, h, n, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=2e-5)


@pytest.mark.parametrize("kind", ["hot", "cold"])
def test_flash_attention_plain_adversarial_inputs_stay_finite(kind):
    """Logits ~ +-8000, far outside the window: the two-sided clip keeps
    the denominator >= N e^-80, so output and lse stay finite (as the JAX
    kernel's do)."""
    from s3od_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    q, k, v, n_valid = _flash_case("masked")
    q = rng.standard_normal(q.shape).astype(np.float32) * 1000
    if kind == "cold":
        q, k = -np.abs(q), np.abs(k) + 1.0
    b, n, h, d = q.shape
    ref = flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d**-0.5,
        block_q=128, block_k=256, n_valid=n_valid, interpret=True,
        static_softmax_bound=True)
    assert np.isfinite(np.asarray(ref)).all()
    bhnd = lambda t: _t(t.transpose(0, 2, 1, 3).reshape(b * h, n, d))
    o, lse = fa.flash_attention(bhnd(q * np.float32(d**-0.5)), bhnd(k),
                                bhnd(v), n_valid)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kind", ["full", "masked"])
def test_flash_attention_plain_matches_streaming_kernel(kind, d, monkeypatch):
    """K6: the plain version against the JAX streaming static-bound kernel
    (`_fwd_kernel_stream_static`): 300 tokens padded to 384 = 3 K blocks
    of 128, the shape `tests/test_ops.py:376-405` streams at."""
    from s3od_tpu.ops import flash_attention as jfa

    calls = []
    stream = jfa._fwd_kernel_stream_static
    monkeypatch.setattr(jfa, "_fwd_kernel_stream_static",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    rng = np.random.default_rng(17)
    bh, n = 4, 300
    n_valid = n if kind == "full" else 250
    q = rng.standard_normal((bh, n, d)).astype(np.float32) * 0.5 * d**-0.5
    k = rng.standard_normal((bh, n, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((bh, n, d)).astype(np.float32)
    o_ref, lse_ref = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0, 128, 128,
        n_valid, want_lse=True, interpret=True, static_bound=True)
    assert calls, "the JAX side did not reach the streaming kernel"
    o, lse = fa.flash_attention(_t(q), _t(k), _t(v), n_valid)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref)[:, :n], atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :n, 0],
                               atol=2e-5)


def test_plain_attention_chunking_is_bit_exact():
    """Both plain attentions run in chunks of query rows (the 2048^2 logits
    would not fit the card whole); rows are independent, so any chunking
    gives the unchunked numbers bit for bit."""
    rng = np.random.default_rng(19)
    bh, n, d = 3, 200, 32
    q, k, v = (_t(rng.standard_normal((bh, n, d)) * s) for s in (0.2, 1, 1))
    whole = fa.flash_attention_plain(q, k, v, 190, chunk=n)
    for chunk in (7, 64, 199):
        parts = fa.flash_attention_plain(q, k, v, 190, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(parts, whole))
    assert fa.query_chunk(12, 16448) * 12 * 16448 <= fa.CHUNK_ELEMS
    assert fa.row_chunks(200, 199) == [(0, 100), (100, 200)]
    q4, k4, v4 = (t.reshape(1, bh, n, d).transpose(1, 2) for t in (q, k, v))
    whole = xa.attention(q4, k4, v4, 0.125, 190, chunk=n)
    for chunk in (7, 64, 199):
        assert torch.equal(xa.attention(q4, k4, v4, 0.125, 190, chunk=chunk),
                           whole)


def test_flash_seq_len_is_a_tile_multiple():
    assert fa.flash_seq_len(4101) == 4160  # ViT-B at 1024^2
    assert fa.flash_seq_len(16389) == 16448  # ViT-B at 2048^2 (K6)
    assert fa.flash_seq_len(69) == 128     # tiny model at 128 px
    assert fa.flash_seq_len(128) == 128


# ----------------------------------------------------------------------------
# K4 attention epilogue
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 64])
def test_attn_epilogue_plain_matches_pallas_interpret(d):
    from s3od_tpu.ops.attn_epilogue import attn_epilogue

    rng = np.random.default_rng(11)
    b, h, n = 2, 4, 96
    c = h * d
    a = rng.standard_normal((b * h, n, d)).astype(np.float32) * 0.5
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
    kern = rng.standard_normal((c, c)).astype(np.float32) * 0.05
    bo = rng.standard_normal(c).astype(np.float32) * 0.1
    ls = rng.standard_normal(c).astype(np.float32) * 0.5 + 1.0
    lw = rng.uniform(0.5, 2.0, c).astype(np.float32)
    lb = rng.standard_normal(c).astype(np.float32) * 0.2
    xn_ref, ln_ref = attn_epilogue(
        jnp.asarray(a), {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bo)},
        jnp.asarray(x), jnp.asarray(ls),
        {"weight": jnp.asarray(lw), "bias": jnp.asarray(lb)},
        eps=1e-5, block_n=48, interpret=True)
    xn, hn = ae.attn_epilogue(_t(a), _t(kern.T), _t(bo), _t(x), _t(ls),
                              _t(lw), _t(lb), 1e-5)
    assert _rel(xn.numpy(), xn_ref) < 1e-5
    assert _rel(hn.numpy(), ln_ref) < 1e-5


def test_attn_epilogue_plain_matches_pallas_interpret_at_vit_b_width():
    """ViT-B's width (12 heads of 64, C = 768) at N = 128, batch 1."""
    from s3od_tpu.ops.attn_epilogue import attn_epilogue

    rng = np.random.default_rng(12)
    b, h, n, d = 1, 12, 128, 64
    c = h * d
    a = rng.standard_normal((b * h, n, d)).astype(np.float32) * 0.5
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    kern = rng.standard_normal((c, c)).astype(np.float32) * 0.02
    bo = rng.standard_normal(c).astype(np.float32) * 0.1
    ls = rng.standard_normal(c).astype(np.float32) * 0.5 + 1.0
    lw = rng.uniform(0.5, 2.0, c).astype(np.float32)
    lb = rng.standard_normal(c).astype(np.float32) * 0.2
    xn_ref, ln_ref = attn_epilogue(
        jnp.asarray(a), {"kernel": jnp.asarray(kern), "bias": jnp.asarray(bo)},
        jnp.asarray(x), jnp.asarray(ls),
        {"weight": jnp.asarray(lw), "bias": jnp.asarray(lb)},
        eps=1e-5, block_n=64, interpret=True)
    xn, hn = ae.attn_epilogue(_t(a), _t(kern.T), _t(bo), _t(x), _t(ls),
                              _t(lw), _t(lb), 1e-5)
    assert _rel(xn.numpy(), xn_ref) < 1e-5
    assert _rel(hn.numpy(), ln_ref) < 1e-5


# (C, D) of the repo's configs: ViT-S, ViT-B, ViT-L, the tiny fixtures.
K4_WIDTHS = [(384, 64), (768, 64), (1024, 64), (64, 32)]


@pytest.mark.parametrize("c,d", K4_WIDTHS)
def test_attn_epilogue_kernel_plan_fits_the_card(c, d):
    """The Python mirror of K4's launch at 1024^2 (N = 4160), b1 and b16:
    at D = 64 the cluster wgmma kernel, 64-row tiles split over a pair of
    blocks of C / 2 columns, consumer warpgroups of at most 256 columns
    (a wgmma's widest) in whole 64-column atoms, a ring of at least two
    stages, x staging, vectors, statistics and barriers within a block's
    shared memory, the accumulators within the registers. At D = 32 the
    mma.sync kernel."""
    for b in (1, 16):
        p = ae.plan(b, 4160, c, d)
        assert p["route"] == ae.kernel_route(d)
        assert p["smem"] <= ae.MAX_SMEM
        if d == 32:
            assert p["route"] == "mma.sync"
            continue
        assert p["route"] == "cluster wgmma"
        assert ae.CLUSTER * p["block_cols"] == c
        assert p["consumers"] * p["wn"] == p["block_cols"]
        assert p["wn"] <= 256 and p["wn"] % 64 == 0
        assert 2 <= p["stages"] <= ae.MAX_STAGES
        assert p["row_tiles"] == b * 4160 // ae.ROW_TILE
        assert p["blocks"] == ae.CLUSTER * p["row_tiles"]
        nc = p["consumers"]
        producer, consumer = ae.regs(nc)
        assert p["acc_regs"] + 64 <= consumer
        assert 128 * producer + 128 * nc * consumer <= ae.REGISTERS
    if c == 768:  # b1: 130 blocks on 132 SMs; Wo read a row: 37.5 KB before
        assert ae.plan(1, 4160, c)["blocks"] == 130
        assert ae.plan(1, 4160, c)["wo_l2_bytes_a_row"] * 2 == ae.plan(1, 4160, c, 32)[
            "wo_l2_bytes_a_row"]


def test_attn_epilogue_kernel_route_dispatches_on_head_dim():
    """D = 64 takes the cluster kernel, D = 32 the mma.sync kernel, any
    other D neither; a width the kernel does not take raises before a
    launch (on 'meta' tensors, which need no card)."""
    assert ae.kernel_route(64) == "cluster wgmma"
    assert ae.kernel_route(32) == "mma.sync"
    assert ae.kernel_route(128) == ae.kernel_route(16) == "none"
    assert set(ae.WIDTHS) >= {384, 768, 1024}
    v = _meta(640)
    with pytest.raises(ValueError):  # ViT-style 10 heads of 64: C / 2 = 320
        ae.attn_epilogue(_meta(10, 64, 64), _meta(640, 640), v, _meta(1, 64, 640),
                         v, v, v, 1e-5)


# ----------------------------------------------------------------------------
# K5 fused MLP
# ----------------------------------------------------------------------------


def _mlp_case(scale_x=0.5):
    rng = np.random.default_rng(13)
    b, n, c, f = 2, 96, 128, 512
    h = rng.standard_normal((b, n, c)).astype(np.float32) * scale_x
    x = rng.standard_normal((b, n, c)).astype(np.float32) * scale_x
    wu = rng.standard_normal((c, f)).astype(np.float32) * 0.05
    bu = rng.standard_normal(f).astype(np.float32) * 0.1
    wd = rng.standard_normal((f, c)).astype(np.float32) * 0.05
    bd = rng.standard_normal(c).astype(np.float32) * 0.1
    ls = rng.standard_normal(c).astype(np.float32) * 0.5 + 1.0
    return h, x, wu, bu, wd, bd, ls


def _jax_mlp_fused(h, x, wu, bu, wd, bd, ls, dtype):
    from s3od_tpu.ops.mlp_fused import mlp_fused

    j = lambda a: jnp.asarray(a).astype(dtype)
    mlp = {"up_proj": {"kernel": j(wu), "bias": j(bu)},
           "down_proj": {"kernel": j(wd), "bias": j(bd)}}
    out = mlp_fused(j(h), mlp, j(x), j(ls), block_n=48, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_mlp_fused(h, x, wu, bu, wd, bd, ls, dtype):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return mf.mlp_fused(t(h), t(wu.T), t(bu), t(wd.T), t(bd), t(x), t(ls))


def test_mlp_fused_plain_matches_pallas_interpret():
    case = _mlp_case()
    ref = _jax_mlp_fused(*case, jnp.float32)
    got = _port_mlp_fused(*case, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_mlp_fused_plain_bf16_within_one_rounding():
    """bf16 in and out: the port's rounding points are the TPU kernel's
    (GELU on the fp32 accumulator, one rounding of the hidden, fp32
    residual add, one final rounding), so the two agree to the last bit
    but for rare ties of the fp32 sums' order (a tie flips one hidden
    element, which moves its row's outputs by a fraction of a bf16 step
    of the output scale). The unfused bf16 MLP (`x + mlp(h) * ls2`,
    rounding after each op) differs from the JAX kernel in over a third
    of the elements at this shape."""
    case = _mlp_case(scale_x=1.0)
    ref = _jax_mlp_fused(*case, jnp.bfloat16)
    got = _port_mlp_fused(*case, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= 2.0**-8 * np.abs(ref).max()
    assert (got != ref).mean() < 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_plain_halves_compose_to_the_plain_version(dtype):
    """The kernel is two launches: the up-projection + GELU into a hidden
    rounded once to the compute dtype, then the down-projection +
    residual. Their plain versions, composed, are the one-expression form
    of K5's rounding points bit for bit (and `mlp_fused_plain`), and the
    CPU wrapper hands back that hidden when asked."""
    # _mlp_case: the LayerNorm output, the residual, then the weights in
    # (in, out) layout, which nn.Linear stores transposed
    x_ln, res, wu, bu, wd, bd, ls = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        for a in _mlp_case(scale_x=1.0))
    wu, wd = wu.t().contiguous(), wd.t().contiguous()
    hidden = mf.mlp_up_plain(x_ln, wu, bu)
    assert hidden.dtype == dtype
    composed = mf.mlp_down_plain(hidden, wd, bd, res, ls)
    h = torch.matmul(x_ln.float(), wu.float().t()) + bu.float()
    h = torch.nn.functional.gelu(h, approximate="none").to(dtype)
    t = torch.matmul(h.float(), wd.float().t()) + bd.float()
    whole = (res.float() + t * ls.float()).to(dtype)
    assert torch.equal(composed, whole)
    assert torch.equal(mf.mlp_fused_plain(x_ln, wu, bu, wd, bd, res, ls), whole)
    out, got_hidden = mf.mlp_fused(x_ln, wu, bu, wd, bd, res, ls,
                                   return_hidden=True)
    assert torch.equal(out, whole) and torch.equal(got_hidden, hidden)


# (rows, C, F) that the repo's configs give K5: ViT-B at 1024^2 (4160
# tokens) at batch 1, 4 (training) and 16, at 2048^2 (16448 tokens); the
# ViT-L teacher; ViT-S; the tiny fixtures (C 64, F 128; 1024^2 and a
# ragged 100-row case).
K5_SHAPES = [(4160, 768, 3072), (4 * 4160, 768, 3072), (16 * 4160, 768, 3072),
             (16448, 768, 3072), (4160, 1024, 4096), (4160, 384, 1536),
             (4160, 64, 128), (100, 64, 128)]


@pytest.mark.parametrize("rows,c,f", K5_SHAPES)
def test_mlp_kernel_plan_fits_the_card(rows, c, f):
    """The Python mirror of the kernel's tile plan: each GEMM's tile width
    divides its N, the persistent grid covers every tile with at most one
    block an SM, the ring fits a block's shared memory, the producer's
    and consumers' register budgets fit the SM, and the accumulator
    leaves a consumer room for its addressing and epilogue."""
    plan = mf.plan(rows, c, f)
    for name, n, k in (("up", f, c), ("down", c, f)):
        g = plan[name]
        assert g["bn"] in mf.TILE_WIDTHS and n % g["bn"] == 0, name
        assert g["tiles"] == -(-rows // mf.ROW_TILE) * (n // g["bn"])
        assert 0 < g["grid"] <= min(g["tiles"], mf.SMS)
        assert g["k_blocks"] * mf.K_TILE == k
        assert g["smem"] <= mf.MAX_SMEM
        assert g["acc_regs"] + 64 <= mf.CONSUMER_REGS
    assert (128 * mf.PRODUCER_REGS + 2 * 128 * mf.CONSUMER_REGS
            <= mf.REGISTERS)
    assert mf.THREADS == 3 * 128
    if (rows, c, f) == (4160, 768, 3072):  # ViT-B 1024^2 b1
        assert (plan["up"]["bn"], plan["up"]["tiles"]) == (256, 396)
        assert (plan["down"]["bn"], plan["down"]["tiles"]) == (192, 132)


# (B, N, C) that K2 meets at D = 64: ViT-B at 1024^2 batch 1 and 16 (4101
# tokens padded to 4160), at 2048^2 (16448), and the ViT-L teacher (C =
# 1024, 16 heads).
K2_SHAPES = [(1, 4160, 768), (16, 4160, 768), (1, 16448, 768), (1, 4160, 1024)]


@pytest.mark.parametrize("b,n,c", K2_SHAPES)
def test_qkv_kernel_plan_fits_the_card(b, n, c):
    """The Python mirror of K2's D = 64 launch: tiles of 128 tokens of one
    batch element (the last one past N, whose rows load as zeros and are
    not stored) by whole heads of one of q, k, v (the width divides C),
    every tile in the persistent grid of at most one block an SM, the ring
    and staging tiles within a block's shared memory, the accumulators
    within the consumers' registers beside the producer's."""
    plan = qp.plan(b, n, c)
    assert (plan["row_tiles"] - 1) * qp.ROW_TILE < n <= plan["row_tiles"] * qp.ROW_TILE
    assert plan["bn"] in qp.TILE_WIDTHS and c % plan["bn"] == 0
    assert plan["col_tiles"] * plan["bn"] == 3 * c
    assert plan["heads_per_tile"] * 64 == plan["bn"]
    assert plan["tiles"] == b * plan["row_tiles"] * plan["col_tiles"]
    assert 0 < plan["grid"] <= min(plan["tiles"], qp.SMS)
    assert plan["k_blocks"] * qp.K_TILE == c
    assert plan["smem"] <= qp.MAX_SMEM
    assert plan["acc_regs"] + 96 <= qp.CONSUMER_REGS
    assert 128 * qp.PRODUCER_REGS + 2 * 128 * qp.CONSUMER_REGS <= qp.REGISTERS
    if (b, n, c) == (1, 4160, 768):  # ViT-B 1024^2 b1: 33 x 12 tiles, 3 waves
        assert (plan["row_tiles"], plan["bn"], plan["tiles"]) == (33, 192, 396)


def test_qkv_kernel_route_dispatches_on_head_dim():
    """The C entry point's dispatch: D = 64 takes the wgmma kernel, D = 32
    (the tiny checkpoints) the mma.sync kernel, and any other D
    neither: the wrapper raises before a launch."""
    assert qp.kernel_route(64) == "wgmma"
    assert qp.kernel_route(32) == "mma.sync"
    assert qp.kernel_route(128) == qp.kernel_route(16) == "none"
    with pytest.raises(ValueError):
        qp.qkv_project_rope(_meta(1, 64, 256), _meta(768, 256), _meta(768),
                            _meta(64, 16, dtype=torch.float32),
                            _meta(64, 16, dtype=torch.float32), 16, 0.25)


# (BH, N, D, n_valid) that K7 meets: the MMDiT's joint sequence at 1024^2,
# the concept stream (4098 -> 4160, an odd multiple of 64), the 832 x 1024
# bucket, ViT-L at D = 64, and the CUDA test's 320 = 5 x 64.
K7_SHAPES = [(24, 4608, 128, 4608), (24, 4160, 128, 4098),
             (24, 3840, 128, 3840), (16, 4160, 64, 4101),
             (4, 320, 128, 290), (4, 320, 64, 290)]


@pytest.mark.parametrize("bh,n,d,n_valid", K7_SHAPES)
def test_flash_online_kernel_plan_fits_the_card(bh, n, d, n_valid):
    """The Python mirror of K7's launch: query blocks cover N (the last
    one past N where N is an odd multiple of 64, whose rows the kernel
    does not store), the key tiles cover n_valid and no more, the Q/K/V
    stages fit a block's shared memory, and the consumers' S, O and P
    registers fit their budget beside a 24-register producer."""
    plan = fa.online_plan(bh, n, d, n_valid)
    blocks, heads = plan["grid"]
    assert heads == bh
    assert (blocks - 1) * fa.ONLINE_BLOCK_Q < n <= blocks * fa.ONLINE_BLOCK_Q
    assert ((plan["key_tiles"] - 1) * fa.ONLINE_BLOCK_K < n_valid
            <= plan["key_tiles"] * fa.ONLINE_BLOCK_K)
    assert plan["smem"] <= fa.MAX_SMEM
    assert plan["acc_regs"] + 48 <= fa.ONLINE_CONSUMER_REGS
    assert (128 * fa.ONLINE_PRODUCER_REGS + 2 * 128 * fa.ONLINE_CONSUMER_REGS
            <= 65536)
    assert fa.ONLINE_THREADS == 3 * 128


# (BH, N, D, n_valid) that K3/K6 and K8 meet at D = 64: ViT-B at 1024^2
# batch 1 and 16 (4101 tokens padded to 4160, an odd multiple of 64), at
# 2048^2 (16389 -> 16448), the training step's batch 4, and the CUDA
# tests' 320 = 5 x 64.
STATIC_SHAPES = [(12, 4160, 64, 4101), (192, 4160, 64, 4101),
                 (12, 16448, 64, 16389), (48, 4160, 64, 4101),
                 (4, 320, 64, 300)]


@pytest.mark.parametrize("bh,n,d,n_valid", STATIC_SHAPES)
def test_flash_static_kernel_plan_fits_the_card(bh, n, d, n_valid):
    """The Python mirror of K3/K6's D = 64 launch (K7's kernel with the
    static bound and three consumer warpgroups): 192-row query blocks
    cover N, the key tiles run to N and not to n_valid (keys in
    [n_valid, N) weigh e^-80), the last tile reaching 64 keys past N where
    N is an odd multiple of 64; Q and the K/V stages fit a block's shared
    memory, the consumers' S, O and P registers their 160 beside a
    32-register producer, and the four warpgroups the register file.
    D = 64 takes this kernel and D = 32 the mma.sync one."""
    plan = fa.static_plan(bh, n, d, n_valid)
    blocks, heads = plan["grid"]
    assert heads == bh
    assert (blocks - 1) * fa.STATIC_BLOCK_Q < n <= blocks * fa.STATIC_BLOCK_Q
    tiles = plan["key_tiles"]
    assert (tiles - 1) * fa.ONLINE_BLOCK_K < n <= tiles * fa.ONLINE_BLOCK_K
    assert tiles * fa.ONLINE_BLOCK_K - n == (64 if n % 128 else 0)
    assert tiles >= fa.online_plan(bh, n, d, n_valid)["key_tiles"]
    assert plan["smem"] <= fa.MAX_SMEM
    assert plan["acc_regs"] + 32 <= fa.STATIC_CONSUMER_REGS
    assert (128 * fa.STATIC_PRODUCER_REGS + (fa.STATIC_THREADS - 128)
            * fa.STATIC_CONSUMER_REGS <= 65536)
    assert fa.kernel_route(d) == "wgmma" and fa.kernel_route(32) == "mma.sync"


@pytest.mark.parametrize("bh,n,d,n_valid", STATIC_SHAPES + [
    (24, 4608, 128, 4608), (24, 4480, 128, 4464)])
def test_flash_bwd_kernel_plan_fits_the_card(bh, n, d, n_valid):
    """The Python mirror of K8's wgmma launches. At D = 64 (the ViT
    training shapes) two kernels: each one's blocks (128 keys in dkv; 192
    query rows in dq) cover N, the last one reaching past N, whose rows are
    not stored; the dkv kernel walks every 64-row query tile, none crossing
    N; the dq kernel the 64-key tiles up to n_valid; each kernel's resident
    tiles and 4-stage ring fit a block's shared memory, and the consumers'
    accumulators (S and dP at 64 x 64, dK, dV and dQ at 64 x d) and bf16
    fragments their registers, every warpgroup within the register file;
    seven products run where the function needs five. At D = 128 (the
    MMDiT's LoRA step at the 1024^2 and 832 x 1216 buckets) the single
    pass: one kernel of 128-key blocks covering N, walking every query
    tile, its resident K and V, ring, dS^T buffers and dQ staging within a
    block's shared memory, dK, dV, the fragments and the dQ half within 240
    registers; five products, and the dQ partials summed into an fp32
    (BH, N, 128) accumulator."""
    plan = fa.bwd_plan(bh, n, d, n_valid)
    kernels = ("fused",) if d == 128 else ("dkv", "dq")
    assert set(plan) == {"products", *kernels} | (
        {"dq_acc_bytes"} if d == 128 else set())
    for kernel in kernels:
        p = plan[kernel]
        blocks, heads = p["grid"]
        assert heads == bh and p["rows"] == 64 * p["warpgroups"]
        assert (blocks - 1) * p["rows"] < n <= blocks * p["rows"]
        assert p["smem"] <= fa.MAX_SMEM
        assert p["acc_regs"] + 48 <= p["regs"]
        assert 128 * p["producer_regs"] + 128 * p["warpgroups"] * p["regs"] <= 65536
    if d == 128:
        p = plan["fused"]
        assert plan["products"] == 5
        assert p["tiles"] * fa.BWD_TILE == n and p["stages"] == fa.BWD_FUSED_STAGES
        assert plan["dq_acc_bytes"] == 4 * bh * n * 128
        assert p["smem"] == 231992 and p["acc_regs"] == 192
    else:
        assert plan["dkv"]["tiles"] * fa.BWD_TILE == n
        tiles = plan["dq"]["tiles"]
        assert (tiles - 1) * fa.BWD_TILE < n_valid <= tiles * fa.BWD_TILE
        assert plan["products"] == 7
    assert fa.kernel_route(d) == "wgmma"


@pytest.mark.parametrize("bh,n,n_valid", [(2, 320, 300), (3, 256, 256)])
def test_flash_bwd_single_pass_decomposition_matches_plain(bh, n, n_valid):
    """The single pass at D = 128 in plain torch: each block of 128 keys
    (the last one ragged where N is an odd multiple of 64) computes dS for
    its keys and its dQ partial dS K over them, in fp32; dq is the fp32
    sum of those partials taken in a shuffled order (the card's blocks
    reduce-add in no fixed order), rounded once; dk and dv each block's
    own sums. Against `flash_attention_bwd_plain` in float32: dq within
    1e-5 of max|dq| (fp32 sums in another order; measured ~1e-7), dk and
    dv likewise."""
    rng = np.random.default_rng(5)
    d = 128
    q, k, v, g = (torch.tensor(rng.standard_normal((bh, n, d)) * s,
                               dtype=torch.float32)
                  for s in (d**-0.5, 1.0, 1.0, 1.0))
    for t in (q, k, v, g):
        t[:, n_valid:] = 0
    o, lse = fa.flash_attention_online_plain(q, k, v, n_valid)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, n_valid)
    delta = (o * g).sum(-1, keepdim=True)
    bias = torch.zeros(n)
    bias[n_valid:] = fa.NEG_INF
    partials, dk, dv = [], torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, n, fa.BWD_BLOCK_KEYS):
        kb, vb = k[:, k0: k0 + 128], v[:, k0: k0 + 128]
        s = q @ kb.transpose(1, 2) + bias[k0: k0 + 128]
        p = torch.exp((s - lse[..., None]).clamp_max(0.0))
        ds = p * (g @ vb.transpose(1, 2) - delta)
        partials.append(ds @ kb)
        dk[:, k0: k0 + 128] = ds.transpose(1, 2) @ q
        dv[:, k0: k0 + 128] = p.transpose(1, 2) @ g
    dq = torch.zeros_like(q)
    for i in rng.permutation(len(partials)):
        dq += partials[i]
    assert len(partials) == -(-n // 128)
    for got, want in zip((dq, dk, dv), ref):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_attention_scale_in_dtype_is_the_device_tensor_product(dtype, d):
    """`multi_head_attention` scales q by a Python float rounded once to
    q's dtype on the host; the product is bit for bit the one with a
    0-d tensor of that dtype (which cost a host-to-device copy per call
    on the card)."""
    gen = torch.Generator().manual_seed(d)
    q = (torch.randn(2, 300, 4, d, generator=gen) * 3).to(dtype)
    scale = d**-0.5
    old = q * torch.tensor(scale, dtype=dtype, device=q.device)
    new = q * xa.scale_in_dtype(scale, dtype)
    assert new.dtype == dtype
    assert torch.equal(new, old)


# ----------------------------------------------------------------------------
# Wrapper dispatch: plain on CPU tensors, shape gates before any launch
# ----------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = (ln.layer_norm.launches, qp.qkv_project_rope.launches,
              fa.flash_attention.launches, ae.attn_epilogue.launches)
    x = torch.randn(1, 64, 64)
    y, _, _ = ln.layer_norm(x, torch.ones(64), torch.zeros(64), 1e-5)
    y_plain, _, _ = ln.layer_norm_plain(x, torch.ones(64), torch.zeros(64), 1e-5)
    assert torch.equal(y, y_plain)
    q = torch.randn(2, 64, 32)
    o, _ = fa.flash_attention(q, q, q, 64)
    assert torch.equal(o, fa.flash_attention_plain(q, q, q, 64)[0])
    w, vec = torch.randn(128, 64), torch.randn(128)
    args = (x, w, vec, w.t().contiguous(), torch.randn(64), x,
            torch.randn(64))
    assert torch.equal(mf.mlp_fused(*args), mf.mlp_fused_plain(*args))
    after = (ln.layer_norm.launches, qp.qkv_project_rope.launches,
             fa.flash_attention.launches, ae.attn_epilogue.launches)
    assert after == before
    assert mf.mlp_fused.launches == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", [
    "ln_dtype", "ln_width", "qkv_seq", "qkv_head_dim", "qkv_dtype",
    "flash_seq", "flash_head_dim", "flash_n_valid", "epi_width", "epi_shape",
    "mlp_dtype", "mlp_rows", "mlp_width", "mlp_hidden", "mlp_shape",
])
def test_kernel_wrappers_raise_on_unsupported_device_inputs(case):
    """Non-CPU tensors go to the kernels, which take only the shapes and
    types the repo's configs use; anything else raises before a launch
    (checked here on 'meta' tensors, which need no card)."""
    vec = _meta(64)
    calls = {
        "ln_dtype": lambda: ln.layer_norm(_meta(4, 64, dtype=torch.float16),
                                          vec, vec, 1e-5),
        "ln_width": lambda: ln.layer_norm(_meta(4, 96), _meta(96),
                                          _meta(96), 1e-5),
        "qkv_seq": lambda: qp.qkv_project_rope(
            _meta(1, 69, 64), _meta(192, 64), _meta(192),
            _meta(69, 32, dtype=torch.float32),
            _meta(69, 32, dtype=torch.float32), 2, 0.1),
        "qkv_head_dim": lambda: qp.qkv_project_rope(
            _meta(1, 64, 128), _meta(384, 128), _meta(384),
            _meta(64, 128, dtype=torch.float32),
            _meta(64, 128, dtype=torch.float32), 1, 0.1),
        "qkv_dtype": lambda: qp.qkv_project_rope(
            _meta(1, 64, 64, dtype=torch.float32), _meta(192, 64),
            _meta(192), _meta(64, 32, dtype=torch.float32),
            _meta(64, 32, dtype=torch.float32), 2, 0.1),
        "flash_seq": lambda: fa.flash_attention(
            _meta(2, 100, 64), _meta(2, 100, 64), _meta(2, 100, 64), 100),
        "flash_head_dim": lambda: fa.flash_attention(
            _meta(2, 64, 128), _meta(2, 64, 128), _meta(2, 64, 128), 64),
        "flash_n_valid": lambda: fa.flash_attention(
            _meta(2, 64, 64), _meta(2, 64, 64), _meta(2, 64, 64), 65),
        "epi_width": lambda: ae.attn_epilogue(
            _meta(1, 64, 96), _meta(96, 96), _meta(96), _meta(1, 64, 96),
            _meta(96), _meta(96), _meta(96), 1e-5),
        "epi_shape": lambda: ae.attn_epilogue(
            _meta(2, 64, 32), _meta(64, 64), vec, _meta(1, 128, 64),
            vec, vec, vec, 1e-5),
        "mlp_dtype": lambda: mf.mlp_fused(
            _meta(1, 64, 64, dtype=torch.float32), _meta(256, 64),
            _meta(256), _meta(64, 256), vec, _meta(1, 64, 64), vec),
        "mlp_rows": lambda: mf.mlp_fused(
            _meta(1, 0, 64), _meta(256, 64), _meta(256), _meta(64, 256),
            vec, _meta(1, 0, 64), vec),
        "mlp_width": lambda: mf.mlp_fused(
            _meta(1, 64, 96), _meta(256, 96), _meta(256),
            _meta(96, 256), _meta(96), _meta(1, 64, 96), _meta(96)),
        "mlp_hidden": lambda: mf.mlp_fused(
            _meta(1, 64, 64), _meta(240, 64), _meta(240), _meta(64, 240),
            vec, _meta(1, 64, 64), vec),
        "mlp_shape": lambda: mf.mlp_fused(
            _meta(1, 64, 64), _meta(256, 64), _meta(256), _meta(256, 64),
            vec, _meta(1, 64, 64), vec),
    }
    with pytest.raises(ValueError):
        calls[case]()
