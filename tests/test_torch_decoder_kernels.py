"""The decoder's gated kernels K9a (Winograd conv), K9b (chained RCU) and
K10 (fused mask tail): each plain version against its JAX Pallas kernel in
interpret mode, in float32 and bf16; K9a's and K9b's gradients against
`jax.grad` through the JAX kernels; the copied eligibility rule against
the JAX package's; and the wrappers' dispatch (CPU tensors: plain version,
no launch counted; anything the CUDA kernels do not take: ValueError
before a launch). The kernels themselves are held against the plain
versions on the card in tests/test_torch_kernels.py (`-m cuda`).

Tolerances. float32: K9a and K9b 5e-6 of max|JAX|, K10 2e-6 absolute —
the JAX tests' own bounds (tests/test_experimental_ops.py); only the fp32
order of the channel sums differs. bf16: max|diff| <= 2^-7 max|JAX| and
under 1% of the outputs differing. A sum whose fp32 order differs can
land a rounding on the other side of a tie, which moves that output (or a
K9b intermediate, and through it an output) by one bf16 step at its own
magnitude; for an output in the binade of the largest, [2^e, 2^(e+1)),
that step is 2^(e-7), up to 2^-7 of the largest (2^-8 holds only when
the largest sits at the top of its binade; K9b's check reads 4.2e-3).
Elsewhere the difference is the fp32 order itself, ~1e-6 absolute.
Gradients: 2e-5 of max|JAX| (the JAX gradient tests' bound)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.ops.experimental import mask_tail as tm
from s3od_torch.ops.experimental import winograd as tw

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _within_one_bf16_step(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    assert diff.max() <= 2.0**-7 * np.abs(ref).max(), _rel(got, ref)
    assert (diff > 0).mean() < 0.01, float((diff > 0).mean())


def _check(kind, got, ref, f32_tol, absolute=False):
    if kind == "float32":
        err = (float(np.abs(np.asarray(got) - ref).max()) if absolute
               else _rel(got, ref))
        assert err <= f32_tol, err
    else:
        _within_one_bf16_step(got, ref)


def _inputs(rng, kind, *shapes_scales):
    """Seeded numpy arrays, rounded to the dtype once, for both sides."""
    jdt, tdt = DTYPES[kind]
    out = []
    for shape, scale in shapes_scales:
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


@pytest.mark.parametrize("kind", list(DTYPES))
def test_winograd_conv_plain_matches_pallas_interpret(kind):
    """K9a at (2, 24, 32, 128 -> 128): batch 2, three row blocks of the
    TPU kernel (th = 4 of 12 tile rows), a nonzero bias."""
    from s3od_tpu.ops.experimental.winograd import conv3x3_winograd

    rng = np.random.default_rng(5)
    (xj, xt), (wj, wt), (bj, bt) = _inputs(
        rng, kind, ((2, 24, 32, 128), 1.0), ((3, 3, 128, 128), 0.05),
        ((128,), 0.1))
    ref = _np(conv3x3_winograd(xj, {"kernel": wj, "bias": bj}, interpret=True))
    got = tw.winograd_conv_plain(xt, wt, bt).float().numpy()
    _check(kind, got, ref, 5e-6)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_winograd_conv_plain_matches_pallas_interpret_at_k128(kind):
    """K9a at output_conv1's widths cut to size, (1, 16, 32, 256 -> 128):
    the K = 128 shape that the fused route serves, C != K, four
    64-channel chunks of x, a nonzero bias."""
    from s3od_tpu.ops.experimental.winograd import conv3x3_winograd

    rng = np.random.default_rng(13)
    (xj, xt), (wj, wt), (bj, bt) = _inputs(
        rng, kind, ((1, 16, 32, 256), 1.0), ((3, 3, 256, 128), 0.03),
        ((128,), 0.1))
    ref = _np(conv3x3_winograd(xj, {"kernel": wj, "bias": bj}, interpret=True))
    got = tw.winograd_conv_plain(xt, wt, bt).float().numpy()
    assert got.shape == (1, 16, 32, 128)
    _check(kind, got, ref, 5e-6)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_winograd_rcu_plain_matches_pallas_interpret(kind):
    """K9b at (2, 24, 32, 128): batch 2, three row blocks (th = 4), biases
    nonzero — so conv1's out-of-image ring must be zero, not relu(b1)."""
    from s3od_tpu.ops.experimental.winograd import rcu_winograd

    rng = np.random.default_rng(9)
    (xj, xt), (w1j, w1t), (b1j, b1t), (w2j, w2t), (b2j, b2t) = _inputs(
        rng, kind, ((2, 24, 32, 128), 1.0), ((3, 3, 128, 128), 0.05),
        ((128,), 0.3), ((3, 3, 128, 128), 0.05), ((128,), 0.1))
    ref = _np(rcu_winograd(xj, {"kernel": w1j, "bias": b1j},
                           {"kernel": w2j, "bias": b2j}, interpret=True))
    got = tw.winograd_rcu_plain(xt, w1t, b1t, w2t, b2t).float().numpy()
    _check(kind, got, ref, 5e-6)


@pytest.mark.parametrize("kind", list(DTYPES))
def test_mask_tail_plain_matches_pallas_interpret(kind):
    """K10 at (2, 24, 40, 64 -> 64 -> 96 -> 3), ViT-B's widths: batch 2,
    three TPU slabs (tr = 8), W not a multiple of the CUDA kernel's 64
    columns, nonzero biases (the zero ring of h1)."""
    from s3od_tpu.ops.experimental.mask_tail import mask_tail

    rng = np.random.default_rng(3)
    args = _inputs(rng, kind, ((2, 24, 40, 64), 0.5), ((3, 3, 64, 64), 0.05),
                   ((64,), 0.1), ((3, 3, 64, 96), 0.05), ((96,), 0.1),
                   ((96, 3), 0.1), ((3,), 0.1))
    ref = _np(mask_tail(*[a for a, _ in args], tr=8, interpret=True))
    got = tm.mask_tail_plain(*[t for _, t in args]).float().numpy()
    assert got.shape == (2, 24, 40, 3)
    _check(kind, got, ref, 2e-6, absolute=True)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_winograd_rcu_launch_halves_compose_to_the_plain_version(layout):
    """K9b's four launches from their plain halves — conv1's transform of
    relu(x), its GEMM with the relu(acc + b1) -> bf16 epilogue into h, then
    conv2's transform of h (zero padding) and its GEMM with the + b2 + x
    epilogue — equal `winograd_rcu_plain` bit for bit, and the JAX chained
    kernel (interpret) within one bf16 step, at (1, 16, 128, 128) in bf16,
    x in NHWC memory and as an NHWC view of NCHW memory."""
    from s3od_tpu.ops.experimental.winograd import rcu_winograd

    rng = np.random.default_rng(12)
    (xj, xt), (w1j, w1t), (b1j, b1t), (w2j, w2t), (b2j, b2t) = _inputs(
        rng, "bfloat16", ((1, 16, 128, 128), 1.0), ((3, 3, 128, 128), 0.05),
        ((128,), 0.3), ((3, 3, 128, 128), 0.05), ((128,), 0.1))
    if layout == "nchw":
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not xt.is_contiguous()
    shape = tuple(xt.shape[:3])
    u1, u2 = tw._u(w1t, torch.bfloat16), tw._u(w2t, torch.bfloat16)
    v1 = tw.winograd_transform_plain(xt, relu=True)
    assert v1.shape == (16, 8 * 64, 128) and v1.dtype == torch.bfloat16
    h = tw.winograd_gemm_plain(v1, u1, shape, b1t)
    assert h.dtype == torch.bfloat16 and float(h.float().min()) >= 0.0
    got = tw.winograd_gemm_plain(tw.winograd_transform_plain(h), u2, shape, b2t,
                                 res=xt)
    ref = tw.winograd_rcu_plain(xt, w1t, b1t, w2t, b2t)
    assert torch.equal(got, ref)
    jax_ref = _np(rcu_winograd(xj, {"kernel": w1j, "bias": b1j},
                               {"kernel": w2j, "bias": b2j}, interpret=True))
    _within_one_bf16_step(got.float().numpy(), jax_ref)


def test_winograd_rcu_kernel_takes_every_shape_the_rule_admits():
    """Every (H, W, C) the copied rule sends to K9b, at batch 1 and 16,
    passes the wrapper's input check (on meta tensors, which need no card),
    and the mirror of its launches fits the card: the transform's grid,
    the GEMM's shared memory, the consumers' six 64 x 64 fp32 tiles in
    their 232 registers beside a 40-register producer."""
    sizes = (16, 32, 64, 112, 128, 256, 512, 1024)
    admitted = 0
    for h in sizes:
        for w in sizes:
            for c in (64, 128, 256, 384, 512, 1024):
                if not tw.rcu_winograd_available(h, w, c):
                    continue
                for b in (1, 16):
                    x = _meta(b, h, w, c)
                    wc, bc = _meta(3, 3, c, c), _meta(c)
                    tw.check_rcu_inputs(x, wc, bc, wc, bc)
                    plan = tw.rcu_plan(b, h, w, c)
                    tiles, rows, planes = plan["transform_grid"]
                    assert tiles * tw.TRANSFORM_TILES >= w // 2 and rows == h // 2
                    assert planes * tw.TRANSFORM_CHANNELS == b * c <= 65535 * 64
                    assert plan["gemm_blocks"] * tw.GEMM_TILES * tw.GEMM_CHANNELS \
                        >= b * (h // 2) * (w // 2) * c
                    assert plan["v_shape"] == (16, b * (h // 2) * (w // 2), c)
                    admitted += 1
    assert admitted >= 8  # the decoder's 1024^2 and 2048^2 RCUs among them
    assert tw.rcu_winograd_available(256, 256, 256)
    assert tw.rcu_plan(1, 256, 256, 256)["smem"] <= tw.MAX_SMEM
    assert tw.rcu_plan(1, 256, 256, 256)["acc_regs"] + 32 <= tw.CONSUMER_REGS
    assert 128 * tw.PRODUCER_REGS + 256 * tw.CONSUMER_REGS <= 65536


# (label, B, H, W, C, K) of every K9a call on the main paths: the 1024^2
# forward at batch 1 and 16, the 2048^2 forward (refinenet1's RCU convs
# unchained there: 512^2, 256 -> 256, the shape of its layer1_rn), and the
# training step's dx convs at batch 4 (layer1_rn's and the RCUs' 256 ->
# 256, layer2_rn's 256 -> 512, output_conv1's 128 -> 256).
K9A_CALLS = [
    ("1024 layer1_rn", 1, 256, 256, 256, 256), ("1024 layer2_rn", 1, 128, 128, 512, 256),
    ("1024 output_conv1", 1, 512, 512, 256, 128), ("1024 b16 layer1_rn", 16, 256, 256, 256, 256),
    ("1024 b16 layer2_rn", 16, 128, 128, 512, 256), ("1024 b16 output_conv1", 16, 512, 512, 256, 128),
    ("2048 layer1_rn", 1, 512, 512, 256, 256), ("2048 layer2_rn", 1, 256, 256, 512, 256),
    ("2048 output_conv1", 1, 1024, 1024, 256, 128), ("dx layer1_rn b4", 4, 256, 256, 256, 256),
    ("dx layer2_rn b4", 4, 128, 128, 256, 512), ("dx output_conv1 b4", 4, 512, 512, 128, 256),
]


@pytest.mark.parametrize("label,b,h,w,c,k", K9A_CALLS)
def test_winograd_conv_plan_fits_the_card(label, b, h, w, c, k):
    """The Python mirror of K9a's launches at each call of the main paths
    (x in NCHW memory, which TMA reads): the route (fused at K <= 256,
    else the two launches), blocks covering every tile and output channel,
    shared memory within a block's, the consumers' accumulators within
    their setmaxnreg share beside the producers', and the scratch: U
    alone on the fused route; on the two launches V in chunks of tile rows
    within V_SCRATCH_BYTES that cover the batch. The same call on strides
    TMA cannot read takes the two launches."""
    ht, wt = h // 2, w // 2
    assert tw.winograd_available(h, w, c, k)
    u_bytes = 16 * c * k * 2
    for tma in (True, False):
        plan = tw.conv_plan(b, h, w, c, k, tma=tma)
        fused = tma and k <= 2 * tw.GEMM_CHANNELS
        assert plan["route"] == (tw.FUSED if fused else tw.TWO_LAUNCH)
        assert plan["smem"] <= tw.MAX_SMEM
        if fused:
            gx, gy, gz = plan["grid"]
            assert gx * tw.FUSED_TILE_COLS >= wt > (gx - 1) * tw.FUSED_TILE_COLS
            assert gy * tw.FUSED_TILE_ROWS >= ht and gy <= tw.GRID_YZ
            assert gz * tw.GEMM_CHANNELS == b * k and gz <= tw.GRID_YZ
            assert plan["scratch_bytes"] == u_bytes
            assert plan["acc_regs"] + 32 <= tw.FUSED_CONSUMER_REGS
            assert (128 * tw.FUSED_PRODUCERS * tw.FUSED_PRODUCER_REGS
                    + 256 * tw.FUSED_CONSUMER_REGS <= 65536)
        else:
            rows = plan["chunk_rows"]
            assert rows < ht or rows % ht == 0
            assert plan["chunks"] * rows >= b * ht > (plan["chunks"] - 1) * rows
            assert plan["v_shape"] == (16, rows * wt, c)
            v_bytes = 16 * rows * wt * c * 2
            assert v_bytes <= tw.V_SCRATCH_BYTES and plan["scratch_bytes"] == v_bytes + u_bytes
            tiles, rows_y, planes = plan["transform_grid"]
            assert tiles * tw.TRANSFORM_TILES >= wt and rows_y == min(rows, ht)
            assert planes * tw.TRANSFORM_CHANNELS == -(-rows // rows_y) * c <= tw.GRID_YZ * 64
            assert plan["gemm_blocks"] * tw.GEMM_TILES * tw.GEMM_CHANNELS >= rows * wt * k
            assert plan["acc_regs"] + 32 <= tw.CONSUMER_REGS
    if label.startswith("1024 b16") or label == "2048 layer1_rn":
        # V of the whole call would take 256 MiB to 2 GiB: the fused route
        # needs none, and the two launches bound it
        assert 16 * b * ht * wt * c * 2 >= tw.V_SCRATCH_BYTES


def test_winograd_conv_kernel_takes_every_shape_the_rule_admits():
    """Every (H, W, C, K) the copied rule sends to K9a, at batch 1 and 16,
    passes the wrapper's input check (on meta tensors, which need no card)
    in NHWC memory and as an NHWC view of NCHW memory."""
    sizes = (16, 32, 64, 112, 128, 256, 512, 1024)
    admitted = 0
    for h in sizes:
        for w in sizes:
            for c, k in ((128, 128), (256, 128), (256, 256), (512, 256), (256, 512)):
                if not tw.winograd_available(h, w, c, k):
                    continue
                for b in (1, 16):
                    wc, bc = _meta(3, 3, c, k), _meta(k)
                    for x in (_meta(b, h, w, c), _meta(b, c, h, w).permute(0, 2, 3, 1)):
                        plan = tw.check_conv_inputs(x, wc, bc)
                        assert plan["route"] == tw.conv_route(k, tw.tma_layout(x))
                    admitted += 1
    assert admitted >= 12


def _relaxed(h, w, c, *a, **kw):
    """The JAX decoder test's relaxation (`test_experimental_ops.py:251-259`):
    the W >= 128 floor is a TPU speed heuristic; drop it at small shapes."""
    return h % 2 == 0 and w % 16 == 0 and c % 128 == 0 and w >= 32


def _relax(monkeypatch):
    import s3od_tpu.ops.experimental.winograd as jw

    conv = lambda h, w, c, k, *a, **kw: _relaxed(h, w, c) and k % 128 == 0
    for mod in (jw, tw):
        monkeypatch.setattr(mod, "winograd_available", conv)
        monkeypatch.setattr(mod, "rcu_winograd_available", _relaxed)


def _grads_close(got, ref):
    for g, r in zip(got, ref):
        assert _rel(g.detach().numpy(), r) < 2e-5, _rel(g.detach().numpy(), r)


def test_winograd_conv_gradients_match_jax(monkeypatch):
    """K9a's autograd: dx through K9a itself with the flipped, transposed
    weights (the rule admits the gradient's shape here), dw and db from
    the conv reference's vjp — against `jax.grad` through the gated JAX
    `conv2d` (interpret), float32, (1, 12, 32, 128 -> 128)."""
    import s3od_tpu.ops.conv as jconv

    _relax(monkeypatch)
    monkeypatch.setattr(jconv, "_WINOGRAD_INTERPRET", True)
    rng = np.random.default_rng(7)
    (xj, xt), (wj, wt), (bj, bt) = _inputs(
        rng, "float32", ((1, 12, 32, 128), 1.0), ((3, 3, 128, 128), 0.05),
        ((128,), 0.1))
    ref = jax.grad(lambda x, w, b: jnp.sum(jnp.tanh(jconv.conv2d(
        x, {"kernel": w, "bias": b}, padding=1))), argnums=(0, 1, 2))(xj, wj, bj)
    calls = []
    plain = tw.winograd_conv_plain
    monkeypatch.setattr(tw, "winograd_conv_plain",
                        lambda *a: calls.append(1) or plain(*a))
    x, w, b = (t.clone().requires_grad_() for t in (xt, wt, bt))
    torch.tanh(tw.conv3x3_winograd(x, {"kernel": w, "bias": b})).sum().backward()
    assert len(calls) == 2  # the forward and dx
    _grads_close((x.grad, w.grad, b.grad), [np.asarray(r) for r in ref])


def test_winograd_rcu_gradients_match_jax():
    """K9b's autograd (the vjp of the two-conv reference) against
    `jax.grad` through the JAX chained kernel (interpret), float32."""
    from s3od_tpu.ops.experimental.winograd import rcu_winograd

    rng = np.random.default_rng(10)
    args = _inputs(rng, "float32", ((1, 12, 32, 128), 1.0),
                   ((3, 3, 128, 128), 0.05), ((128,), 0.1),
                   ((3, 3, 128, 128), 0.05), ((128,), 0.1))

    def f(x, w1, b1, w2, b2):
        return jnp.sum(jnp.tanh(rcu_winograd(
            x, {"kernel": w1, "bias": b1}, {"kernel": w2, "bias": b2},
            interpret=True)))

    ref = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*[a for a, _ in args])
    x, w1, b1, w2, b2 = (t.clone().requires_grad_() for _, t in args)
    y = tw.rcu_winograd(x, {"kernel": w1, "bias": b1}, {"kernel": w2, "bias": b2})
    torch.tanh(y).sum().backward()
    _grads_close((x.grad, w1.grad, b1.grad, w2.grad, b2.grad),
                 [np.asarray(r) for r in ref])


def test_eligibility_rules_are_the_jax_packages():
    """Same answer as the JAX rule on every shape of a grid that spans the
    decoder's (ViT-B and ViT-L, 1024^2 and 2048^2, batch-independent) and
    both sides of every condition, for bf16 and float32."""
    import s3od_tpu.ops.experimental.winograd as jw

    sizes = (14, 16, 30, 32, 64, 112, 128, 256, 512, 1024)
    chans = (64, 128, 256, 384, 512, 1024)
    n = 0
    for jdt, tdt in DTYPES.values():
        for h in sizes:
            for w in sizes:
                for c in chans:
                    assert (tw.rcu_winograd_available(h, w, c, tdt)
                            == jw.rcu_winograd_available(h, w, c, jdt)), (h, w, c)
                    for k in chans:
                        n += tw.winograd_available(h, w, c, k, tdt)
                        assert (tw.winograd_available(h, w, c, k, tdt)
                                == jw.winograd_available(h, w, c, k, jdt)), (h, w, c, k)
    assert n > 0
    assert not tw.rcu_winograd_available(512, 512, 256)  # 2048^2 refinenet1
    assert tw.rcu_winograd_available(256, 256, 256)


def test_transform_weights_matches_jax():
    import s3od_tpu.ops.experimental.winograd as jw

    w = np.random.default_rng(1).standard_normal((3, 3, 16, 32)).astype(np.float32)
    ref = np.asarray(jw.transform_weights(jnp.asarray(w)))
    got = tw.transform_weights(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    before = (tw.winograd_conv.launches, tw.winograd_rcu.launches,
              tm.mask_tail.launches)
    x, w, b = t(1, 4, 6, 16), t(3, 3, 16, 64) * 0.1, t(64)
    assert torch.equal(tw.winograd_conv(x, w, b), tw.winograd_conv_plain(x, w, b))
    w1, w2, bc = t(3, 3, 16, 16) * 0.1, t(3, 3, 16, 16) * 0.1, t(16)
    assert torch.equal(tw.winograd_rcu(x, w1, bc, w2, bc),
                       tw.winograd_rcu_plain(x, w1, bc, w2, bc))
    args = (t(1, 5, 7, 16), w1, bc, t(3, 3, 16, 24) * 0.1, t(24), t(24, 3), t(3))
    assert torch.equal(tm.mask_tail(*args), tm.mask_tail_plain(*args))
    assert (tw.winograd_conv.launches, tw.winograd_rcu.launches,
            tm.mask_tail.launches) == before


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", [
    "conv_dtype", "conv_channels", "conv_outputs", "conv_odd", "conv_bias",
    "rcu_width", "rcu_narrow", "rcu_shape", "tail_widths", "tail_outputs", "tail_dtype",
])
def test_kernel_wrappers_raise_on_unsupported_device_inputs(case):
    """Non-CPU tensors go to the kernels, which take only what they were
    written for; anything else raises before a launch (on 'meta' tensors,
    which need no card)."""
    v = lambda n: _meta(n)
    calls = {
        "conv_dtype": lambda: tw.winograd_conv(
            _meta(1, 4, 4, 16, dtype=torch.float32), _meta(3, 3, 16, 64), v(64)),
        "conv_channels": lambda: tw.winograd_conv(
            _meta(1, 4, 4, 24), _meta(3, 3, 24, 64), v(64)),
        "conv_outputs": lambda: tw.winograd_conv(
            _meta(1, 4, 4, 16), _meta(3, 3, 16, 96), v(96)),
        "conv_odd": lambda: tw.winograd_conv(
            _meta(1, 5, 4, 16), _meta(3, 3, 16, 64), v(64)),
        "conv_bias": lambda: tw.winograd_conv(
            _meta(1, 4, 4, 16), _meta(3, 3, 16, 64), v(32)),
        "rcu_width": lambda: tw.winograd_rcu(
            _meta(1, 4, 4, 320), _meta(3, 3, 320, 320), v(320),
            _meta(3, 3, 320, 320), v(320)),
        "rcu_narrow": lambda: tw.winograd_rcu(
            _meta(1, 4, 4, 64), _meta(3, 3, 64, 64), v(64),
            _meta(3, 3, 64, 64), v(64)),
        "rcu_shape": lambda: tw.winograd_rcu(
            _meta(1, 4, 4, 64), _meta(3, 3, 64, 128), v(64),
            _meta(3, 3, 64, 64), v(64)),
        "tail_widths": lambda: tm.mask_tail(
            _meta(1, 8, 8, 32), _meta(3, 3, 32, 32), v(32),
            _meta(3, 3, 32, 48), v(48), _meta(48, 3), v(3)),
        "tail_outputs": lambda: tm.mask_tail(
            _meta(1, 8, 8, 64), _meta(3, 3, 64, 64), v(64),
            _meta(3, 3, 64, 96), v(96), _meta(96, 5), v(5)),
        "tail_dtype": lambda: tm.mask_tail(
            _meta(1, 8, 8, 64, dtype=torch.float32), _meta(3, 3, 64, 64), v(64),
            _meta(3, 3, 64, 96), v(96), _meta(96, 3), v(3)),
    }
    with pytest.raises(ValueError):
        calls[case]()
