"""s3od_torch training against the JAX package on the CPU, on the same
seeded numpy inputs and converted weights:

(a) K8's plain version against `_flash_backward` in interpret mode, both
    JAX routes (fused, and split when the scratch limit is forced to 0);
(b) the autograd wrappers of K1, K2, K4 and K5 against `jax.vjp` of the
    JAX ops in interpret mode;
(c) the tiny encoder's kernel-route gradients against JAX's fused route,
    with per-block remat on and off;
(d) batch-statistics BatchNorm and its running statistics;
(e) the loss presets; (f) the optimizer; (g) one train step;
(h) the entry point end to end, with resume and the export.

Tolerances (float32): the same math in another summation order, so
relative 1e-4 for gradients that sum over sequences and images (1e-5
where one product is summed), and 1e-6 absolute on parameters after
AdamW steps of lr 1e-3 (float32 rounding of the update). bf16: within
one bf16 rounding of the output (2^-8 of its largest magnitude), plus
the roundings of p and ds to bf16 before the products.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.ops import attn_epilogue as ae
from s3od_torch.ops import flash_attention as fa
from s3od_torch.ops import layernorm as ln
from s3od_torch.ops import mlp_fused as mf
from s3od_torch.ops import qkv_project as qp


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


# ----------------------------------------------------------------------------
# (a) K8: the attention backward
# ----------------------------------------------------------------------------


def _bwd_case(d, dtype):
    """bh 2, n 128 (two 64 blocks), n_valid 117; rows 0-3 of the first
    head carry logits far beyond +-40, where the static bound leaves lse
    below the row max and the clamp min(s - lse, 0) acts. o and lse come
    from the plain static-bound forward on the same inputs; g is zero on
    the padded rows, as the encoder's tap slice makes it."""
    rng = np.random.default_rng(23)
    bh, n, n_valid = 2, 128, 117
    q = rng.standard_normal((bh, n, d)).astype(np.float32) * 0.5 * d**-0.5
    q[0, :4] *= 400.0
    k = rng.standard_normal((bh, n, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((bh, n, d)).astype(np.float32)
    g = rng.standard_normal((bh, n, d)).astype(np.float32)
    g[:, n_valid:] = 0.0
    q, k, v, g = (_t(a, dtype) for a in (q, k, v, g))
    o, lse = fa.flash_attention_plain(q, k, v, n_valid)
    s = q.float() @ k.float().transpose(1, 2)
    assert float(s[..., :n_valid].abs().max()) > 40.0
    return q, k, v, o, lse, g, n_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("route", ["fused", "split"])
def test_flash_attention_bwd_plain_matches_pallas_interpret(route, d, dtype,
                                                            monkeypatch):
    from s3od_tpu.ops import flash_attention as jfa

    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    q, k, v, o, lse, g, n_valid = _bwd_case(d, tdt)
    if route == "split":
        monkeypatch.setattr(jfa, "_FUSED_BWD_SCRATCH_LIMIT", 0)
    calls = []
    for name in ("_flash_backward_fused", "_bwd_dq_kernel"):
        real = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    refs = jfa._flash_backward(
        j(q), j(k), j(v), j(o), jnp.asarray(lse.numpy())[..., None], j(g),
        1.0, 64, 64, n_valid, interpret=True)
    want = "_flash_backward_fused" if route == "fused" else "_bwd_dq_kernel"
    assert want in calls and len(set(calls)) == 1
    gots = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, n_valid)
    tol = 1e-4 if dtype == "float32" else 2.0**-7
    for got, ref, name in zip(gots, refs, ("dq", "dk", "dv")):
        assert got.dtype == tdt and torch.isfinite(got).all()
        ref = np.asarray(ref.astype(jnp.float32))
        assert _rel(got.float().numpy(), ref) <= tol, name
        assert not got[:, n_valid:].any() or name == "dq", name


def test_flash_attention_bwd_padding_rows_give_zero_key_gradients():
    """Padded keys get exactly zero dk and dv, and padded query rows with
    a zero cotangent get exactly zero dq: delta is taken over the same
    rows as g, so ds = p (0 - 0) vanishes there."""
    q, k, v, o, lse, g, n_valid = _bwd_case(64, torch.float32)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, n_valid)
    assert not dk[:, n_valid:].any() and not dv[:, n_valid:].any()
    assert not dq[:, n_valid:].any()


def test_flash_attention_autograd_runs_the_backward_on_cpu():
    """The autograd Function's backward is K8's plain version on CPU
    tensors (no launch counted) and equals autograd through the plain
    forward where no logit leaves the window."""
    rng = np.random.default_rng(29)
    bh, n, d, n_valid = 2, 128, 32, 100
    q, k, v = (_t(rng.standard_normal((bh, n, d)) * s).requires_grad_()
               for s in (0.2, 0.5, 1.0))
    g = _t(rng.standard_normal((bh, n, d)))
    before = fa.flash_attention_bwd.launches
    o = fa.flash_attention_autograd(q, k, v, n_valid)
    got = torch.autograd.grad(o, (q, k, v), g)
    o_ref, _ = fa.flash_attention_plain(q, k, v, n_valid)
    ref = torch.autograd.grad(o_ref, (q, k, v), g)
    assert fa.flash_attention_bwd.launches == before
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b.numpy()) < 1e-5


# ----------------------------------------------------------------------------
# (b) K1, K2, K4, K5: autograd wrappers against jax.vjp
# ----------------------------------------------------------------------------


def _vjp_check(jax_fn, jax_args, torch_fn, torch_args, cots):
    """Gradients of both functions at the same inputs against the same
    cotangents (torch_args[i] is jax_args[i], transposed where the
    layouts differ)."""
    out, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in jax_args])
    refs = vjp(tuple(jnp.asarray(c) for c in cots) if isinstance(out, tuple)
               else jnp.asarray(cots[0]))
    leaves = [t.requires_grad_() for t in torch_args]
    outs = torch_fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gots = torch.autograd.grad(outs, leaves, [_t(c) for c in cots])
    return gots, refs


def test_layer_norm_autograd_matches_jax_vjp():
    from s3od_tpu.ops.layernorm import layer_norm

    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gots, refs = _vjp_check(
        lambda x, w, b: layer_norm(x, w, b, 1e-5, impl="pallas",
                                   interpret=True),
        (x, w, b), lambda x, w, b: ln.layer_norm_autograd(x, w, b, 1e-5),
        (_t(x), _t(w), _t(b)), (gy,))
    for got, ref, name in zip(gots, refs, ("dx", "dw", "db")):
        assert _rel(got.numpy(), ref) < 1e-5, name


@pytest.mark.parametrize("d", [32, 64])
def test_qkv_project_rope_autograd_matches_jax_vjp(d):
    """The q pre-scale by D^-0.5 reaches dx, dW and db."""
    from s3od_tpu.ops.qkv_project import qkv_project_rope

    rng = np.random.default_rng(37)
    b, n, h = 2, 64, 2
    c = h * d
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
    kern = rng.standard_normal((c, 3 * c)).astype(np.float32) * 0.05
    bias = rng.standard_normal(3 * c).astype(np.float32) * 0.1
    theta = rng.uniform(0.1, 2.0, (n, d // 2))
    cos = np.concatenate([np.cos(theta)] * 2, 1).astype(np.float32)
    sin = np.concatenate([np.sin(theta)] * 2, 1).astype(np.float32)
    cots = [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(3)]
    jfn = lambda x, kern, bias: tuple(qkv_project_rope(
        x, kern, bias, jnp.asarray(cos), jnp.asarray(sin), num_heads=h,
        scale=d**-0.5, block_n=64, interpret=True))
    tfn = lambda x, w, bias: qp.qkv_project_rope_autograd(
        x, w, bias, _t(cos), _t(sin), h, d**-0.5)
    gots, refs = _vjp_check(jfn, (x, kern, bias), tfn,
                            (_t(x), _t(kern.T), _t(bias)), cots)
    assert _rel(gots[0].numpy(), refs[0]) < 1e-5
    assert _rel(gots[1].numpy().T, refs[1]) < 1e-5
    assert _rel(gots[2].numpy(), refs[2]) < 1e-5


def test_attn_epilogue_autograd_matches_jax_vjp():
    from s3od_tpu.ops.attn_epilogue import attn_epilogue

    rng = np.random.default_rng(41)
    b, h, n, d = 2, 2, 96, 32
    c = h * d
    a = rng.standard_normal((b * h, n, d)).astype(np.float32) * 0.5
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
    kern = rng.standard_normal((c, c)).astype(np.float32) * 0.05
    vecs = [rng.standard_normal(c).astype(np.float32) * s + m
            for s, m in ((0.1, 0), (0.5, 1), (0.5, 1), (0.2, 0))]
    cots = [rng.standard_normal((b, n, c)).astype(np.float32)
            for _ in range(2)]

    def jfn(a, kern, bo, x, ls, lw, lb):
        return tuple(attn_epilogue(a, {"kernel": kern, "bias": bo}, x, ls,
                                   {"weight": lw, "bias": lb}, eps=1e-5,
                                   block_n=48, interpret=True))

    gots, refs = _vjp_check(
        jfn, (a, kern, *vecs[:1], x, *vecs[1:]),
        lambda a, wo, bo, x, ls, lw, lb: ae.attn_epilogue_autograd(
            a, wo, bo, x, ls, lw, lb, 1e-5),
        (_t(a), _t(kern.T), _t(vecs[0]), _t(x), *(_t(v) for v in vecs[1:])),
        cots)
    names = ("da", "dwo", "dbo", "dx", "dls", "dlw", "dlb")
    for got, ref, name in zip(gots, refs, names):
        got = got.numpy().T if name == "dwo" else got.numpy()
        assert _rel(got, ref) < 1e-4, name


def test_mlp_fused_autograd_matches_jax_vjp():
    from s3od_tpu.ops.mlp_fused import mlp_fused

    rng = np.random.default_rng(43)
    b, n, c, f = 2, 64, 64, 256
    h = rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
    x = rng.standard_normal((b, n, c)).astype(np.float32) * 0.5
    wu = rng.standard_normal((c, f)).astype(np.float32) * 0.05
    bu = rng.standard_normal(f).astype(np.float32) * 0.1
    wd = rng.standard_normal((f, c)).astype(np.float32) * 0.05
    bd = rng.standard_normal(c).astype(np.float32) * 0.1
    ls = rng.standard_normal(c).astype(np.float32) * 0.5 + 1.0
    cot = rng.standard_normal((b, n, c)).astype(np.float32)

    def jfn(h, wu, bu, wd, bd, x, ls):
        mlp = {"up_proj": {"kernel": wu, "bias": bu},
               "down_proj": {"kernel": wd, "bias": bd}}
        return mlp_fused(h, mlp, x, ls, block_n=32, interpret=True)

    gots, refs = _vjp_check(
        jfn, (h, wu, bu, wd, bd, x, ls), mf.mlp_fused_autograd,
        (_t(h), _t(wu.T), _t(bu), _t(wd.T), _t(bd), _t(x), _t(ls)), (cot,))
    names = ("dh", "dwu", "dbu", "dwd", "dbd", "dx", "dls")
    for got, ref, name in zip(gots, refs, names):
        got = got.numpy().T if name in ("dwu", "dwd") else got.numpy()
        assert _rel(got, ref) < 1e-4, name


# ----------------------------------------------------------------------------
# Tiny models carried across from JAX params
# ----------------------------------------------------------------------------


def _tiny(num_layers=2, seed=0, pos_embed_rescale=2.0):
    """JAX init + seeded noise (LN, BN and layerscales off their trivial
    values), the fused key-bias segment at zero; the same weights in the
    port's model."""
    import dataclasses

    from s3od_tpu.configs import tiny_test_config
    from s3od_tpu.models.segmentation import init_segmentation_params
    from s3od_torch.convert import state_dict_from_jax
    from s3od_torch.models.segmentation import S3ODSegmentation

    cfg = tiny_test_config(num_layers=num_layers)
    cfg = dataclasses.replace(
        cfg, tap_layers=tuple(min(t, num_layers) for t in (1, 2, 3, 4)),
        encoder=dataclasses.replace(cfg.encoder,
                                    pos_embed_rescale=pos_embed_rescale))
    params, state = init_segmentation_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    noise = lambda a: (np.asarray(a, np.float32)
                       + rng.standard_normal(np.shape(a)).astype(np.float32)
                       * 0.05)
    params = jax.tree_util.tree_map(noise, params)
    state = jax.tree_util.tree_map(lambda a: np.abs(noise(a)) + 0.5, state)
    c = cfg.encoder.hidden_size
    for blk in params["encoder"]["blocks"]:
        blk["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return cfg, params, state, model


def _port_layout(cfg, params, state):
    """A JAX pytree (params or gradients) -> {port parameter name: numpy}.
    The fused qkv tensors keep all three segments (the reference layout
    has no key bias, so they bypass it)."""
    from s3od_torch.convert import state_dict_from_jax
    from s3od_torch.models.segmentation import S3ODSegmentation

    c = cfg.encoder.hidden_size
    blocks = params["encoder"]["blocks"]
    kbias = [np.array(b["attention"]["qkv"]["bias"]) for b in blocks]
    clean = jax.tree_util.tree_map(np.array, params)
    for b in clean["encoder"]["blocks"]:
        b["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    m = S3ODSegmentation(cfg)
    m.load_state_dict(state_dict_from_jax(clean, state), strict=True)
    out = {k: v.detach().numpy().copy() for k, v in m.named_parameters()}
    for i, kb in enumerate(kbias):
        out[f"encoder.layer.{i}.attention.qkv.bias"] = kb
    return out


# ----------------------------------------------------------------------------
# (c) encoder gradients through the kernel route
# ----------------------------------------------------------------------------


def test_encoder_kernel_route_gradients_match_jax(monkeypatch):
    """Gradients of a tap loss through K1 -> K2 -> K3 -> K4 -> K5 (plain
    versions, float32, with the K8 backward) against JAX's fused route in
    interpret mode (K8's Pallas backward included), with per-block remat
    on both sides; the port's remat on and off agree."""
    from s3od_tpu.models import dinov3
    from s3od_tpu.models.dinov3 import encoder_forward

    cfg, params, state, model = _tiny()
    monkeypatch.setattr(dinov3, "_QKV_FUSED_INTERPRET", True)
    monkeypatch.setattr("s3od_tpu.ops.attention.resolve_attn_impl",
                        lambda n, dtype, impl="auto": "flash")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    taps = cfg.tap_layers
    w = [rng.standard_normal((2, 16, cfg.encoder.hidden_size))
         .astype(np.float32) for _ in taps]

    def jloss(enc):
        outs = encoder_forward(enc, jnp.asarray(x), cfg.encoder, taps,
                               attn_impl="flash", remat=True)
        return sum(jnp.sum(jnp.sin(o) * wi) for o, wi in zip(outs, w))

    jgrads = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray,
                                                    params["encoder"]))
    zero_head = jax.tree_util.tree_map(np.zeros_like, params["head"])
    ref = _port_layout(cfg, {"encoder": jgrads, "head": zero_head}, state)

    grads = {}
    for remat in (True, False):
        model.zero_grad()
        outs = model.encoder(torch.from_numpy(x), taps, "kernel",
                             remat=remat)
        sum((torch.sin(o) * _t(wi)).sum() for o, wi in zip(outs, w)).backward()
        grads[remat] = {k: p.grad.clone() for k, p in
                        model.encoder.named_parameters() if p.grad is not None}
    assert grads[True].keys() == grads[False].keys()
    for k in grads[True]:
        assert torch.allclose(grads[True][k], grads[False][k], rtol=0,
                              atol=1e-6 * float(grads[False][k].abs().max())), k
    checked = 0
    for k, g in grads[True].items():
        assert _rel(g.numpy(), ref["encoder." + k]) < 1e-4, k
        checked += 1
    assert checked >= 2 * 10


def test_rope_tables_with_coordinate_scale_match_jax():
    from s3od_tpu.models.dinov3 import rope_cos_sin
    from s3od_torch.models import dinov3 as tdinov3

    scale = np.float32(1.37)
    cos_j, sin_j = rope_cos_sin(8, 6, 32, 100.0, jnp.asarray(scale))
    cos, sin = tdinov3.rope_cos_sin(8, 6, 32, 100.0, torch.tensor(scale))
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), atol=1e-6)
    # scaled tables are built anew, never served from the unscaled cache
    a = tdinov3.rope_tables(8, 6, 32, 100.0, 5, 64, "cpu")
    b = tdinov3.rope_tables(8, 6, 32, 100.0, 5, 64, "cpu", torch.tensor(scale))
    c = tdinov3.rope_tables(8, 6, 32, 100.0, 5, 64, "cpu")
    assert a[0] is c[0] and not torch.equal(a[1], b[1])
    gen = torch.Generator().manual_seed(0)
    s = [float(tdinov3.sample_rope_coord_scale(gen, 2.0)) for _ in range(200)]
    assert 0.5 <= min(s) and max(s) <= 2.0 and min(s) < 0.7 and max(s) > 1.4


def test_training_forward_after_a_serving_forward_at_the_same_shape():
    """The cached RoPE tables of a forward under inference mode (serving)
    can be saved for backward by a later training forward."""
    from s3od_torch.models import dinov3 as tdinov3

    cfg, _, _, model = _tiny()
    x = torch.zeros(1, 64, 64, 3)
    tdinov3._full_tables.cache_clear()
    with torch.inference_mode():
        model(x)
    model(x, training=True)["pred_masks"].sum().backward()
    assert model.encoder.layer[0].attention.qkv.weight.grad is not None


def test_remat_policies_other_than_none_raise():
    """Names other than none / flash / dots_flash raise ValueError, as
    JAX's `_remat_policy` (the three are tested in test_torch_train_aug)."""
    cfg, _, _, model = _tiny()
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="unknown remat policy"):
        model.encoder(x, cfg.tap_layers, "exact", remat=True,
                      remat_policy="dots")


# ----------------------------------------------------------------------------
# (d) BatchNorm in training mode
# ----------------------------------------------------------------------------


def test_batch_norm_training_matches_jax_and_updates_running_stats():
    from s3od_tpu.ops.conv import batch_norm as jbn
    from s3od_torch.models.dpt import batch_norm

    rng = np.random.default_rng(47)
    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32) * 2 + 1
    bn = torch.nn.BatchNorm2d(8)
    with torch.no_grad():
        bn.weight.copy_(_t(rng.uniform(0.5, 2, 8)))
        bn.bias.copy_(_t(rng.standard_normal(8)))
        bn.running_mean.copy_(_t(rng.standard_normal(8)))
        bn.running_var.copy_(_t(rng.uniform(0.5, 2, 8)))
    p = {"weight": bn.weight.detach().numpy().copy(),
         "bias": bn.bias.detach().numpy().copy()}
    s = {"mean": bn.running_mean.numpy().copy(),
         "var": bn.running_var.numpy().copy()}
    y_ref, new = jbn(jnp.asarray(x.transpose(0, 2, 3, 1)), p, s, training=True)
    y = batch_norm(bn, _t(x), training=True)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]),
                               atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    y_eval, _ = jbn(jnp.asarray(x.transpose(0, 2, 3, 1)), p, new)
    np.testing.assert_allclose(
        batch_norm(bn, _t(x), training=False).detach().numpy()
        .transpose(0, 2, 3, 1), np.asarray(y_eval), atol=1e-5)


def test_training_forward_matches_jax_outputs_and_bn_state():
    """The whole model in training mode (batch-statistics BN, per-block
    remat): outputs in fp32 and the new BN state equal JAX's; one forward
    moves every running statistic exactly once."""
    from s3od_tpu.models.segmentation import segmentation_forward
    from s3od_torch.convert import convert_state_dict

    cfg, params, state, model = _tiny()
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref, new_bn = segmentation_forward(params, state, jnp.asarray(x), cfg,
                                       training=True)
    out = model(torch.from_numpy(x), training=True)
    assert out["pred_masks"].dtype == torch.float32
    for k in ("pred_masks", "pred_iou"):
        assert _rel(out[k].detach().numpy(), ref[k]) < 1e-4, k
    _, got_bn, _ = convert_state_dict(model.state_dict(), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(got_bn),
                    jax.tree_util.tree_leaves(new_bn)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# (e) the loss
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("preset", ["focal_iou", "bce_iou_ssim",
                                    "focal_iou_rank"])
def test_loss_module_matches_jax(preset, epoch):
    from s3od_tpu.training.loss import LOSS_PRESETS as JP
    from s3od_tpu.training.loss import LossModule as JLoss
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule

    rng = np.random.default_rng(53)
    logits = rng.standard_normal((2, 3, 32, 32)).astype(np.float32) * 2
    iou = rng.standard_normal((2, 3)).astype(np.float32)
    masks = (rng.random((2, 32, 32)) > 0.6).astype(np.float32)

    def jfn(logits, iou):
        return JLoss(JP[preset])({"pred_masks": logits, "pred_iou": iou},
                                 {"masks": jnp.asarray(masks)},
                                 jnp.asarray(float(epoch)))

    (ref, ref_parts), vjp = jax.vjp(jfn, jnp.asarray(logits), jnp.asarray(iou))
    d_logits, d_iou = vjp((jnp.ones(()), jax.tree_util.tree_map(
        jnp.zeros_like, ref_parts)))
    lt, it = _t(logits).requires_grad_(), _t(iou).requires_grad_()
    loss, parts = LossModule(LOSS_PRESETS[preset])(
        {"pred_masks": lt, "pred_iou": it}, {"masks": _t(masks)}, epoch)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    assert parts.keys() == ref_parts.keys()
    for k, v in parts.items():
        assert abs(float(v) - float(ref_parts[k])) <= 1e-5 * max(
            1.0, abs(float(ref_parts[k]))), k
    assert _rel(lt.grad.numpy(), d_logits) < 1e-4
    assert _rel(it.grad.numpy(), d_iou) < 1e-4


def test_single_mask_loss_matches_jax():
    """One mask per image takes the plain per-component path (`_single`)."""
    from s3od_tpu.training.loss import LOSS_PRESETS as JP
    from s3od_tpu.training.loss import LossModule as JLoss
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule

    rng = np.random.default_rng(57)
    logits = rng.standard_normal((2, 1, 24, 24)).astype(np.float32)
    masks = (rng.random((2, 24, 24)) > 0.5).astype(np.float32)
    ref, ref_parts = JLoss(JP["bce_iou_ssim"])(
        {"pred_masks": jnp.asarray(logits), "pred_iou": jnp.zeros((2, 1))},
        {"masks": jnp.asarray(masks)}, jnp.asarray(0.0))
    loss, parts = LossModule(LOSS_PRESETS["bce_iou_ssim"])(
        {"pred_masks": _t(logits), "pred_iou": torch.zeros(2, 1)},
        {"masks": _t(masks)}, 0)
    assert parts.keys() == ref_parts.keys()
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))


# ----------------------------------------------------------------------------
# (f) the optimizer
# ----------------------------------------------------------------------------


def test_optimizer_matches_optax_over_five_steps():
    """Two groups (head at 10x), hold -> cosine with a one-epoch warmup
    (2 steps an epoch), per-group clipping at a bound the gradients
    exceed, the key-bias freeze: parameters after 5 steps agree within
    float32 rounding of the AdamW update (1e-6 absolute at lr 1e-3)."""
    import optax

    from s3od_tpu.training.optim import make_optimizer
    from s3od_torch.training.optim import Optimizer

    cfg, params, state, model = _tiny(num_layers=1)
    kw = dict(head_lr_mult=10.0, weight_decay=0.05, steps_per_epoch=2,
              max_epochs=4, hold_epochs=1, eta_min=1e-5, grad_clip=0.5,
              warmup_epochs=1.0)
    tx = make_optimizer(1e-3, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    opt = Optimizer(model, 1e-3, **kw)
    rng = np.random.default_rng(59)
    names = dict(model.named_parameters())
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
            params)
        updates, opt_state = update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port = _port_layout(cfg, grads, state)
        opt.zero_grad()
        for k, p in names.items():
            p.grad = _t(port[k]) if k in port else torch.zeros_like(p)
        opt.step(step)
    ref = _port_layout(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                       state)
    c = cfg.encoder.hidden_size
    for k, p in names.items():
        # the final LayerNorm and the mask token exist for the checkpoint
        # layout only; the JAX pytree has neither
        if k.startswith(("encoder.norm.", "encoder.embeddings.mask_token")):
            continue
        np.testing.assert_allclose(p.detach().numpy(), ref[k], atol=1e-6,
                                   err_msg=k)
    assert not names["encoder.layer.0.attention.qkv.bias"][c: 2 * c].any()
    lrs = opt.lrs(4)
    assert lrs[1] == pytest.approx(10 * lrs[0], rel=0.1)


def test_hold_cosine_schedule_matches_jax():
    from s3od_tpu.training.optim import hold_cosine_schedule as jsched
    from s3od_torch.training.optim import hold_cosine_schedule

    kw = dict(steps_per_epoch=3, max_epochs=10, hold_epochs=2, eta_min=1e-6,
              warmup_epochs=1.5)
    a, b = hold_cosine_schedule(1e-4, **kw), jsched(1e-4, **kw)
    for step in range(0, 40):
        assert a(step) == pytest.approx(float(b(step)), rel=1e-6, abs=1e-12)


# ----------------------------------------------------------------------------
# (g) one training step
# ----------------------------------------------------------------------------


class _SGD:
    """p -= lr * g: the parameters after the step carry the gradients."""

    def __init__(self, model, lr):
        self.params, self.lr = list(model.parameters()), lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, step):
        for p in self.params:
            if p.grad is not None:
                p -= self.lr * p.grad


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """One float32 step of `train_step` against `make_train_step` (test
    transform, no RoPE rescale in the config, SGD lr 1 so that the
    parameters after the step expose the averaged gradients): loss and its
    parts, confusion sums, parameters and BN state; with accum 2 the BN
    state threads through both micro-batches; then the eval step."""
    import optax

    from s3od_tpu.ops.augment import normalize_imagenet
    from s3od_tpu.training.loss import LOSS_PRESETS as JP
    from s3od_tpu.training.loss import LossModule as JLoss
    from s3od_tpu.training.train_step import (
        TrainState,
        make_eval_step,
        make_train_step,
    )
    from s3od_torch.convert import convert_state_dict
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import eval_step, train_step

    cfg, params, state, model = _tiny(pos_embed_rescale=None)
    rng = np.random.default_rng(61)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    masks = (rng.random((4, 64, 64)) > 0.6).astype(np.uint8) * 255

    def pre(_, b):
        x = b["images"].astype(jnp.float32) / 255.0
        return {**b, "images": normalize_imagenet(x),
                "masks": b["masks"].astype(jnp.float32) / 255.0}

    step = make_train_step(cfg, JLoss(JP["focal_iou"]), optax.sgd(1.0),
                           accum_steps=accum, preprocess_fn=pre)
    jstate = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                               state, optax.sgd(1.0))
    new_state, ref = step(jstate, {"images": jnp.asarray(images),
                                   "masks": jnp.asarray(masks)},
                          jnp.asarray(1.0), jax.random.key(0))
    out = train_step(model, _SGD(model, 1.0), LossModule(LOSS_PRESETS["focal_iou"]),
                     {"images": torch.from_numpy(images),
                      "masks": torch.from_numpy(masks)}, 1, 0,
                     generator=torch.Generator(), accum_steps=accum)
    assert out.keys() == ref.keys()
    for k in out:
        assert abs(float(out[k]) - float(ref[k])) <= 1e-5 * max(
            1.0, abs(float(ref[k]))), k
    new_params = _port_layout(
        cfg, jax.tree_util.tree_map(np.asarray, new_state.params), state)
    before = _port_layout(cfg, params, state)
    for k, p in model.named_parameters():
        if k in new_params:
            # p - g rounds to the parameter's ulp: 2e-7 of max|p| on top of
            # the gradients' own 1e-4
            g_ref = before[k] - new_params[k]
            g = before[k] - p.detach().numpy()
            tol = 1e-4 * np.abs(g_ref).max() + 2e-7 * np.abs(before[k]).max()
            assert np.abs(g - g_ref).max() <= tol, k
    _, got_bn, _ = convert_state_dict(model.state_dict(), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(got_bn),
                    jax.tree_util.tree_leaves(new_state.bn_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)

    if accum == 1:  # the eval step on the new weights (running-stat BN)
        jeval = make_eval_step(cfg, JLoss(JP["focal_iou"]), preprocess_fn=pre)
        ref = jeval(new_state.params, new_state.bn_state,
                    {"images": jnp.asarray(images), "masks": jnp.asarray(masks)},
                    jnp.asarray(1.0))
        out = eval_step(model, LossModule(LOSS_PRESETS["focal_iou"]),
                        {"images": torch.from_numpy(images),
                         "masks": torch.from_numpy(masks)}, 1)
        assert out.keys() == ref.keys()
        for k in out:
            assert abs(float(out[k]) - float(ref[k])) <= 1e-4 * max(
                1.0, abs(float(ref[k]))), k


def test_dataset_cache_raises(tmp_path):
    """The cache builds from a root's images/ and masks/: a root without
    them raises, as in the JAX package (the cache itself is tested in
    test_torch_train_aug)."""
    from s3od_torch.training.data import build_dataset

    with pytest.raises(FileNotFoundError):
        build_dataset([str(tmp_path)], 64, "train", cache=True)


# ----------------------------------------------------------------------------
# (h) the entry point
# ----------------------------------------------------------------------------


def _write_dataset(root: Path, n: int = 16, size: int = 64) -> None:
    from PIL import Image

    ds = root / "tinyds"
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:size, 0:size]
        cy, cx = rng.integers(16, size - 16, 2).tolist()
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 <= 100).astype(np.uint8) * 255
        Image.fromarray(img).save(ds / "images" / f"s{i}.png")
        Image.fromarray(mask).save(ds / "masks" / f"s{i}.png")


def test_train_entrypoint_end_to_end_with_resume(tmp_path):
    """One epoch through the entry point, then a resume from its `last`
    with max_epochs 2 trains only epoch 1 (and runs the end-of-fit
    evaluation of a test set through the port's `evaluate_datasets`);
    checkpoints, index.json and the export appear, and the exported `.npz`
    gives equal masks in the port's and the JAX package's
    `BackgroundRemoval`."""
    from s3od_torch.training.train import train

    _write_dataset(tmp_path)
    args = ["dataset=duts", "dataset.paths=[tinyds]", "dataset.image_size=64",
            "dataset.train_batch_size=2", "dataset.val_batch_size=1",
            "dataset.val_split=0.25", "dataset.transform_mode=test",
            "dataset.test_datasets=[]", "model=tiny", "backend=cpu",
            "backend.devices=1", "backend.num_threads=2",
            f"data_dir={tmp_path}"]
    m1 = train(args + ["backend.max_epochs=1", f"base_dir={tmp_path}/a"])
    assert np.isfinite(m1["train_loss"]) and np.isfinite(m1["val_loss"])
    (run,) = (tmp_path / "a" / "checkpoints").iterdir()
    index = json.loads((run / "index.json").read_text())
    assert index["last"]["epoch"] == 0 and index["best"]
    assert (run / "last" / "state.pt").exists()
    assert (run / index["best"][0]["path"] / "state.pt").exists()

    m2 = train(args + ["backend.max_epochs=2", f"base_dir={tmp_path}/b",
                       f"checkpoint_path={run / 'last'}",
                       "evaluation.enabled=true", f"evaluation.input_dir={tmp_path}",
                       "evaluation.image_size=64", "dataset.test_datasets=[tinyds]"])
    assert np.isfinite(m2["train_loss"])
    (run2,) = (tmp_path / "b" / "checkpoints").iterdir()
    index2 = json.loads((run2 / "index.json").read_text())
    assert index2["last"]["epoch"] == 1
    assert [e["epoch"] for e in index2["best"]] == [1]
    tree = torch.load(run2 / "last" / "state.pt", weights_only=False)
    assert tree["step"] == 12  # 6 steps an epoch, two epochs in all

    from s3od_torch import BackgroundRemoval
    from s3od_tpu.predictor import BackgroundRemoval as JaxRemoval

    img = np.random.default_rng(2).integers(0, 255, (48, 64, 3), np.uint8)
    got = BackgroundRemoval(str(run2 / "s3od_final.npz"), image_size=64,
                            device="cpu").remove_background(img)
    ref = JaxRemoval(model_id=str(run2 / "s3od_final.npz"), image_size=64,
                     dtype="float32").remove_background(img)
    np.testing.assert_allclose(got.all_masks, ref.all_masks, atol=1e-4)
    np.testing.assert_allclose(got.all_ious, ref.all_ious, atol=1e-4)


@pytest.mark.parametrize("override", ["backend.devices=2", "backend.fsdp=2"])
def test_train_entrypoint_raises_for_what_is_not_ported(tmp_path, override):
    """Teacher training runs on one device whatever the backend asks (as
    the JAX trainer does) and refuses to start without its features
    (`tests/test_torch_teacher_training.py` trains it); data parallelism
    is ported (`tests/test_torch_parallel.py`), and with these overrides
    the entry point refuses only what it cannot honour: more devices than
    the visible cards, an fsdp that does not divide the world size (here
    1)."""
    from s3od_torch.training.train import train

    base = ["model=tiny", "dataset.transform_mode=test",
            f"data_dir={tmp_path}", f"base_dir={tmp_path}", override]
    with pytest.raises(ValueError, match="flux_features_dir"):
        train(base[1:] + ["backend=cpu", "config_name=train_teacher"])
    if override == "backend.devices=2":
        if torch.cuda.device_count() >= 2:
            pytest.skip("two CUDA devices are present")
        with pytest.raises(RuntimeError, match="CUDA device"):
            train(base + ["backend=1chip"])
    else:
        with pytest.raises(ValueError, match="does not divide"):
            train(base + ["backend=cpu"])


def test_train_entrypoint_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from s3od_torch.training.train import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train(["model=tiny", "backend=1chip", "dataset.transform_mode=test",
               f"data_dir={tmp_path}", f"base_dir={tmp_path}"])
