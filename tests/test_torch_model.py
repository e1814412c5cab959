"""s3od_torch model parity against the JAX package on the tiny config:
encoder taps (exact route vs XLA attention; kernel route, run with the
plain kernel versions in float32, vs the JAX fused-kernel route in
interpret mode), the full segmentation forward, the BN fold and sequence
padding. Weights are the JAX init perturbed with seeded numpy noise and
carried across with `state_dict_from_jax`; inputs are seeded numpy."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_tpu.configs import tiny_test_config
from s3od_tpu.models.segmentation import init_segmentation_params
from s3od_torch.convert import state_dict_from_jax
from s3od_torch.models import dinov3 as tdinov3
from s3od_torch.models.segmentation import S3ODSegmentation


def _perturbed_params(cfg, seed=0):
    """JAX init + noise on every leaf, so no weight sits at a trivial value
    (LN at 1/0, BN at identity statistics); the fused key-bias segment
    stays zero as DINOv3 requires."""
    params, state = init_segmentation_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)

    def noise(a):
        a = np.asarray(a, np.float32)
        return a + rng.standard_normal(a.shape).astype(np.float32) * 0.05

    params = jax.tree_util.tree_map(noise, params)
    state = jax.tree_util.tree_map(lambda a: np.abs(noise(a)) + 0.5, state)
    c = cfg.encoder.hidden_size
    for blk in params["encoder"]["blocks"]:
        blk["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    return params, state


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config()
    params, state = _perturbed_params(cfg)
    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    model.eval()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    return cfg, params, state, model, x


def _taps(model, x, route):
    with torch.no_grad():
        return model.encoder(torch.from_numpy(x), model.cfg.tap_layers, route)


def test_rope_tables_match_jax():
    from s3od_tpu.models.dinov3 import rope_cos_sin

    cos_j, sin_j = rope_cos_sin(8, 6, 32, 100.0)
    cos, sin = tdinov3.rope_cos_sin(8, 6, 32, 100.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_j), atol=1e-6)


def test_encoder_exact_route_matches_xla_encoder(tiny):
    from s3od_tpu.models.dinov3 import encoder_forward

    cfg, params, _, model, x = tiny
    ref = encoder_forward(params["encoder"], jnp.asarray(x), cfg.encoder,
                          cfg.tap_layers, attn_impl="xla")
    got = _taps(model, x, "exact")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def _jax_fused_route_taps(tiny, monkeypatch, streaming=False):
    """Taps of the JAX block's default fused route (K1 -> K2 -> K3 -> K4 ->
    K5, `_MLP_FUSED_ENABLED` as shipped) with its Pallas kernels in
    interpret mode; `streaming` forces 64-row blocks so the attention
    streams over K blocks (`_fwd_kernel_stream_static`, the 2048^2 kernel
    stack, as tests/test_highres_surface.py forces it)."""
    from s3od_tpu.models import dinov3
    from s3od_tpu.models.dinov3 import encoder_forward

    cfg, params, _, _, x = tiny
    monkeypatch.setattr(dinov3, "_QKV_FUSED_INTERPRET", True)
    monkeypatch.setattr("s3od_tpu.ops.attention.resolve_attn_impl",
                        lambda n, dtype, impl="auto": "flash")
    if streaming:
        monkeypatch.setattr("s3od_tpu.ops.flash_attention._pick_blocks",
                            lambda n, d: (64, 64))
    return encoder_forward(params["encoder"], jnp.asarray(x), cfg.encoder,
                           cfg.tap_layers, attn_impl="flash")


def test_encoder_kernel_route_matches_jax_fused_route(tiny, monkeypatch):
    """The port's K1 -> K2 -> K3 -> K4 -> K5 block order (plain kernel
    versions, float32) against the JAX default fused route, fused MLP
    included (no `fits_vmem` override)."""
    _, _, _, model, x = tiny
    ref = _jax_fused_route_taps(tiny, monkeypatch)
    got = _taps(model, x, "kernel")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def test_encoder_kernel_route_matches_jax_streaming_route(tiny, monkeypatch):
    """The same route against the JAX stack that streams over K blocks
    (69 tokens padded to 128 = 2 K blocks of 64): K6's semantics."""
    from s3od_tpu.ops import flash_attention as jfa

    _, _, _, model, x = tiny
    calls = []
    stream = jfa._fwd_kernel_stream_static
    monkeypatch.setattr(jfa, "_fwd_kernel_stream_static",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    ref = _jax_fused_route_taps(tiny, monkeypatch, streaming=True)
    assert calls, "the JAX side did not reach the streaming kernel"
    got = _taps(model, x, "kernel")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def test_kernel_route_runs_the_fused_mlp(tiny, monkeypatch):
    """Every block of the kernel route goes through `mlp_fused` and never
    through the unfused `MLP.forward`; the exact route keeps the plain MLP."""
    from s3od_torch.ops import mlp_fused as mf

    cfg, _, _, model, x = tiny
    fused, plain = [], []
    real = tdinov3.mlp_fused_autograd
    monkeypatch.setattr(tdinov3, "mlp_fused_autograd",
                        lambda *a: fused.append(1) or real(*a))
    for blk in model.encoder.layer:
        monkeypatch.setattr(blk.mlp, "forward",
                            lambda h, f=blk.mlp.forward: plain.append(1) or f(h))
    _taps(model, x, "kernel")
    assert len(fused) == max(cfg.tap_layers) and not plain
    _taps(model, x, "exact")
    assert len(plain) == max(cfg.tap_layers)
    assert mf.mlp_fused.launches == 0  # CPU tensors: plain version


def test_segmentation_forward_matches_jax(tiny):
    from s3od_tpu.models.segmentation import segmentation_forward

    cfg, params, state, model, x = tiny
    ref, _ = segmentation_forward(params, state, jnp.asarray(x), cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out["pred_masks"].shape == (2, cfg.num_outputs, 128, 128)
    np.testing.assert_allclose(out["pred_masks"].numpy(),
                               np.asarray(ref["pred_masks"]), atol=1e-4)
    np.testing.assert_allclose(out["pred_iou"].numpy(),
                               np.asarray(ref["pred_iou"]), atol=1e-4)


def test_bn_fold_matches_unfolded_model(tiny):
    """`prepare_serving_` folds the RCU BatchNorms in float64; the folded
    model agrees with the unfolded one and with JAX's fold_bn_inference."""
    from s3od_tpu.models.dpt import fold_bn_inference
    from s3od_tpu.models.segmentation import segmentation_forward

    cfg, params, state, model, x = tiny
    folded = S3ODSegmentation(cfg)
    folded.load_state_dict(model.state_dict(), strict=True)
    folded.prepare_serving_(torch.float32)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a, b = model(xt), folded(xt)
    np.testing.assert_allclose(b["pred_masks"].numpy(), a["pred_masks"].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(b["pred_iou"].numpy(), a["pred_iou"].numpy(),
                               atol=1e-5)
    fp, fs, fcfg = fold_bn_inference(params, state, cfg)
    ref, _ = segmentation_forward(fp, fs, jnp.asarray(x), fcfg)
    np.testing.assert_allclose(b["pred_masks"].numpy(),
                               np.asarray(ref["pred_masks"]), atol=1e-4)


def test_encoder_sequence_padding_is_transparent(tiny, monkeypatch):
    """Padded tokens are masked as keys and carry identity RoPE rows, so
    padding the sequence changes no tap: the exact route padded by 7, and
    the kernel route (padded to its 64-token tile, 69 -> 128) against the
    unpadded exact route."""
    _, _, _, model, x = tiny
    ref = _taps(model, x, "exact")
    kern = _taps(model, x, "kernel")
    monkeypatch.setattr(tdinov3, "attn_seq_len", lambda n, route: n + 7)
    padded = _taps(model, x, "exact")
    for r, p, k in zip(ref, padded, kern):
        np.testing.assert_allclose(p.numpy(), r.numpy(), atol=1e-5)
        np.testing.assert_allclose(k.numpy(), r.numpy(), atol=5e-5)


def test_state_dict_keys_match_reference_layout(tiny):
    """The state dict has exactly the reference layout's keys and values:
    the fused qkv Linear is split into q_proj / k_proj / v_proj on save
    (no key bias) and fused again on a strict load."""
    from s3od_tpu.convert import export_torch_state_dict

    cfg, params, state, model, _ = tiny
    ref = export_torch_state_dict(params, state)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    again = S3ODSegmentation(cfg)
    again.load_state_dict(sd, strict=True)
    for (k, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), k
    qkv = dict(again.encoder.layer[0].attention.qkv.named_parameters())
    c = cfg.encoder.hidden_size
    assert qkv["weight"].shape == (3 * c, c)
    assert not qkv["bias"][c: 2 * c].any()


def test_unknown_route_raises(tiny):
    _, _, _, model, x = tiny
    with pytest.raises(ValueError):
        _taps(model, x, "flash")


def test_init_weights_is_seeded():
    from s3od_torch.models.segmentation import init_weights_

    cfg = dataclasses.replace(tiny_test_config(num_layers=1), tap_layers=(1,))
    a = init_weights_(S3ODSegmentation(cfg), torch.Generator().manual_seed(3))
    b = init_weights_(S3ODSegmentation(cfg), torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    enc = a.encoder.layer[0]
    assert torch.equal(enc.layer_scale1.lambda1, torch.ones(64))
    assert float(enc.attention.qkv.weight.detach().abs().max()) <= 0.04
