"""The decoder slice with the JAX package's two gates on — `S3OD_WINOGRAD`
(K9a, K9b) and `MASK_TAIL_FUSED` (K10) — on the CPU, where the kernel
wrappers run their plain versions:

- the BN-folded serving decoder against the JAX decoder with its gates on
  (kernels in interpret mode) on the same weights and taps, float32 and
  bf16, with both sides shown to run K9a, K9b and K10 where they should;
- the launch counts the copied rule gives at ViT-B (1024^2 b1 and b16,
  2048^2 b1; a training step's forward and dx), on 'meta' tensors at full
  width with the library replaced by a counting stand-in;
- `BackgroundRemoval` with the gates on, the gate read from the
  environment, the gate reaching the FLUX VAE's and the teacher's convs.

The small shapes drop the rule's W >= 128 floor, on both sides alike, as
the JAX decoder test does (`tests/test_experimental_ops.py:251-259`).
Tolerances: float32 5e-5 of max|JAX| (the JAX decoder tests' bound).
bf16: mask logits and IoU scores within 2e-2 of max|JAX|, and the
thresholded masks (logit > 0) agree on 99% of the pixels and on every
pixel whose logit lies farther than that from 0. The two frameworks round
a dozen bf16 layers apart with the gates off too: at a 96 x 128 canvas
they read 1.7e-2 and 69 of 36864 signs apart, all within 1.4e-2 of 0
(max|logit| 2.1)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch import _build
from s3od_torch.models import dpt as tdpt
from s3od_torch.ops import conv as tconv
from s3od_torch.ops.experimental import mask_tail as tmt
from s3od_torch.ops.experimental import winograd as tw

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixture"


def _relaxed(h, w, c, *a, **kw):
    return h % 2 == 0 and w % 16 == 0 and c % 128 == 0 and w >= 32


def _spy(monkeypatch, module, name, calls, key, **extra):
    real = getattr(module, name)

    def call(*a, **kw):
        calls[key] = calls.get(key, 0) + 1
        return real(*a, **{**extra, **kw})

    monkeypatch.setattr(module, name, call)


def _relaxed_conv(h, w, c, k, *a, **kw):
    return _relaxed(h, w, c) and k % 128 == 0


def _gates_on(monkeypatch, conv_rule=_relaxed_conv, rcu_rule=_relaxed):
    """The port's gates on and its rule relaxed; spies on the three plain
    versions (the CPU path of K9a, K9b, K10). Returns the call counts."""
    calls = {}
    monkeypatch.setattr(tconv, "_WINOGRAD_ENABLED", True)
    monkeypatch.setattr(tdpt, "MASK_TAIL_FUSED", True)
    monkeypatch.setattr(tw, "winograd_available", conv_rule)
    monkeypatch.setattr(tw, "rcu_winograd_available", rcu_rule)
    for mod, name, key in ((tw, "winograd_conv_plain", "K9a"),
                           (tw, "winograd_rcu_plain", "K9b"),
                           (tmt, "mask_tail_plain", "K10")):
        _spy(monkeypatch, mod, name, calls, key)
    return calls


def _jax_gates_on(monkeypatch):
    """The JAX decoder's gates on: Winograd in interpret mode with the same
    relaxed rule, the fused tail available and run in interpret mode."""
    import s3od_tpu.models.dpt as jdpt
    import s3od_tpu.ops.conv as jconv
    import s3od_tpu.ops.experimental.mask_tail as jmt
    import s3od_tpu.ops.experimental.winograd as jw

    calls = {}
    monkeypatch.setattr(jconv, "_WINOGRAD_INTERPRET", True)
    monkeypatch.setattr(jw, "winograd_available", _relaxed_conv)
    monkeypatch.setattr(jw, "rcu_winograd_available", _relaxed)
    monkeypatch.setattr(jdpt, "_mask_tail_available", lambda: True)
    _spy(monkeypatch, jw, "conv3x3_winograd", calls, "K9a")
    _spy(monkeypatch, jw, "rcu_winograd", calls, "K9b")
    _spy(monkeypatch, jmt, "mask_tail", calls, "K10", interpret=True)
    return calls


@pytest.fixture(scope="module")
def folded():
    """A tiny encoder's taps into a features-128 decoder (so the RCUs and
    the scratch convs are 128-channel, eligible under the relaxed rule):
    JAX init perturbed with seeded noise, BN folded by the JAX package."""
    from s3od_tpu.configs import tiny_test_config
    from s3od_tpu.models.dpt import fold_bn_inference
    from s3od_tpu.models.segmentation import init_segmentation_params

    cfg = dataclasses.replace(tiny_test_config(), features=128,
                              neck_channels=(128, 128, 128, 128))
    params, state = init_segmentation_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    noise = lambda a: (np.asarray(a, np.float32)
                       + rng.standard_normal(np.shape(a)).astype(np.float32) * 0.05)
    params = jax.tree_util.tree_map(noise, params)
    state = jax.tree_util.tree_map(lambda a: np.abs(noise(a)) + 0.5, state)
    c = cfg.encoder.hidden_size
    for blk in params["encoder"]["blocks"]:  # DINOv3 has no key bias
        blk["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    fp, _, fcfg = fold_bn_inference(params, state, cfg)
    taps = [rng.standard_normal((1, 24, 64)).astype(np.float32) for _ in range(4)]
    return cfg, params, state, fp, fcfg, taps


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_gated_serving_decoder_matches_jax(folded, kind, monkeypatch):
    """A 48 x 128 canvas (3 x 8 patches): layer1_rn (12 x 32, 128 -> 128)
    takes K9a, refinenet1's two RCUs (12 x 32) K9b, the tail at 48 x 128
    K10 — on the JAX side in both dtypes (jitted); on the port's in bf16
    only (float32 exact mode keeps cuDNN, `ops/conv.py`)."""
    from s3od_tpu.models.dpt import dpt_head_forward
    from s3od_torch.convert import state_dict_from_jax
    from s3od_torch.models.segmentation import S3ODSegmentation

    cfg, params, state, fp, fcfg, taps = folded
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[kind]
    jcalls = _jax_gates_on(monkeypatch)
    head = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), fp["head"])
    ref = jax.jit(lambda h, t: dpt_head_forward(
        h, None, t, (3, 8), fcfg, training=False, masks_nhwc=True)[0])(
            head, [jnp.asarray(t, jdt) for t in taps])
    assert jcalls == {"K9a": 1, "K9b": 2, "K10": 1}, jcalls

    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    model.prepare_serving_(tdt)
    calls = _gates_on(monkeypatch)
    with torch.inference_mode():
        masks, iou = model.seg_head([torch.from_numpy(t).to(tdt) for t in taps],
                                    (3, 8), 16, False, True)
    assert calls == ({"K9a": 1, "K9b": 2, "K10": 1} if kind == "bfloat16" else {})
    got_m = masks.float().permute(0, 2, 3, 1).numpy()
    ref_m = np.asarray(ref["pred_masks"].astype(jnp.float32))
    got_i = iou.float().numpy()
    ref_i = np.asarray(ref["pred_iou"].astype(jnp.float32))
    assert got_m.shape == ref_m.shape == (1, 48, 128, 3)
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    if kind == "float32":
        assert rel(got_m, ref_m) < 5e-5 and rel(got_i, ref_i) < 5e-5
    else:
        band = 2e-2 * np.abs(ref_m).max()
        agree = (got_m > 0) == (ref_m > 0)
        assert agree.mean() >= 0.99 and agree[np.abs(ref_m) > band].all()
        assert rel(got_m, ref_m) < 2e-2 and rel(got_i, ref_i) < 2e-2


def test_gates_off_run_no_gated_kernel(folded, monkeypatch):
    """With both gates off the same bf16 decoder takes none of the three
    routes, whatever the rule says."""
    from s3od_torch.convert import state_dict_from_jax
    from s3od_torch.models.segmentation import S3ODSegmentation

    cfg, params, state, _, _, taps = folded
    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    model.prepare_serving_(torch.bfloat16)
    calls = _gates_on(monkeypatch)
    monkeypatch.setattr(tconv, "_WINOGRAD_ENABLED", False)
    monkeypatch.setattr(tdpt, "MASK_TAIL_FUSED", False)
    with torch.inference_mode():
        model.seg_head([torch.from_numpy(t).to(torch.bfloat16) for t in taps],
                       (3, 8), 16, False, True)
    assert calls == {}


class _CountingLibrary:
    """Stands in for the kernel library: every entry point 'launches'
    (returns 0) without touching memory, so the wrappers count."""

    def __getattr__(self, name):
        return lambda *args: 0


def _vit_b_meta_head(monkeypatch, fold: bool):
    from s3od_torch.configs import segmentation_config

    monkeypatch.setattr(_build, "load_library", lambda: _CountingLibrary())
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    cfg = segmentation_config("dinov3_base")
    with torch.device("meta"):
        head = tdpt.DPTHead(cfg)
    if fold:
        tdpt.fold_bn_(head)
    return cfg, head.to(torch.bfloat16)


def _reset():
    tw.winograd_conv.launches = tw.winograd_rcu.launches = 0
    tmt.mask_tail.launches = 0


def _counts():
    return (tw.winograd_conv.launches, tw.winograd_rcu.launches,
            tmt.mask_tail.launches)


@pytest.mark.parametrize("size,batch,gates,want", [
    (1024, 1, True, (3, 4, 1)), (1024, 16, True, (3, 4, 1)),
    (2048, 1, True, (7, 4, 1)), (1024, 1, False, (0, 0, 0)),
])
def test_serving_launch_counts_at_vit_b(size, batch, gates, want, monkeypatch):
    """The copied rule at ViT-B's widths (features 256, neck 256-1024,
    inter 32), bf16. 1024^2: K9a on layer1_rn (256^2, 256 -> 256),
    layer2_rn (128^2, 512 -> 256), output_conv1 (512^2, 256 -> 128); K9b on
    refinenet2 and 1 (128^2, 256^2); K10 once. 2048^2: refinenet1's 512^2
    RCUs overflow K9b's budget, so their four convs take K9a (7); K9b on
    refinenet3 and 2. Refinenet4 (and 3 at 1024^2) fail W/2 >= 64, the
    64-channel convs C % 128."""
    cfg, head = _vit_b_meta_head(monkeypatch, fold=True)
    monkeypatch.setattr(tconv, "_WINOGRAD_ENABLED", gates)
    monkeypatch.setattr(tdpt, "MASK_TAIL_FUSED", gates)
    p = size // 16
    taps = [torch.empty(batch, p * p, 768, dtype=torch.bfloat16, device="meta")
            for _ in range(4)]
    _reset()
    with torch.inference_mode():
        masks, _ = head(taps, (p, p), 16, False, True)
    assert tuple(masks.shape) == (batch, 3, size, size)
    assert _counts() == want


def vit_b_train_k9a(size: int):
    """K9a launches of one training step at ViT-B by the rule, from the
    decoder's 3x3/s1/p1 convs written out (BN unfolded, so every RCU conv
    is a single conv): (forward, dx)."""
    p = size // 16
    f, neck = 256, (256, 512, 1024, 1024)
    rn = [4 * p, 2 * p, p, p // 2]
    convs = [(rn[i], neck[i], f) for i in range(4)]          # layerN_rn
    convs += [(rn[i], f, f) for i in range(4) for _ in range(2 if i == 3 else 4)]
    convs += [(8 * p, f, f // 2), (16 * p, 64, 64), (16 * p, 64, 96)]
    fwd = sum(tw.winograd_available(s, s, c, k) for s, c, k in convs)
    dx = sum(tw.winograd_available(s, s, c, k) and tw.winograd_available(s, s, k, c)
             for s, c, k in convs)
    return fwd, dx


def test_training_step_k9a_counts_at_vit_b(monkeypatch):
    """A training forward and backward at ViT-B 1024^2 (meta tensors): K9a
    forward and dx launches as the rule gives them (dx only where the
    rule admits the gradient's shape); no K9b (the RCUs carry BN), no K10
    (training keeps the unfused tail)."""
    cfg, head = _vit_b_meta_head(monkeypatch, fold=False)
    monkeypatch.setattr(tconv, "_WINOGRAD_ENABLED", True)
    monkeypatch.setattr(tdpt, "MASK_TAIL_FUSED", True)
    taps = [torch.empty(2, 4096, 768, dtype=torch.bfloat16, device="meta",
                        requires_grad=True) for _ in range(4)]
    _reset()
    masks, iou = head(taps, (64, 64), 16, True, False)
    fwd = _counts()
    (masks.float().sum() + iou.float().sum()).backward()
    want_fwd, want_dx = vit_b_train_k9a(1024)
    assert fwd == (want_fwd, 0, 0) and want_fwd == 11
    assert _counts() == (want_fwd + want_dx, 0, 0)


def test_background_removal_runs_the_gated_kernels(monkeypatch):
    """The public entry point in bf16 with both gates on (the tiny trained
    checkpoint at 128^2; the rule relaxed further, to any channel count,
    so its narrow convs route): K9a, K9b and K10 run, and the masks agree
    with the float32 predictor as the ungated bf16 route does
    (tests/test_torch_predictor.py)."""
    from PIL import Image

    from s3od_torch import BackgroundRemoval

    image = np.array(Image.open(FIXTURE / "image.jpg").convert("RGB"))
    r32 = BackgroundRemoval(str(FIXTURE / "tiny_s3od.npz"), image_size=128,
                            device="cpu").remove_background(image)
    pred = BackgroundRemoval(str(FIXTURE / "tiny_s3od.npz"), image_size=128,
                             device="cpu", dtype="bfloat16")
    narrow = lambda h, w, *a, **kw: h % 2 == 0 and w % 16 == 0 and w >= 32
    calls = _gates_on(monkeypatch, conv_rule=narrow, rcu_rule=narrow)
    r = pred.remove_background(image)
    assert calls == {"K9a": 2, "K9b": 2, "K10": 1}, calls
    agree = ((r.all_masks > 0.5) == (r32.all_masks > 0.5)).mean()
    assert agree >= 0.99
    assert np.abs(r.all_ious - r32.all_ious).max() <= 2e-2


def test_winograd_gate_is_read_from_the_environment():
    code = ("import s3od_torch.ops.conv as c, s3od_torch.models.dpt as d; "
            "print(c._WINOGRAD_ENABLED, d.MASK_TAIL_FUSED)")
    for value, want in (("1", "True False"), ("0", "False False")):
        env = {**os.environ, "S3OD_WINOGRAD": value}
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == want


def test_gate_reaches_the_vae_and_the_teacher(monkeypatch):
    """The FLUX VAE's and the FluxDPT teacher's 3x3 convs go through
    `ops/conv.conv2d`, as the JAX modules call its `conv2d`: with the gate
    on (eligibility forced for every bf16 3x3/s1/p1 conv on even sizes)
    both reach K9a; the teacher never runs K10 (the JAX teacher keeps the
    unfused tail)."""
    from s3od_torch.configs import tiny_test_config
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher
    from s3od_torch.models.vae import VAE, init_vae, tiny_vae_config

    calls = _gates_on(monkeypatch)
    monkeypatch.setattr(tconv, "_winograd_eligible", lambda x, w, s, p: (
        x.dtype == torch.bfloat16 and s == 1 and p == 1
        and tuple(w.shape[2:]) == (3, 3) and x.shape[2] % 2 == 0
        and x.shape[3] % 2 == 0))
    gen = torch.Generator().manual_seed(0)
    vcfg = tiny_vae_config()
    vae = VAE(*init_vae(vcfg, gen), vcfg, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(0)
    lat = vae.encode(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    enc = calls.get("K9a", 0)
    vae.decode(lat)
    dec = calls.get("K9a", 0) - enc
    assert enc > 0 and dec > 0, (enc, dec)

    teacher = init_flux_teacher(FluxTeacherConfig(base=tiny_test_config(),
                                                  flux_dim=24), gen)
    teacher = teacher.to(torch.bfloat16)
    calls.clear()
    img = torch.from_numpy(rng.standard_normal((1, 96, 128, 3))).to(torch.bfloat16)
    feats = [torch.from_numpy(rng.standard_normal((1, 48, 24))) for _ in range(4)]
    cmaps = {k: torch.from_numpy(rng.random((1, 6, 8))).float()
             for k in ("category", "background")}
    with torch.inference_mode():
        out = teacher(img, feats, cmaps)
    assert calls.get("K9a", 0) > 0 and "K10" not in calls, calls
    assert torch.isfinite(out["pred_masks"]).all()
