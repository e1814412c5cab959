"""s3od_torch's synthetic-data factory against the JAX package on the CPU:
latent packing and the schedule, the VAE, the `ConceptAttentionPipeline`
(text-to-image and `extract_features`, with JAX's initial noise injected),
the FLUX teacher's eval forward on a non-square patch grid, the `.npz`
round trips, and the tiny generation CLI (`backend: diffusion` from `.npz`
fixtures) against the JAX orchestrator's returned image, features, maps
and mask. Inputs and weights are seeded numpy, carried across by
`s3od_torch.convert`.

Tolerances (float32): relative 1e-5 of max|JAX| for one op, 1e-4 for a
whole network or a multi-step pipeline (the same math in another
summation order); uint8 images and masks within 1 (a truncation to uint8
of values that differ in the last float32 bits).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s3od_torch.convert import (
    config_to_meta,
    load_teacher,
    save_factory_npz,
    teacher_state_dict_from_jax,
    teacher_tree_from_state_dict,
    tree_to_state_dict,
)
from s3od_torch.datagen import diffusion as td


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _tree(t):
    return jax.tree.map(np.array, t)


def _jax_noise(seed, shape, device):
    """JAX's draw for `seed` (`diffusion.py:429-432`) in place of the port's."""
    z = jax.random.normal(jax.random.key(seed), tuple(shape), jnp.float32)
    return torch.from_numpy(np.array(z)).to(device)


# ----------------------------------------------------------------------------
# Packing, schedule, features
# ----------------------------------------------------------------------------


def test_packing_schedule_and_feature_compression_match_jax():
    from s3od_tpu.datagen import diffusion as jd

    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 12, 16, 16)).astype(np.float32)
    packed = td.pack_latents(_t(lat))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jd.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(td.unpack_latents(packed, 12, 16).numpy(), lat)
    np.testing.assert_array_equal(td.make_img_ids(6, 8), jd.make_img_ids(6, 8))
    for steps, n in ((28, 4096), (50, 3328), (4, 16)):
        assert td.calculate_shift(n) == jd.calculate_shift(n)
        np.testing.assert_array_equal(td.FlowMatchSchedule.create(steps, n).sigmas,
                                      jd.FlowMatchSchedule.create(steps, n).sigmas)
    s = td.FlowMatchSchedule.create(4, 16)
    x, v = _t(lat[:1]), _t(lat[1:])
    jx = jd.FlowMatchSchedule.create(4, 16)
    np.testing.assert_allclose(s.step(x, v, 3).numpy(),
                               jx.step(jnp.asarray(lat[:1]), jnp.asarray(lat[1:]), 3),
                               rtol=1e-6)
    np.testing.assert_allclose(s.scale_noise(x, v, 1).numpy(),
                               jx.scale_noise(jnp.asarray(lat[:1]),
                                              jnp.asarray(lat[1:]), 1), rtol=1e-6)
    feat = rng.standard_normal((1, 48, 96)).astype(np.float32)
    np.testing.assert_allclose(td.compress_features(_t(feat)).numpy(),
                               jd.compress_features(jnp.asarray(feat)), atol=1e-6)


# ----------------------------------------------------------------------------
# VAE
# ----------------------------------------------------------------------------


VAE8 = dict(latent_channels=4, base_channels=8, channel_mults=(1, 1, 1, 1),
            layers_per_block=1, groups=4)


@pytest.mark.parametrize("which", ["tiny", "8x"])
def test_vae_encode_decode_match_jax(which, tmp_path):
    """encode (the asymmetric pad before each stride-2 conv, the logvar
    half dropped, scale and shift) and decode (exact 2x nearest), float32,
    through the `.npz` both packages read; in bf16 the mid attention
    promotes to float32 on both sides."""
    from s3od_tpu.convert import save_native
    from s3od_tpu.models import vae as jv
    from s3od_torch.models import vae as tv

    jcfg = jv.tiny_vae_config() if which == "tiny" else jv.VAEConfig(**VAE8)
    tcfg = tv.tiny_vae_config() if which == "tiny" else tv.VAEConfig(**VAE8)
    enc, dec = _tree(jv.init_vae_params(jax.random.key(3), jcfg))
    path = str(tmp_path / "vae.npz")
    save_native(path, {"enc": enc, "dec": dec}, {"config": config_to_meta(tcfg)})
    port = tv.load_vae(path, device="cpu")
    assert port.cfg == tcfg and port.dtype == torch.float32
    ref = jv.VAE(enc, dec, jcfg, dtype=jnp.float32)
    img = np.random.default_rng(1).integers(0, 256, (1, 48, 64, 3), np.uint8)
    lat = port.encode(img)
    lat_ref = ref.encode(img)
    assert lat.shape == lat_ref.shape
    assert _rel(lat, lat_ref) < 1e-5
    out, out_ref = port.decode(lat_ref), ref.decode(lat_ref)
    assert out.dtype == np.uint8 and out.shape == out_ref.shape
    assert np.abs(out.astype(int) - out_ref.astype(int)).max() <= 1
    jdec = jv.vae_decode(jax.tree.map(jnp.asarray, dec),
                         jnp.asarray(lat_ref).astype(jnp.bfloat16), jcfg)
    tdec = port.dec(_t(lat_ref, torch.bfloat16))
    assert tdec.dtype == torch.float32 and jdec.dtype == jnp.float32


# ----------------------------------------------------------------------------
# The pipeline
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipelines():
    from s3od_tpu.datagen.diffusion import ConceptAttentionPipeline as JPipe
    from s3od_tpu.models.mmdit import init_mmdit_params, tiny_mmdit_config
    from s3od_tpu.models import vae as jv
    from s3od_torch.models import mmdit as tm
    from s3od_torch.models import vae as tv

    cfg = tm.tiny_mmdit_config()
    params = _tree(init_mmdit_params(jax.random.key(0), tiny_mmdit_config()))
    enc, dec = _tree(jv.init_vae_params(jax.random.key(1), jv.tiny_vae_config()))
    jpipe = JPipe(params, tiny_mmdit_config(), text_encoders=None,
                  num_inference_steps=4, compute_dtype="float32",
                  vae=jv.VAE(enc, dec, jv.tiny_vae_config(), dtype=jnp.float32))
    model = tm.MMDiT(cfg)
    model.load_state_dict(tree_to_state_dict(params), strict=True)
    venc, vdec = tv.VAEEncoder(tv.tiny_vae_config()), tv.VAEDecoder(tv.tiny_vae_config())
    venc.load_state_dict(tree_to_state_dict(enc), strict=True)
    vdec.load_state_dict(tree_to_state_dict(dec), strict=True)
    tpipe = td.ConceptAttentionPipeline(
        model, text_encoders=None, num_inference_steps=4, device="cpu",
        vae=tv.VAE(venc, vdec, tv.tiny_vae_config(), device="cpu"))
    rng = np.random.default_rng(0)
    embeds = (rng.standard_normal((1, 8, cfg.text_dim)).astype(np.float32),
              rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32))
    cemb = rng.standard_normal((1, 2, cfg.text_dim)).astype(np.float32)
    return jpipe, tpipe, dict(prompt_embeds=embeds, concept_embeds=cemb)


def _same_output(got, ref):
    assert got.latents.shape == ref.latents.shape
    assert _rel(got.latents, ref.latents) < 1e-4
    assert len(got.features) == len(ref.features)
    for g, r in zip(got.features, ref.features):
        assert _rel(g, np.asarray(r, np.float32)) < 1e-4
    assert set(got.concept_maps) == set(ref.concept_maps)
    for name, m in got.concept_maps.items():
        assert m.shape == ref.concept_maps[name].shape
        assert np.abs(m - ref.concept_maps[name]).max() < 1e-4
    if ref.image is not None:
        assert got.image.shape == ref.image.shape
        assert np.abs(got.image.astype(int) - ref.image.astype(int)).max() <= 1


def test_pipeline_t2i_and_extract_features_match_jax(tiny_pipelines, monkeypatch):
    """4 denoise steps with the concept stream on the last 3, the maps
    averaged over (step, layer) and min-max normalized, the last step's
    compressed taps, the decoded image; then the single-step inversion at
    the last timestep of a 50-step schedule."""
    jpipe, tpipe, emb = tiny_pipelines
    monkeypatch.setattr(td, "initial_noise", _jax_noise)
    kw = dict(height=64, width=64, seed=1, concepts=["fox", "background"], **emb)
    ref = jpipe("a red fox", **kw)
    got = tpipe("a red fox", **kw)
    assert got.concept_maps["fox"].shape == (4, 4)
    _same_output(got, ref)
    ext_ref = jpipe.extract_features(ref.latents, "a red fox",
                                     ["fox", "background"], 64, 64, **emb)
    ext = tpipe.extract_features(ref.latents, "a red fox",
                                 ["fox", "background"], 64, 64, **emb)
    _same_output(ext, ext_ref)
    assert tpipe.concept_timesteps == [1, 2, 3]


def test_pipeline_refuses_lora_and_fsdp_naming_the_queue(tiny_pipelines):
    """Sharding is ported (`tests/test_torch_parallel.py`): a `mesh=` that
    is not a `DeviceMesh`, and an `fsdp=` that does not divide the world
    size (1 here), are refused before any process group is made. `lora=`
    is ported (`tests/test_torch_lora.py`): a missing adapter file fails as
    a missing file."""
    import torch.distributed as dist

    _, tpipe, _ = tiny_pipelines
    with pytest.raises(TypeError, match="DeviceMesh"):
        td.ConceptAttentionPipeline(tpipe.model, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="does not divide"):
        td.ConceptAttentionPipeline.from_config("x.npz", fsdp=4, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(FileNotFoundError):
        td.ConceptAttentionPipeline(tpipe.model, device="cpu",
                                    lora="adapters.npz")


# ----------------------------------------------------------------------------
# The FLUX teacher
# ----------------------------------------------------------------------------


def _teacher_params(flux_dim, seed=0):
    from s3od_tpu.configs import tiny_test_config
    from s3od_tpu.models.flux_teacher import (FluxTeacherConfig,
                                              init_flux_teacher_params)

    cfg = FluxTeacherConfig(base=tiny_test_config(), flux_dim=flux_dim)
    params, state = init_flux_teacher_params(jax.random.key(seed), cfg)
    return cfg, _tree(params), _tree(state)


def test_flux_teacher_forward_matches_jax_on_a_non_square_grid(tmp_path):
    """A 96 x 128 image (a 6 x 8 patch grid): FLUX features resized with
    antialiasing to every pyramid stride (32: down, 16: same, 8 and 4:
    up), concept maps through the 3x3 projection; BN on running statistics.
    Weights cross as the JAX `.npz` and back."""
    from s3od_tpu.convert import load_native_segmentation, save_native
    from s3od_tpu.models.flux_teacher import flux_teacher_forward

    cfg, params, state = _teacher_params(48)
    state["fusion"][2]["flux"]["bn"]["mean"][:] = 0.1  # non-identity stats
    path = str(tmp_path / "teacher.npz")
    save_native(path, params, state)
    model = load_teacher(path)
    assert model.cfg.flux_dim == 48
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 96, 128, 3)).astype(np.float32)
    tf = [rng.standard_normal((1, 48, 48)).astype(np.float32) for _ in range(4)]
    cm = {k: rng.random((1, 6, 8)).astype(np.float32)
          for k in ("category", "background")}
    ref, _ = flux_teacher_forward(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, state),
                                  jnp.asarray(img), [jnp.asarray(t) for t in tf],
                                  {k: jnp.asarray(v) for k, v in cm.items()}, cfg)
    with torch.no_grad():
        got = model(_t(img), [_t(t) for t in tf],
                    {k: _t(v) for k, v in cm.items()})
    assert got["pred_masks"].shape == (1, 3, 96, 128)
    assert _rel(got["pred_masks"].numpy(), ref["pred_masks"]) < 1e-4
    assert _rel(got["pred_iou"].numpy(), ref["pred_iou"]) < 1e-4

    # the port's state dict -> the JAX trees -> the JAX loader
    p2, s2 = teacher_tree_from_state_dict(model.state_dict())
    save_native(str(tmp_path / "back.npz"), p2, s2)
    p3, s3, _ = load_native_segmentation(str(tmp_path / "back.npz"))
    sd = teacher_state_dict_from_jax(p3, s3)
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))  # bookkeeping


def test_flux_teacher_init_follows_the_jax_scheme():
    from s3od_torch.configs import tiny_test_config
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher

    m = init_flux_teacher(FluxTeacherConfig(base=tiny_test_config(), flux_dim=24),
                          torch.Generator().manual_seed(0))
    conv = m.fusion[0].fusion.conv1
    bound = (6.0 / conv.weight[0].numel()) ** 0.5
    assert float(conv.weight.detach().abs().max()) <= bound
    assert float(m.fusion[1].flux.bn.running_var.min()) == 1.0
    assert m.fusion[3].concept.conv.weight.shape == (16, 2, 3, 3)


# ----------------------------------------------------------------------------
# The generation CLI end to end
# ----------------------------------------------------------------------------


def _text_cfgs():
    from s3od_tpu.models import text_encoders as jt
    from s3od_torch.models import text_encoders as tt

    t5 = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=96, num_layers=2,
              num_heads=4)
    clip = dict(vocab_size=400, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=2)
    return ((jt.T5Config(**t5), tt.T5Config(**t5)),
            (jt.CLIPTextConfig(**clip), tt.CLIPTextConfig(**clip)))


def _factory_fixtures(tmp_path):
    """`.npz` fixtures both packages load — a tiny MMDiT with 4 taps, tiny
    T5/CLIP, an 8x VAE, a tiny teacher (flux_dim 24) — with the port's
    configurations beside the weights; -> (paths, the JAX trees/configs)."""
    from s3od_tpu.convert import save_native
    from s3od_tpu.models import mmdit as jm
    from s3od_tpu.models import text_encoders as jt
    from s3od_tpu.models import vae as jv
    from s3od_torch.models import mmdit as tm
    from s3od_torch.models import vae as tv

    jcfg = dataclasses.replace(jm.tiny_mmdit_config(), feature_taps=(0, 1, 2, 3))
    tcfg = dataclasses.replace(tm.tiny_mmdit_config(), feature_taps=(0, 1, 2, 3))
    (jt5c, tt5c), (jclc, tclc) = _text_cfgs()
    mm = _tree(jm.init_mmdit_params(jax.random.key(0), jcfg))
    t5p = _tree(jt.init_t5_params(jax.random.key(1), jt5c))
    clp = _tree(jt.init_clip_text_params(jax.random.key(2), jclc))
    enc, dec = _tree(jv.init_vae_params(jax.random.key(3), jv.VAEConfig(**VAE8)))
    _, tp, ts = _teacher_params(24, seed=4)
    files = {name: str(tmp_path / f"{name}.npz")
             for name in ("flux", "t5", "clip", "vae", "teacher")}
    save_native(files["flux"], mm, {"config": config_to_meta(tcfg)})
    save_native(files["t5"], t5p, {"config": config_to_meta(tt5c)})
    save_native(files["clip"], clp, {"config": config_to_meta(tclc)})
    save_native(files["vae"], {"enc": enc, "dec": dec},
                {"config": config_to_meta(tv.VAEConfig(**VAE8))})
    save_native(files["teacher"], tp, ts)
    return files, dict(mm=mm, cfg=jcfg, t5=t5p, t5_cfg=jt5c, clip=clp,
                       clip_cfg=jclc, enc=enc, dec=dec)


def _jax_pipeline(o, steps):
    from s3od_tpu.datagen.diffusion import ConceptAttentionPipeline as JPipe
    from s3od_tpu.datagen.text_encoding import JaxTextEncoders
    from s3od_tpu.models import vae as jv

    return JPipe(o["mm"], o["cfg"], num_inference_steps=steps,
                 compute_dtype="float32",
                 text_encoders=JaxTextEncoders(o["t5"], o["clip"], o["t5_cfg"],
                                               o["clip_cfg"],
                                               compute_dtype="float32"),
                 vae=jv.VAE(o["enc"], o["dec"], jv.VAEConfig(**VAE8),
                            dtype=jnp.float32))


def test_teacher_predictor_matches_jax(tmp_path, monkeypatch):
    """`SODTeacherPredictor` at one 96 x 128 bucket: the single-step
    inversion's features and maps, the teacher, the antialiased resize back;
    and `predict_from_npz`. The JAX `predict` hands the teacher features
    with the batch axis still on ((1, 1, N, C)) and fails there, so its
    side runs `_run_teacher` on the same features without that axis; the
    port drops it (ROADMAP, Queue 3)."""
    from s3od_tpu.datagen import resizer as jr
    from s3od_tpu.evaluation.teacher_predictor import SODTeacherPredictor as JTP
    from s3od_torch.datagen import resizer as tr
    from s3od_torch.evaluation.teacher_predictor import SODTeacherPredictor

    files, o = _factory_fixtures(tmp_path)
    for mod in (jr, tr):
        monkeypatch.setattr(mod, "RESOLUTION_BUCKETS", [(96, 128)])
    monkeypatch.setattr(td, "initial_noise", _jax_noise)
    jp = JTP(files["teacher"])
    jp._pipeline, jp._vae = _jax_pipeline(o, 28), _jax_pipeline(o, 28).vae
    from s3od_torch.datagen.text_encoding import TorchTextEncoders

    enc = TorchTextEncoders.from_npz(files["t5"], files["clip"], device="cpu")
    tp = SODTeacherPredictor(files["teacher"], files["flux"], files["vae"],
                             device="cpu", text_encoders=enc)
    image = np.random.default_rng(2).integers(0, 256, (120, 150, 3), np.uint8)
    resized, feats, cmaps = jp.extract_flux_features(image, "a cat", "cat")
    with pytest.raises(ValueError):
        jp.predict(image, "a cat", "cat")
    ref = jp._run_teacher(resized, [f[0] for f in feats], cmaps,
                          image.shape[:2], 0.5)
    got = tp.predict(image, "a cat", "cat")
    assert got.soft_mask.shape == (120, 150)
    assert np.abs(got.soft_mask - ref.soft_mask).max() < 1e-4
    assert _rel(got.all_ious, ref.all_ious) < 1e-4

    npz = tmp_path / "feats.npz"
    np.savez(npz, **{f"layer_{i}": np.asarray(f[0]) for i, f in enumerate(feats)},
             **cmaps)
    ref = jp.predict_from_npz(image, str(npz))
    got = tp.predict_from_npz(image, str(npz))
    assert np.abs(got.soft_mask - ref.soft_mask).max() < 1e-4
    np.testing.assert_array_equal(got.binary_mask, ref.binary_mask)


def test_generation_cli_matches_the_jax_orchestrator(tmp_path, monkeypatch):
    """`python -m s3od_torch.datagen.generate_train_images --config Y` with
    `backend: diffusion`, every weight from `.npz` fixtures (a tiny MMDiT
    with 4 taps, tiny T5/CLIP, an 8x VAE, a tiny teacher), at one 128 x 96
    bucket and 2 steps, against the JAX orchestrator driven with the same
    weights: the backend's image, features and concept maps, and the mask
    written to disk."""
    from s3od_tpu.datagen import generate_train_images as jg
    from s3od_tpu.datagen.mask_generator import MaskGenerator as JMask
    from s3od_torch.datagen import generate_train_images as tg
    from PIL import Image

    files, jax_objs = _factory_fixtures(tmp_path)
    classes = tmp_path / "classes.json"
    classes.write_text(json.dumps(["tabby cat"]))
    for mod in (jg, tg):
        monkeypatch.setattr(mod, "GENERATION_RESOLUTIONS", [(128, 96)])
    monkeypatch.setattr(td, "initial_noise", _jax_noise)
    base = dict(class_list=str(classes), prompts_per_class=1,
                num_inference_steps=2, seed=5, backend="diffusion")

    # The JAX orchestrator, driven in-process (its from_config builds the
    # full-size config and transformers' encoders).
    backend = _jax_pipeline(jax_objs, 2)
    rec = {}
    real_gen = backend.generate
    backend.generate = lambda *a: rec.setdefault("jax", real_gen(*a))
    jcfg_run = jg.GenerationConfig(output_dir=str(tmp_path / "jax"),
                                   prompts_dir=str(tmp_path / "jp"), **base)
    assert jg.ImageMaskGenerationPipeline(jcfg_run, backend,
                                          JMask(files["teacher"])).run() == 1

    # The port's CLI.
    real_make = tg.make_backend

    def make(cfg):
        b = real_make(cfg)
        gen = b.generate
        b.generate = lambda *a: rec.setdefault("port", gen(*a))
        return b

    monkeypatch.setattr(tg, "make_backend", make)
    conf = dict(base, output_dir=str(tmp_path / "port"),
                prompts_dir=str(tmp_path / "tp"), device="cpu",
                flux_checkpoint=files["flux"], vae_checkpoint=files["vae"],
                t5_checkpoint=files["t5"], clip_checkpoint=files["clip"],
                teacher_checkpoint=files["teacher"])
    (tmp_path / "gen.yaml").write_text(yaml.safe_dump(conf))
    assert tg.main(["--config", str(tmp_path / "gen.yaml")]) == 1

    (img, feats, cmaps), (img_r, feats_r, cmaps_r) = rec["port"], rec["jax"]
    assert img.shape == img_r.shape == (96, 128, 3)
    assert np.abs(img.astype(int) - img_r.astype(int)).max() <= 1
    assert len(feats) == 4 and feats[0].shape == (48, 24)
    for g, r in zip(feats, feats_r):
        assert _rel(g, np.asarray(r, np.float32)) < 1e-4
    for k in ("category", "background"):
        assert cmaps[k].shape == (6, 8)
        assert np.abs(cmaps[k] - cmaps_r[k]).max() < 1e-4
    stem = "tabby_cat_0000"
    mask = np.array(Image.open(tmp_path / "port" / "masks" / f"{stem}.png"))
    mask_r = np.array(Image.open(tmp_path / "jax" / "masks" / f"{stem}.png"))
    assert mask.shape == mask_r.shape == (96, 128)
    assert np.abs(mask.astype(int) - mask_r.astype(int)).max() <= 1
    assert (tmp_path / "port" / "images" / f"{stem}.jpg").exists()


def test_mmdit_npz_roundtrip_through_both_loaders(tmp_path):
    """The port's `save_factory_npz` writes what the JAX loader reads (and
    the configuration beside it); `load_mmdit` reads it back exactly."""
    from s3od_tpu.convert import load_native
    from s3od_torch.convert import load_mmdit
    from s3od_torch.models.mmdit import init_mmdit, tiny_mmdit_config

    cfg = tiny_mmdit_config()
    m = init_mmdit(cfg, torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.npz")
    save_factory_npz(path, m, cfg)
    tree, meta = load_native(path)
    assert tree["dual_blocks"][1]["img_attn"]["qkv"]["kernel"].shape == (96, 288)
    back = load_mmdit(path)
    assert back.cfg == cfg
    assert all(torch.equal(a, b) for a, b in
               zip(back.state_dict().values(), m.state_dict().values()))
