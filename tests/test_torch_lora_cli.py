"""s3od_torch's LoRA fine-tuning CLI (`datagen/flux_finetune.py`) and
feature-extraction CLI (`datagen/feature_extraction.py`) against the JAX
package's on the CPU, on tiny `.npz` fixtures that both packages load.

The fine-tuning runs inject the same VAE, text encoders and resizer
(stand-ins that return fixed arrays) into both `run`s, so that only the
MMDiT, the step and the update differ; the port's random draws (A at
init, t and the noise of each step) are replaced with JAX's. Tolerances
(float32): 1e-5 of the tree's norm and 1e-4 of each leaf's max|JAX|
after three AdamW steps (the same math in another summation order, which
AdamW's normalised first steps can carry to a few ulps of the update);
the extracted features and maps, stored in fp16, within one fp16 step of
the largest value (1e-3 of max|JAX|; the fp32 values agree to 1e-4, as
the factory's tests hold them).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from s3od_torch.convert import config_to_meta
from s3od_torch.datagen import diffusion as td
from s3od_torch.datagen import lora as tl


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _tree(t):
    return jax.tree.map(np.array, t)


def _write_dataset(root, names, size=64):
    """`root/data/demo/images/<name>.png` and a captions.json that captions
    all but the last image (which takes the default caption)."""
    from PIL import Image

    images = root / "data" / "demo" / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in names:
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                        ).save(images / f"{name}.png")
    meta = root / "meta" / "demo"
    meta.mkdir(parents=True)
    (meta / "captions.json").write_text(json.dumps(
        [{"image_path": f"{n}.png", "caption": f"a photo of {n}"}
         for n in names[:-1]]))
    (meta / "tags.json").write_text(json.dumps(
        [{"image_path": f"{n}.png", "tag": n} for n in names]))


class StubVAE:
    """8x8 block means of the image as a 4-channel latent grid."""

    def encode(self, image):
        x = np.asarray(image, np.float32) / 127.5 - 1.0
        h, w = x.shape[0] // 8, x.shape[1] // 8
        m = x.reshape(h, 8, w, 8, 3).mean((1, 3))
        return np.concatenate([m, m.mean(-1, keepdims=True)], -1)[None]


class StubText:
    def __init__(self, text_dim, pooled_dim):
        self.dims = text_dim, pooled_dim

    def encode(self, prompts):
        r = np.random.default_rng(sum(map(ord, prompts[0])))
        return (r.standard_normal((1, 6, self.dims[0])).astype(np.float32),
                r.standard_normal((1, self.dims[1])).astype(np.float32))


class StubResizer:
    def resize_image(self, image):
        return image, image.shape[:2]


def _jax_draws(monkeypatch, steps, x0_shape):
    """The port's draws replaced with JAX's: A from key(0)'s 4096 splits in
    order, then t and the noise of step `it` from key(it)."""
    keys = iter(jax.random.split(jax.random.key(0), 4096))
    monkeypatch.setattr(tl, "lora_normal", lambda gen, shape: _t(
        jax.random.normal(next(keys), shape, jnp.float32)))
    t, noise = [], []
    for it in range(steps):
        r1, r2 = jax.random.split(jax.random.key(it))
        t.append(_t(jax.nn.sigmoid(jax.random.normal(r1, (x0_shape[0],)))))
        noise.append(_t(jax.random.normal(r2, x0_shape, jnp.float32)))
    t, noise = iter(t), iter(noise)
    monkeypatch.setattr(tl, "draw_timesteps", lambda gen, b: next(t))
    monkeypatch.setattr(tl, "draw_noise", lambda gen, x0: next(noise))


def test_flux_finetune_cli_matches_jax(tmp_path, monkeypatch):
    """`collect_samples` and `run` of both packages on a 3-image dataset
    (picked by `random.Random(seed)`), rank 2, 3 steps at lr 1e-3 on a
    tiny MMDiT, fp32 compute: the written `.npz` files agree (adapters,
    alpha, rank, pack_order), and each file loads in both packages'
    pipelines, whose merges agree."""
    import s3od_tpu.models.mmdit as jm
    from s3od_tpu.convert import load_native, save_native
    from s3od_tpu.datagen import flux_finetune as jf
    from s3od_tpu.datagen.diffusion import ConceptAttentionPipeline as JPipe
    from s3od_torch.datagen import flux_finetune as tf
    from s3od_torch.models import mmdit as tm

    _write_dataset(tmp_path, ["ball", "cup", "dog"])
    args = (str(tmp_path / "data"), ["demo"], str(tmp_path / "meta"))
    got, ref = tf.collect_samples(*args), jf.collect_samples(*args)
    assert got == ref and [s["caption"] for s in got] == [
        "a photo of ball", "a photo of cup", "a photo of a salient object"]

    jcfg, tcfg = jm.tiny_mmdit_config(), tm.tiny_mmdit_config()
    params = _tree(jm.init_mmdit_params(jax.random.key(0), jcfg))
    flux = str(tmp_path / "mmdit.npz")
    save_native(flux, params, {"config": config_to_meta(tcfg)})
    base = dict(flux_checkpoint=flux, input_dir=args[0], datasets=args[1],
                metadata_dir=args[2], rank=2, steps=3, lr=1e-3, seed=4)
    stubs = dict(_vae=StubVAE(), _text=StubText(tcfg.text_dim, tcfg.pooled_dim),
                 _resizer=StubResizer())
    for name, extra in (("jax", {}), ("port", {"device": "cpu",
                                               "compute_dtype": "float32"})):
        (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(dict(
            base, out_lora=str(tmp_path / f"{name}.npz"), **extra)))

    monkeypatch.setattr(jm, "mmdit_forward", functools.partial(
        jm.mmdit_forward, compute_dtype=jnp.float32))
    jout = jf.run(str(tmp_path / "jax.yaml"), _mmdit_cfg=jcfg, **stubs)
    _jax_draws(monkeypatch, 3, (1, 16, tcfg.in_channels))
    tout = tf.run(str(tmp_path / "port.yaml"), _mmdit_cfg=tcfg, **stubs)

    (jl, jmeta), (pl, pmeta) = load_native(jout), load_native(tout)
    assert jax.tree.structure(pl) == jax.tree.structure(jl)
    leaves = [(np.asarray(g), np.asarray(r)) for g, r in
              zip(jax.tree.leaves(pl), jax.tree.leaves(jl))]
    g = np.concatenate([a.ravel() for a, _ in leaves])
    r = np.concatenate([b.ravel() for _, b in leaves])
    assert np.linalg.norm(g - r) <= 1e-5 * np.linalg.norm(r)
    assert all(_rel(a, b) < 1e-4 for a, b in leaves)
    assert any(np.abs(b).max() > 0 for a, b in leaves[1::2])  # B trained
    for key in ("alpha", "rank", "pack_order"):
        assert np.asarray(pmeta[key]).dtype == np.asarray(jmeta[key]).dtype
        assert np.asarray(pmeta[key]).tobytes() == np.asarray(jmeta[key]).tobytes()

    # each file loads in both packages' pipelines, whose merges agree
    from s3od_torch.convert import tree_to_state_dict

    model = tm.MMDiT(tcfg)
    model.load_state_dict(tree_to_state_dict(params), strict=True)
    for out in (jout, tout):
        jpipe = JPipe(params, jcfg, text_encoders=None, lora=out)
        tpipe = td.ConceptAttentionPipeline(model, text_encoders=None,
                                            device="cpu", lora=out)
        assert len(tpipe.merged) == 4 * tcfg.num_dual_blocks + 2 * tcfg.num_single_blocks
        for name, w in tpipe.merged.items():
            node = jpipe.params
            for p in name.split(".")[:-1]:
                node = node[int(p)] if p.isdigit() else node[p]
            assert _rel(w.numpy(), np.asarray(node["kernel"]).T) < 1e-6, name


# ----------------------------------------------------------------------------
# Feature extraction
# ----------------------------------------------------------------------------


def test_load_metadata_matches_jax(tmp_path):
    """captions.json, tags.json and a sharded run's per-task files, merged
    by image stem, as the JAX loader merges them."""
    from s3od_tpu.datagen.feature_extraction import load_metadata as jload
    from s3od_torch.datagen.feature_extraction import load_metadata

    _write_dataset(tmp_path, ["ball", "cup"])
    (tmp_path / "meta" / "demo" / "captions.task0001.json").write_text(
        json.dumps([{"image_path": "x/egg.jpg", "caption": "an egg"}]))
    got = load_metadata(str(tmp_path / "meta"), "demo")
    assert got == jload(str(tmp_path / "meta"), "demo")
    assert got["egg"] == {"caption": "an egg"}
    assert got["ball"] == {"caption": "a photo of ball", "tag": "ball"}
    assert load_metadata(str(tmp_path / "meta"), "none") == {}


VAE8 = dict(latent_channels=4, base_channels=8, channel_mults=(1, 1, 1, 1),
            layers_per_block=1, groups=4)


def test_feature_extraction_cli_matches_jax(tmp_path, monkeypatch):
    """`python -m s3od_torch.datagen.feature_extraction --config Y` on a
    2-image dataset at one 96 x 128 bucket, every weight from `.npz`
    fixtures (a tiny MMDiT with 4 taps, tiny T5/CLIP, an 8x VAE), against
    the JAX `FluxFeatureExtractor` and `FeatureStorage` driven with the
    same weights (the JAX CLI builds the full-size configuration and
    transformers' encoders): the fp16 `.npz` per image, layer_0..3 and
    both maps; a second run skips what exists."""
    from s3od_tpu.convert import save_native
    from s3od_tpu.datagen import feature_extraction as jfe
    from s3od_tpu.datagen import resizer as jr
    from s3od_tpu.datagen.diffusion import ConceptAttentionPipeline as JPipe
    from s3od_tpu.datagen.text_encoding import JaxTextEncoders
    from s3od_tpu.models import mmdit as jm
    from s3od_tpu.models import text_encoders as jt
    from s3od_tpu.models import vae as jv
    from s3od_torch.datagen import feature_extraction as tfe
    from s3od_torch.datagen import resizer as tr
    from s3od_torch.models import mmdit as tm
    from s3od_torch.models import text_encoders as tt
    from s3od_torch.models import vae as tv

    _write_dataset(tmp_path, ["ball", "cup"], size=80)
    for mod in (jr, tr):
        monkeypatch.setattr(mod, "RESOLUTION_BUCKETS", [(96, 128)])
    monkeypatch.setattr(td, "initial_noise", lambda seed, shape, device: _t(
        jax.random.normal(jax.random.key(seed), tuple(shape), jnp.float32)))
    taps = dict(feature_taps=(0, 1, 2, 3))
    jcfg = dataclasses.replace(jm.tiny_mmdit_config(), **taps)
    tcfg = dataclasses.replace(tm.tiny_mmdit_config(), **taps)
    t5 = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=96, num_layers=2,
              num_heads=4)
    clip = dict(vocab_size=400, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=2)
    mm = _tree(jm.init_mmdit_params(jax.random.key(0), jcfg))
    t5p = _tree(jt.init_t5_params(jax.random.key(1), jt.T5Config(**t5)))
    clp = _tree(jt.init_clip_text_params(jax.random.key(2),
                                         jt.CLIPTextConfig(**clip)))
    enc, dec = _tree(jv.init_vae_params(jax.random.key(3), jv.VAEConfig(**VAE8)))
    files = {n: str(tmp_path / f"{n}.npz") for n in ("flux", "t5", "clip", "vae")}
    save_native(files["flux"], mm, {"config": config_to_meta(tcfg)})
    save_native(files["t5"], t5p, {"config": config_to_meta(tt.T5Config(**t5))})
    save_native(files["clip"], clp,
                {"config": config_to_meta(tt.CLIPTextConfig(**clip))})
    save_native(files["vae"], {"enc": enc, "dec": dec},
                {"config": config_to_meta(tv.VAEConfig(**VAE8))})

    conf = dict(input_dir=str(tmp_path / "data"), datasets=["demo"],
                metadata_dir=str(tmp_path / "meta"), device="cpu",
                output_dir=str(tmp_path / "port"), flux_checkpoint=files["flux"],
                vae_checkpoint=files["vae"], t5_checkpoint=files["t5"],
                clip_checkpoint=files["clip"], num_inference_steps=4)
    (tmp_path / "ext.yaml").write_text(yaml.safe_dump(conf))
    assert tfe.main(["--config", str(tmp_path / "ext.yaml")]) == 2
    assert tfe.main(["--config", str(tmp_path / "ext.yaml")]) == 0

    vae = jv.VAE(enc, dec, jv.VAEConfig(**VAE8), dtype=jnp.float32)
    jpipe = JPipe(mm, jcfg, num_inference_steps=4, compute_dtype="float32",
                  vae=vae, text_encoders=JaxTextEncoders(
                      t5p, clp, jt.T5Config(**t5), jt.CLIPTextConfig(**clip),
                      compute_dtype="float32"))
    extractor = jfe.FluxFeatureExtractor(jpipe, vae)
    storage = jfe.FeatureStorage(str(tmp_path / "jax"))
    meta = jfe.load_metadata(conf["metadata_dir"], "demo")
    from PIL import Image

    for stem in ("ball", "cup"):
        image = np.array(Image.open(tmp_path / "data" / "demo" / "images"
                                    / f"{stem}.png").convert("RGB"))
        m = meta[stem]
        storage.save(f"demo_{stem}", *extractor.extract(
            image, m.get("caption", "a photo of a salient object"), m["tag"]))
        with np.load(tmp_path / "port" / "features" / f"demo_{stem}.npz") as got, \
                np.load(storage.path(f"demo_{stem}")) as ref:
            assert sorted(got.files) == sorted(ref.files) == sorted(
                [f"layer_{i}" for i in range(4)] + ["category", "background"])
            for k in ref.files:
                assert got[k].dtype == np.float16 and got[k].shape == ref[k].shape
                assert _rel(got[k], ref[k]) < 1e-3, k
