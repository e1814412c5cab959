"""The training path's augmentation half of s3od_torch against the JAX
package on the CPU: the loader's host draws and the device sampling of
them against the JAX loader's cv2 warps; the remat policies; the memmap
cache read across packages; HF DINOv3 encoder init; the image logger;
the transforms facade; and the entry point with every override that this
part of the port added.

Tolerances. The host geometry: cv2's uint8 resamplers use fixed-point
weights (1/32 of a pixel for remap and warps, 11-bit weights for resize)
and round, the port samples in float32 and rounds once, so images may
differ by one grey level. Measured on this test's data (64^2, 48 samples
a mode, every distortion kind drawn): at most 1 level anywhere; a mean of
0.1274 (regular) and 0.1316 (synthetic) levels on samples that were
cropped (the resize's weights), 3.3e-4 and 5.7e-4 on the rest; no mask
pixel different. Bounds, 1.5x those: means 0.2 and 8.6e-4, max 1.5
levels, masks equal. Remat: gradients equal to no-remat within float32
rounding of sums in another order (1e-6 of the largest magnitude; they
are equal bit for bit on these inputs) and to JAX within 1e-4 relative.
"""

import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.ops.warp import apply_host_geometry
from s3od_torch.training import data as TD

S = 64


def _write_dataset(root: Path, n: int, size: int = S, seed: int = 0,
                   name: str = "tinyds") -> Path:
    """PNG pairs of several aspect ratios (letterbox padding on some)."""
    from PIL import Image

    ds = root / name
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (size, size) if i % 3 else (size, size * 3 // 4)
        img = (np.cumsum(rng.integers(-9, 10, (h, w, 3)), axis=1) % 256
               ).astype(np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2 * 0.7) <= (h / 4) ** 2
                ).astype(np.uint8) * 255
        Image.fromarray(img).save(ds / "images" / f"s{i:03d}.png")
        Image.fromarray(mask).save(ds / "masks" / f"s{i:03d}.png")
    return ds


# ----------------------------------------------------------------------------
# The loader's host half
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loader_ds(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("loader"), 48)


@pytest.mark.parametrize("mode", ["regular", "synthetic"])
def test_host_draws_equal_the_jax_loaders(mode):
    """The same `random.Random` calls in the same order: after every
    sample's crop and geometry the two generators are in the same state,
    so each drew the same values (the elastic and perspective noise come
    from `getrandbits`, numpy-seeded alike)."""
    from s3od_tpu.training import data as JD

    img = np.zeros((S, S, 3), np.uint8)
    mask = np.zeros((S, S), np.float32)
    kinds = set()
    for seed in range(200):
        rj, rp = random.Random(seed), random.Random(seed)
        if rj.random() < 0.5:
            JD._random_resized_crop(img, mask, rj)
        if rp.random() < 0.5:
            TD.draw_random_resized_crop(rp, S)
        JD.host_geometric(img, mask, rj, mode)
        geo = TD.draw_host_geometry(rp, S, S, mode)
        assert rj.getstate() == rp.getstate(), seed
        kinds.add(geo["distort"][0] if geo["distort"] else None)
    want = {None} if mode == "regular" else {
        None, "optical", "grid", "elastic", "perspective"}
    assert kinds == want


@pytest.mark.parametrize("mode", ["regular", "synthetic"])
def test_host_geometry_matches_the_jax_loaders_cv2_warps(loader_ds, mode):
    """Both loaders over the same dataset and seed: the port's uint8 batch
    with its drawn geometry, sampled by `apply_host_geometry`, against
    the JAX loader's cv2 output."""
    from s3od_tpu.training import data as JD

    def batches(mod):
        ds = mod.MaskFolderDataset(str(loader_ds), S, "train", 0.0, 42)
        return list(mod.PrefetchLoader(
            ds, 8, shuffle=True, seed=3, num_threads=2,
            random_resized_crop_p=0.5, geometric_mode=mode).epoch(1))

    seen = set()
    worst = {"crop_mean": 0.0, "mean": 0.0, "max": 0.0, "mask": 0.0}
    for jb, tb in zip(batches(JD), batches(TD), strict=True):
        img, m = apply_host_geometry(
            torch.from_numpy(tb["images"]),
            torch.from_numpy(np.round(tb["masks"] * 255).astype(np.uint8)),
            tb["geometry"])
        for i, geo in enumerate(tb["geometry"]):
            d = np.abs(img[i].numpy().astype(np.float64) - jb["images"][i])
            key = "crop_mean" if "crop" in geo else "mean"
            worst[key] = max(worst[key], d.mean())
            worst["max"] = max(worst["max"], d.max())
            worst["mask"] = max(worst["mask"], float(
                (m[i].numpy() != np.round(jb["masks"][i] * 255)).mean()))
            seen.add(geo["distort"][0] if geo["distort"] else None)
            seen.add("crop" if "crop" in geo else "nocrop")
            seen.add("rot" if geo["angle"] is not None else "norot")
    print(json.dumps({mode: worst}))
    assert worst["crop_mean"] <= 0.2 and worst["mean"] <= 8.6e-4, worst
    assert worst["max"] <= 1.5 and worst["mask"] == 0.0, worst
    want = {"crop", "nocrop", "rot", "norot", None}
    if mode == "synthetic":
        want |= {"optical", "grid", "elastic", "perspective"}
    assert seen == want, seen


def test_augmentation_modules_import_no_cv2_and_no_jax():
    code = (
        "import sys, random\n"
        "import numpy as np, torch\n"
        "import s3od_torch.ops.warp, s3od_torch.ops.augment\n"
        "import s3od_torch.training.transforms, s3od_torch.training.cache\n"
        "import s3od_torch.training.image_logger\n"
        "from s3od_torch.training import data\n"
        "from s3od_torch.ops.augment import augment_batch\n"
        "from s3od_torch.ops.warp import apply_host_geometry\n"
        "geo = []\n"
        "for s in range(40):\n"
        "    r = random.Random(s)\n"
        "    g = {'crop': data.draw_random_resized_crop(r, 32)}\n"
        "    g.update(data.draw_host_geometry(r, 32, 32, 'synthetic'))\n"
        "    geo.append(g)\n"
        "x = torch.zeros(40, 32, 32, 3, dtype=torch.uint8)\n"
        "m = torch.zeros(40, 32, 32, dtype=torch.uint8)\n"
        "x, m = apply_host_geometry(x, m, geo)\n"
        "augment_batch(x, m.float(), 'synthetic', torch.Generator())\n"
        "print(sorted(k for k in ('cv2', 'jax', 's3od_tpu') if k in sys.modules))\n"
    )
    import subprocess

    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]


def test_transforms_facade_runs_each_mode():
    from s3od_torch.training.transforms import get_transforms

    img = np.random.default_rng(0).integers(0, 255, (40, 56, 3), np.uint8)
    mask = (np.random.default_rng(1).random((40, 56)) > 0.5).astype(np.uint8) * 255
    np.random.seed(0)
    for mode in ("test", "regular", "synthetic"):
        out = get_transforms(S, mode)(image=img, mask=mask)
        assert out["image"].shape == (S, S, 3) and out["mask"].shape == (S, S)
        assert np.isfinite(out["image"]).all()
        assert set(np.unique(out["mask"])) <= {0.0, 1.0}
    with pytest.raises(ValueError):
        get_transforms(S, "bogus")


# ----------------------------------------------------------------------------
# Remat policies
# ----------------------------------------------------------------------------


def _tiny_pair():
    from s3od_torch.convert import state_dict_from_jax
    from s3od_torch.models.segmentation import S3ODSegmentation
    from s3od_tpu.configs import tiny_test_config
    from s3od_tpu.models.segmentation import init_segmentation_params

    cfg = tiny_test_config()
    params, state = init_segmentation_params(jax.random.key(4), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    c = cfg.encoder.hidden_size
    for blk in params["encoder"]["blocks"]:
        blk["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return cfg, params, model


class _MatmulCount:
    """aten mm / addmm / bmm executions while it is entered."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)
        owner = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                owner.n += func in ops
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


@pytest.mark.parametrize("route", ["kernel", "exact"])
def test_remat_policies_keep_the_gradients_and_skip_the_recompute(
        route, monkeypatch):
    """Gradients under none / flash / dots_flash equal no-remat; the
    plain attention (K3's plain version on the CPU) runs 2x blocks times
    a step under none and 1x under flash and dots_flash on the kernel
    route; on the exact route dots_flash recomputes no matrix product
    (qkv, two attention products per image, o_proj, up, down a block)."""
    from s3od_torch.ops import flash_attention as fa

    cfg, _, model = _tiny_pair()
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, S, S, 3)).astype(np.float32))
    blocks = max(cfg.tap_layers)
    grads, counts, mms = {}, {}, {}
    for pol in ("noremat", "none", "flash", "dots_flash"):
        model.zero_grad()
        calls.clear()
        outs = model.encoder(x, cfg.tap_layers, route, remat=pol != "noremat",
                             remat_policy=None if pol == "noremat" else pol)
        loss = sum(torch.sin(o).sum() for o in outs)
        with _MatmulCount() as mm:
            loss.backward()
        grads[pol] = {k: p.grad.clone() for k, p in
                      model.encoder.named_parameters() if p.grad is not None}
        counts[pol], mms[pol] = len(calls), mm.n
    for pol in ("none", "flash", "dots_flash"):
        for k, g in grads["noremat"].items():
            assert torch.allclose(grads[pol][k], g, rtol=0,
                                  atol=1e-6 * float(g.abs().max())), (pol, k)
    if route == "kernel":
        assert counts == {"noremat": blocks, "none": 2 * blocks,
                          "flash": blocks, "dots_flash": blocks}
    else:
        assert mms["none"] - mms["dots_flash"] == blocks * (4 + 2 * 2)
        assert mms["flash"] == mms["none"]


@pytest.mark.parametrize("policy", ["flash", "dots_flash"])
def test_remat_policy_gradients_match_jax(policy, monkeypatch):
    """The kernel route under each policy against JAX's fused route
    (interpret mode) under the same policy, per-block remat on both."""
    from s3od_tpu.models import dinov3
    from s3od_tpu.models.dinov3 import encoder_forward

    cfg, params, model = _tiny_pair()
    monkeypatch.setattr(dinov3, "_QKV_FUSED_INTERPRET", True)
    monkeypatch.setattr("s3od_tpu.ops.attention.resolve_attn_impl",
                        lambda n, dtype, impl="auto": "flash")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    taps = cfg.tap_layers

    def jloss(enc):
        outs = encoder_forward(enc, jnp.asarray(x), cfg.encoder, taps,
                               attn_impl="flash", remat=True,
                               remat_policy=policy)
        return sum(jnp.sum(jnp.sin(o)) for o in outs)

    jg = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params["encoder"]))
    outs = model.encoder(torch.from_numpy(x), taps, "kernel", remat=True,
                         remat_policy=policy)
    sum(torch.sin(o).sum() for o in outs).backward()
    c = cfg.encoder.hidden_size
    for i, blk in enumerate(jg["blocks"]):
        layer = model.encoder.layer[i]
        for got, ref in ((layer.attention.qkv.weight.grad,
                          np.asarray(blk["attention"]["qkv"]["kernel"]).T),
                         (layer.mlp.up_proj.weight.grad,
                          np.asarray(blk["mlp"]["up_proj"]["kernel"]).T),
                         (layer.norm1.weight.grad,
                          np.asarray(blk["norm1"]["weight"]))):
            if i >= max(taps):
                continue
            err = np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
            assert err < 1e-4, (i, err)


# ----------------------------------------------------------------------------
# Cache, HF init, image logger
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    from s3od_tpu.training import cache as JC
    from s3od_torch.training import cache as TC

    ds = _write_dataset(tmp_path, 10)
    first, second = (JC, TC) if writer == "jax" else (TC, JC)
    a = first.CachedMaskFolderDataset(str(ds), S, "train", 0.2, 42)
    stamp = (ds / ".s3od_cache" / f"s{S}" / "images.npy").stat().st_mtime_ns
    b = second.CachedMaskFolderDataset(str(ds), S, "train", 0.2, 42)
    # the second package found the first one's cache valid: no rebuild
    assert (ds / ".s3od_cache" / f"s{S}" / "images.npy").stat().st_mtime_ns == stamp
    assert a.files == b.files and len(a) == 8
    plain = TD.MaskFolderDataset(str(ds), S, "train", 0.2, 42)
    for i in range(len(a)):
        ia, ma = a.load(i)
        ib, mb = b.load(i)
        ip, mp = plain.load(i)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)
        assert ma.dtype == np.uint8
        np.testing.assert_array_equal(ia, ip)
        np.testing.assert_array_equal(ma, np.round(mp * 255).astype(np.uint8))


def test_build_dataset_cache_and_the_loader_ship_uint8_masks(tmp_path):
    ds = _write_dataset(tmp_path, 10)
    built = TD.build_dataset([str(ds)], S, "train", 0.2, 42, cache=True)
    (batch,) = list(TD.PrefetchLoader(built, 8, num_threads=1).epoch(0))
    assert batch["masks"].dtype == np.uint8 and "geometry" not in batch


def _hf_state_dict(seed=8):
    """An HF-layout DINOv3 state dict (the `encoder.*` subtree without the
    prefix, with the keys the converters do not read) from a tiny JAX
    encoder."""
    from s3od_tpu.configs import tiny_test_config
    from s3od_tpu.convert import export_torch_state_dict
    from s3od_tpu.models.segmentation import init_segmentation_params

    cfg = tiny_test_config()
    params, state = init_segmentation_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    c = cfg.encoder.hidden_size
    for blk in params["encoder"]["blocks"]:
        blk["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    sd = export_torch_state_dict(params, state)
    hf = {k[len("encoder."):]: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in sd.items() if k.startswith("encoder.")}
    hf["norm.weight"] = torch.full((c,), 2.0)
    hf["layer.0.attention.k_proj.bias"] = torch.zeros(c)
    return cfg, hf


@pytest.mark.parametrize("fmt", ["dir", "safetensors", "bin"])
def test_load_hf_dinov3_matches_jax(tmp_path, fmt):
    from s3od_tpu.convert import load_hf_dinov3 as jload
    from s3od_torch.convert import convert_encoder, load_hf_encoder_
    from s3od_torch.models.segmentation import S3ODSegmentation

    cfg, hf = _hf_state_dict()
    if fmt == "safetensors":
        from safetensors.torch import save_file

        path = tmp_path / "m.safetensors"
        save_file(hf, str(path))
    else:
        path = tmp_path / "pytorch_model.bin"
        torch.save(hf, path)
        if fmt == "dir":
            path = tmp_path
    ref = jload(str(path))
    model = S3ODSegmentation(cfg)
    load_hf_encoder_(model.encoder, str(path))
    got = convert_encoder({f"encoder.{k}": v for k, v in
                           model.encoder.state_dict().items()}, cfg)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_r) == len(flat_g)
    for path_, leaf in flat_r:
        np.testing.assert_array_equal(np.asarray(flat_g[path_]),
                                      np.asarray(leaf))


def test_load_hf_dinov3_refuses_hub_ids_and_foreign_checkpoints(tmp_path):
    from s3od_torch.convert import load_hf_dinov3, load_hf_encoder_
    from s3od_torch.models.segmentation import S3ODSegmentation

    with pytest.raises(FileNotFoundError, match="no network"):
        load_hf_dinov3("facebook/dinov3-vitb16-pretrain-lvd1689m")
    cfg, hf = _hf_state_dict()
    hf.pop("layer.1.mlp.up_proj.weight")
    torch.save(hf, tmp_path / "x.bin")
    with pytest.raises(KeyError, match="up_proj"):
        load_hf_encoder_(S3ODSegmentation(cfg).encoder, str(tmp_path / "x.bin"))
    cfg, hf = _hf_state_dict()
    hf["layer.0.attention.k_proj.bias"] += 1.0
    torch.save(hf, tmp_path / "y.bin")
    with pytest.raises(ValueError, match="key bias"):
        load_hf_encoder_(S3ODSegmentation(cfg).encoder, str(tmp_path / "y.bin"))


def test_image_logger_panels_match_jax():
    from s3od_tpu.training import image_logger as JL
    from s3od_torch.training import image_logger as TL

    rng = np.random.default_rng(9)
    args = (rng.standard_normal((3, 16, 16, 3)).astype(np.float32),
            rng.random((3, 3, 16, 16)).astype(np.float32),
            rng.random((3, 3)).astype(np.float32),
            rng.random((3, 16, 16)).astype(np.float32))
    cmaps = {"category": rng.random((4, 4)), "background": rng.random((4, 4))}
    jl, tl = JL.ImageLogger(2), TL.ImageLogger(2)
    jl.maybe_add(*args, concept_maps=cmaps)
    tl.maybe_add(*args, concept_maps=cmaps)
    assert len(tl.panels) == 2
    for p, q in zip(jl.panels, tl.panels):
        np.testing.assert_array_equal(p, q)

    class Writer:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, step, dataformats):
            self.images.append((tag, img.shape, step, dataformats))

    w = Writer()
    tl.flush(w, "val", 3)
    assert [t for t, *_ in w.images] == ["val_images/epoch_3_img_0",
                                         "val_images/epoch_3_img_1"]
    assert not tl.panels


# ----------------------------------------------------------------------------
# The entry point
# ----------------------------------------------------------------------------


def _train_args(root: Path, base: str, *extra):
    return ["dataset=duts", "dataset.paths=[tinyds]", f"dataset.image_size={S}",
            "dataset.train_batch_size=2", "dataset.val_batch_size=1",
            "dataset.val_split=0.25", "dataset.test_datasets=[]",
            "model=tiny", "backend=cpu", "backend.num_threads=2",
            "backend.max_epochs=1", f"data_dir={root}",
            f"base_dir={root / base}", *extra]


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    _write_dataset(root, 12)
    return root


@pytest.mark.parametrize("extra", [
    ["dataset.transform_mode=regular"],
    ["dataset.transform_mode=synthetic", "backend.remat_policy=flash"],
    ["dataset.transform_mode=synthetic", "backend.split_augment=true",
     "backend.accumulate_grad_batches=2", "backend.remat_policy=dots_flash"],
    ["dataset.transform_mode=regular", "dataset.cache=true",
     "train_stage.enable_image_logging=true", "backend.remat_policy=none"],
], ids=["regular", "synthetic-flash", "split-accum-dots_flash",
        "cache-image_logging"])
def test_train_entrypoint_with_each_ported_override(train_root, extra):
    from s3od_torch.training.train import train

    base = "run_" + "_".join(e.split("=")[0].split(".")[-1] for e in extra)
    metrics = train(_train_args(train_root, base, *extra))
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    (run,) = (train_root / base / "checkpoints").iterdir()
    assert (run / "s3od_final.npz").exists()
    logs = list((train_root / base / "logs").iterdir())
    if "train_stage.enable_image_logging=true" in extra:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )

        ea = EventAccumulator(str(logs[0]))
        ea.Reload()
        assert ea.Tags()["images"] == [f"val_images/epoch_0_img_{i}"
                                       for i in range(1)]
        assert (train_root / "tinyds" / ".s3od_cache").is_dir()


def test_train_entrypoint_with_a_pretrained_encoder(train_root):
    """`pretrained_encoder` loads the HF weights into the encoder before
    training: with lr 0 the exported encoder equals them."""
    from s3od_torch.convert import load_checkpoint
    from s3od_torch.training.train import train

    _, hf = _hf_state_dict()
    torch.save(hf, train_root / "hf.bin")
    train(_train_args(train_root, "pre", "dataset.transform_mode=regular",
                      f"pretrained_encoder={train_root / 'hf.bin'}",
                      "optimizer.lr=0.0"))
    (run,) = (train_root / "pre" / "checkpoints").iterdir()
    sd, _ = load_checkpoint(str(run / "s3od_final.npz"))
    for k in ("embeddings.cls_token", "layer.1.mlp.up_proj.weight",
              "layer.0.attention.q_proj.weight"):
        np.testing.assert_allclose(sd["encoder." + k].numpy(), hf[k].numpy(),
                                   rtol=0, atol=1e-7)


def test_train_augmentation_stream_is_a_function_of_seed_epoch_step():
    """Resumed runs augment as continuous ones: the per-step generator
    depends only on (seed, epoch, step) and differs from the RoPE stream."""
    from s3od_torch.training.train import augment_generator, step_generator

    a = augment_generator(42, 3, 5).initial_seed()
    assert a == augment_generator(42, 3, 5).initial_seed()
    assert a != augment_generator(42, 3, 6).initial_seed()
    assert a != augment_generator(42, 4, 5).initial_seed()
    assert a != step_generator(42, 3, 5).initial_seed()


def test_demo_dataset_matches_the_scripts_generator(tmp_path):
    import importlib.util

    from s3od_torch.training import demo_e2e

    spec = importlib.util.spec_from_file_location(
        "make_demo_dataset", Path(__file__).resolve().parent.parent
        / "scripts" / "make_demo_dataset.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        for x, y in zip(demo_e2e.make_sample(a, 48), script.make_sample(b, 48)):
            np.testing.assert_array_equal(x, y)


def test_demo_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    """The demo's mechanics at a CPU size (ViT-S, 32^2, 20 images, one
    epoch): data, training through the entry point, export, reload through
    BackgroundRemoval, the evaluation; the gate is reported (a model this
    small and short-trained is not expected to pass it)."""
    from s3od_torch.training import demo_e2e

    summary = demo_e2e.run(demo_e2e.parse_args([
        "--cpu", "--root", str(tmp_path), "--n-images", "20", "--epochs", "1",
        "--image-size", "32", "--data-size", "32", "--model", "dinos",
        "--batch-size", "2"]))
    assert set(summary) >= {"ok", "val_dice", "holdout_iou", "eval"}
    assert 0.0 <= summary["holdout_iou"] <= 1.0
    assert "demo" in summary["eval"]
    assert "DEMO" in capsys.readouterr().out
    assert len(list((tmp_path / "data" / "demo" / "images").glob("*.png"))) == 20
