"""FLUX-teacher training in s3od_torch against the JAX package on the CPU:

(a) `FluxFeatureDataset` on `tests/test_teacher_training.py`'s layout:
    the same kept files, buckets and arrays, and the same collated batch;
(b) one teacher train step (tiny config, concept maps, a non-square patch
    grid) against `make_train_step(forward_fn=flux_teacher_forward)` on
    weights carried across by `convert`: loss and its parts within 1e-5
    relative, parameters after one SGD step within 1e-4 absolute, the BN
    running statistics within 1e-5 relative (the bounds of
    `tests/test_train_entrypoint.py:153-158` and
    `tests/test_torch_training.py`);
(c) the optimizer's groups for the teacher (fusion levels at the head's
    lr, the dead final encoder block decayed);
(d) the CLI (`config_name=train_teacher`) for one epoch, its checkpoint
    and export loading back through `convert.load_teacher`.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp


def _write_flux_dataset(tmp: Path, n: int = 6, size=(96, 128), flux_dim=16,
                        prefixed=()):
    """`n` random image/mask pairs; features for all but the last, at the
    bucket of `size` ((96, 128) -> (896, 1152)); the stems in `prefixed`
    keyed `DUTS-TR_<stem>` (the prefix fallback)."""
    root = tmp / "DS"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    feats = tmp / "features" / "features"
    feats.mkdir(parents=True)
    rng = np.random.default_rng(0)
    h, w = size
    from s3od_torch.datagen.resizer import select_bucket

    bh, bw = select_bucket(h, w)
    ph, pw = bh // 16, bw // 16
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(root / "images" / f"s{i}.jpg")
        Image.fromarray((rng.random((h, w)) > 0.5).astype(np.uint8) * 255
                        ).save(root / "masks" / f"s{i}.png")
        if i == n - 1:
            continue  # no features: dropped
        key = f"DUTS-TR_s{i}" if f"s{i}" in prefixed else f"s{i}"
        np.savez(feats / f"{key}.npz",
                 **{f"layer_{l}": rng.standard_normal(
                     (ph * pw, flux_dim)).astype(np.float16)
                    for l in range(4)},
                 category=rng.random((ph, pw)).astype(np.float16),
                 background=rng.random((ph, pw)).astype(np.float16))
    return root, tmp / "features"


# ----------------------------------------------------------------------------
# (a) the dataset and the collation
# ----------------------------------------------------------------------------


def test_feature_dataset_and_collation_match_jax(tmp_path):
    from s3od_tpu.training.data import FluxFeatureDataset as JDS
    from s3od_tpu.training.data import PrefetchLoader as JLoader
    from s3od_torch.training.data import (
        FluxFeatureDataset,
        PrefetchLoader,
        build_dataset,
    )

    root, fdir = _write_flux_dataset(tmp_path, prefixed=("s1",))
    for split in ("train", "val"):
        ref = JDS(str(root), 1024, split=split, val_split=0.34,
                  flux_features_dir=str(fdir))
        got = FluxFeatureDataset(str(root), 1024, split=split, val_split=0.34,
                                 flux_features_dir=str(fdir))
        assert got.files == ref.files and len(got) > 0
        assert got.feature_mapping == ref.feature_mapping
        for i in range(len(got)):
            a, b = got.load(i), ref.load(i)
            assert a["images"].shape == b["images"].shape == (896, 1152, 3)
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["masks"], b["masks"])
            for x, y in zip(a["transformer_features"],
                            b["transformer_features"]):
                np.testing.assert_array_equal(x, y)
            for k in ("category", "background"):
                np.testing.assert_array_equal(a["concept_maps"][k],
                                              b["concept_maps"][k])
    # s5 has no features; the prefixed s1 is found
    ds = build_dataset([str(root)], 1024, "train", 0.0,
                       flux_features_dir=str(fdir))
    assert isinstance(ds, FluxFeatureDataset)
    assert sorted(ds.files) == [f"s{i}.jpg" for i in range(5)]
    assert ds.feature_mapping["s1.jpg"].name == "DUTS-TR_s1.npz"

    ref = JDS(str(root), 1024, split="train", val_split=0.0,
              flux_features_dir=str(fdir))
    b_ref = next(iter(JLoader(ref, 1, shuffle=True, drop_last=True,
                              seed=3).epoch(1)))
    b_got = next(iter(PrefetchLoader(ds, 1, shuffle=True, drop_last=True,
                                     seed=3).epoch(1)))
    assert set(b_got) == set(b_ref) == {"images", "masks",
                                        "transformer_features",
                                        "concept_maps"}
    np.testing.assert_array_equal(b_got["images"], b_ref["images"])
    assert b_got["masks"].dtype == b_ref["masks"].dtype == np.float32
    np.testing.assert_array_equal(b_got["masks"], b_ref["masks"])
    for x, y in zip(b_got["transformer_features"],
                    b_ref["transformer_features"]):
        assert x.shape == y.shape == (1, 56 * 72, 16)
        np.testing.assert_array_equal(x, y)
    for k in ("category", "background"):
        np.testing.assert_array_equal(b_got["concept_maps"][k],
                                      b_ref["concept_maps"][k])


# ----------------------------------------------------------------------------
# (b) one train step against the JAX step
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


def _teacher(flux_dim=24, seed=0):
    """The JAX teacher's init with noise on every leaf (BN statistics off
    their identity values), the fused key-bias segment at zero; the same
    weights in the port's `FluxTeacher`."""
    from s3od_tpu.configs import tiny_test_config
    from s3od_tpu.models.flux_teacher import (
        FluxTeacherConfig,
        init_flux_teacher_params,
    )
    from s3od_torch.convert import teacher_config, teacher_state_dict_from_jax
    from s3od_torch.models.flux_teacher import FluxTeacher

    base = tiny_test_config()
    base = dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, pos_embed_rescale=2.0))
    cfg = FluxTeacherConfig(base=base, flux_dim=flux_dim)
    params, state = init_flux_teacher_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    noise = lambda a: (np.asarray(a, np.float32) + rng.standard_normal(
        np.shape(a)).astype(np.float32) * 0.05)
    params = jax.tree_util.tree_map(noise, params)
    state = jax.tree_util.tree_map(lambda a: np.abs(noise(a)) + 0.5, state)
    c = base.encoder.hidden_size
    for blk in params["encoder"]["blocks"]:
        blk["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    from s3od_torch.configs import tiny_test_config as port_tiny

    pbase = dataclasses.replace(port_tiny(), encoder=dataclasses.replace(
        port_tiny().encoder, pos_embed_rescale=2.0))
    model = FluxTeacher(teacher_config(params, pbase))
    model.load_state_dict(teacher_state_dict_from_jax(params, state),
                          strict=True)
    return cfg, params, state, model


def _port_sd(params, state, c):
    """A JAX teacher tree -> the port's state dict. The key-bias segment of
    the fused qkv bias is dropped: the reference layout (and the port's
    model) has no key bias, and the JAX SGD step moves it."""
    from s3od_torch.convert import teacher_state_dict_from_jax

    clean = jax.tree_util.tree_map(np.array, params)
    for b in clean["encoder"]["blocks"]:
        b["attention"]["qkv"]["bias"][c: 2 * c] = 0.0
    return {k: v.numpy() for k, v in
            teacher_state_dict_from_jax(clean, state).items()}


def test_teacher_train_step_matches_jax():
    import optax

    from s3od_tpu.models.flux_teacher import flux_teacher_forward
    from s3od_tpu.ops.augment import normalize_imagenet
    from s3od_tpu.training.loss import LOSS_PRESETS as JP
    from s3od_tpu.training.loss import LossModule as JLoss
    from s3od_tpu.training.train_step import (
        TrainState,
        make_eval_step,
        make_train_step,
    )
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import (
        eval_step,
        teacher_forward,
        train_step,
    )

    cfg, params, state, model = _teacher()
    rng = np.random.default_rng(7)
    h, w = 64, 96  # a 4 x 6 patch grid
    batch = {
        "images": rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8),
        "masks": (rng.random((1, h, w)) > 0.6).astype(np.uint8) * 255,
        "transformer_features": [
            rng.standard_normal((1, 24, 24)).astype(np.float32)
            for _ in range(4)],
        "concept_maps": {k: rng.random((1, 4, 6)).astype(np.float32)
                         for k in ("category", "background")},
    }

    def pre(_, b):
        x = b["images"].astype(jnp.float32) / 255.0
        return {**b, "images": normalize_imagenet(x),
                "masks": b["masks"].astype(jnp.float32) / 255.0}

    def fwd(training):
        def fn(p, s, mb, rope_scale):
            return flux_teacher_forward(
                p, s, mb["images"], mb["transformer_features"],
                mb["concept_maps"], cfg, training=training)
        return fn

    lr = 0.1
    step = make_train_step(cfg.base, JLoss(JP["focal_iou"]), optax.sgd(lr),
                           preprocess_fn=pre, forward_fn=fwd(True))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                               jax.tree_util.tree_map(jnp.asarray, state),
                               optax.sgd(lr))
    new_state, ref = step(jstate, jbatch, jnp.asarray(0.0), jax.random.key(0))

    tbatch = jax.tree_util.tree_map(torch.from_numpy, batch)
    out = train_step(model, _SGD(model, lr),
                     LossModule(LOSS_PRESETS["focal_iou"]), tbatch, 0, 0,
                     generator=torch.Generator(), forward=teacher_forward)
    assert out.keys() == ref.keys()
    for k in out:
        assert abs(float(out[k]) - float(ref[k])) <= 1e-5 * max(
            1.0, abs(float(ref[k]))), k

    c = cfg.base.encoder.hidden_size
    want = _port_sd(jax.tree_util.tree_map(np.asarray, new_state.params),
                    jax.tree_util.tree_map(np.asarray, new_state.bn_state), c)
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.detach().numpy()
        if "running_" in k:  # the BN state: batch statistics of H x W
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            moved += int(not np.allclose(v, _port_sd(params, state, c)[k]))
        else:
            assert np.abs(v - want[k]).max() < 1e-4, k
    assert moved > 0  # the running statistics were updated
    assert int(model.fusion[0].vit.bn.num_batches_tracked) == 1

    # the eval step on the new weights (running-statistics BN)
    jeval = make_eval_step(cfg.base, JLoss(JP["focal_iou"]),
                           preprocess_fn=pre, forward_fn=fwd(False))
    ref = jeval(new_state.params, new_state.bn_state, jbatch,
                jnp.asarray(0.0))
    out = eval_step(model, LossModule(LOSS_PRESETS["focal_iou"]), tbatch, 0,
                    forward=teacher_forward)
    for k in out:
        assert abs(float(out[k]) - float(ref[k])) <= 1e-4 * max(
            1.0, abs(float(ref[k]))), k


# ----------------------------------------------------------------------------
# (c) the optimizer's groups
# ----------------------------------------------------------------------------


def test_teacher_optimizer_groups_and_dead_block():
    """The JAX label_fn puts params["head"] (DPT head + fusion levels) at
    head_lr_mult; every block past the last tap gets a zero gradient and
    so only decays, as in optax (ViT-L's block 23, here block 4 of 5)."""
    from s3od_torch.configs import tiny_test_config
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher
    from s3od_torch.training.optim import Optimizer

    base = tiny_test_config(num_layers=5)
    assert base.num_encoder_layers_used == 4
    model = init_flux_teacher(FluxTeacherConfig(base=base, flux_dim=16),
                              torch.Generator().manual_seed(0))
    opt = Optimizer(model, 1e-3, head_lr_mult=10.0, steps_per_epoch=4)
    enc, head = opt.torch_optimizer.param_groups
    fusion = {id(p) for p in model.fusion.parameters()}
    assert fusion <= {id(p) for p in head["params"]}
    assert not fusion & {id(p) for p in enc["params"]}
    assert len(enc["params"]) + len(head["params"]) == len(
        list(model.parameters()))
    lrs = opt.lrs(0)
    assert lrs[1] == pytest.approx(10 * lrs[0])

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((1, 32, 48, 3)).astype(np.float32))
    feats = [torch.randn(1, 6, 16) for _ in range(4)]
    cmaps = {k: torch.rand(1, 2, 3) for k in ("category", "background")}
    dead = model.encoder.layer[4].mlp.up_proj.weight
    before = dead.detach().clone()
    out = model(img, feats, cmaps, training=True)
    opt.zero_grad()
    (out["pred_masks"].mean() + out["pred_iou"].mean()).backward()
    assert dead.grad is None
    opt.step(0)
    # AdamW on a zero gradient: decoupled decay only, p (1 - lr wd)
    torch.testing.assert_close(dead.detach(), before * (1 - 1e-3 * 0.05))


# ----------------------------------------------------------------------------
# (d) the CLI
# ----------------------------------------------------------------------------


def test_teacher_cli_trains_one_epoch_and_exports(tmp_path):
    """`config_name=train_teacher` at a tiny width on two bucket-sized
    samples (896 x 1152): one train step, one validation step, the
    checkpoint and the export, which `load_teacher` reads back."""
    from s3od_torch.convert import (
        load_teacher,
        save_native,
        teacher_tree_from_state_dict,
    )
    from s3od_torch.training.train import train

    _write_flux_dataset(tmp_path, n=3)
    args = ["config_name=train_teacher", "backend=cpu",
            "model.encoder_name=dinov3_tiny", "model.features=32",
            "model.flux_dim=16", "dataset.paths=[DS]",
            "dataset.val_split=0.5", "dataset.test_datasets=[]",
            f"data_dir={tmp_path}", f"base_dir={tmp_path / 'out'}",
            f"flux_features_dir={tmp_path / 'features'}",
            "backend.max_epochs=1", "backend.devices=2"]
    metrics = train(args)
    assert np.isfinite(metrics["train_loss"])
    assert np.isfinite(metrics["val_loss"])
    run = next((tmp_path / "out" / "checkpoints").iterdir())
    teacher = load_teacher(str(run / "s3od_final.npz"))
    assert teacher.cfg.flux_dim == 16 and teacher.cfg.base.features == 32
    from s3od_torch.training.checkpoint import restore_external

    sd = restore_external(str(run / "last"))[0]["model"]
    assert set(sd) == set(teacher.state_dict())
    p, s = teacher_tree_from_state_dict(sd)
    save_native(str(tmp_path / "ckpt.npz"), p, s)
    again = load_teacher(str(tmp_path / "ckpt.npz"))
    for k, v in again.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, teacher.state_dict()[k])
    # one BN update per training step reached the export
    assert float((teacher.fusion[0].vit.bn.running_var - 1).abs().max()) > 0
