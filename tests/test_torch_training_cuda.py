"""On the card: the training path end to end in bf16. `train()` at ViT-B
1024^2 b4 (launch counts, checkpoints, resume, the export served) and the
committed tiny checkpoint fine-tuned through it; `train_step` (launches a
step, the loss falling), its gradients against float32 exact mode and
K8's against its plain version's with a planted K8 fault caught; one
2048^2 step; the Winograd gate in a step; the augmentation on the card
against the CPU; the remat policies; the entry point's options; the
demo's gate. The file imports no JAX: run it on the card with

    python3 chip_smoke.py -k training
"""

import json

import numpy as np
import pytest
import torch

from _cuda import (TINY_1024, cuda, decoder_counts, decoder_gates,  # noqa: F401
                   decoder_rule_counts, fixture_batch, fixture_pair, iou,
                   k8_launches, launch_counts, only_run, reset_counts,
                   seeded_model, standing_in, tf32_restored, train_args,
                   write_fixture_dataset)

pytestmark = pytest.mark.cuda

# Gradient agreement at ViT-B, 1024^2, batch 2. GRAD_TOL: ||g - g_ref|| /
# ||g_ref|| per parameter group and of the training loss, bf16 kernel route
# against fp32 exact mode; 1.5x the largest measured on an H100 80GB HBM3
# at 700 W in five runs: loss 1.444e-5, encoder 4.128e-2, head 7.87e-3
# (with K2's, K4's and K5's backwards written out in bf16 products, two
# runs read loss 1.636e-5 at most, encoder 4.296e-2, head 8.010e-3).
# K8_GRAD_TOL: a loss on the encoder taps, K8 against its plain version as
# the backward of the same forward; "qkv_k_norm" is |norm ratio - 1| of the
# gradient's key rows of the fused qkv weight (the product with K8's dk),
# all blocks' rows taken together. This backward is deterministic (a
# repeat reads exactly 0); measured encoder 5.969e-3, bounds 1.5x. A
# planted dk x 1.01 reads qkv_k_norm 1.046e-2 and is caught; against fp32
# it reads encoder 4.120e-2, inside GRAD_TOL (the bf16 forward's rounding
# hides it there). Held block by block, the key rows move with the
# forward's rounding, not with K8 (one-ulp flips on 0.2% of the plain
# MLP's outputs read 1.05e-3 to 3.38e-3 over eight seeds), while all rows
# together read at most 8.3e-4 there.
GRAD_TOL = {"loss": 2.2e-5, "encoder": 6.2e-2, "head": 1.2e-2}
K8_GRAD_TOL = {"encoder": 9.0e-3, "qkv_k_norm": 1.4e-3}
AUG_TOL = 1e-4  # max|card - CPU| of one stage's output on the same input
# and parameters, values in [0, 1]: float32 sums in another order and
# transcendental functions within an ulp or two
AUG_WARP_TOL = 2.5e-4  # the same for the warps: a source coordinate near
# 1024 px is held to 2^-13 px by float32, and a one- or two-ulp difference
# between the card's and the CPU's sin / cos / solve moves a bilinear sample
# by up to 2 x 1.2e-4 of the step between neighbouring pixels (<= 1)
AUG_ROUNDED_SHARE = 1e-4  # JPEG rounds DCT coefficients: the share of
# values past AUG_TOL (a coefficient flipped by a last-bit difference)
REMAT_K3 = {"none": 2, "flash": 1, "dots_flash": 1}  # K3 per block a step
# The demo's recipe that trains from scratch (the JAX package's recorded
# one, benchmarks/RESULTS.md's 160px runs: at the script's defaults,
# focal_iou from scratch saturates to empty masks on both packages), with
# the script's own regular augmentation and the letterbox cache, cut to 4
# of its 40 epochs (the warmup is 8 epochs either way; val_dice passed 0.5
# from the second epoch). The test holds the gate of
# `train_demo_e2e.py:214` (val_dice and holdout IoU > 0.5).
DEMO_ARGS = ["--model", "dinos", "--image-size", "160", "--epochs", "4",
             "--lr", "1e-4", "--head-lr-mult", "3", "--loss", "bce_iou_ssim",
             "--rank-weight", "1.0", "--cache"]


def _finite(metrics) -> bool:
    return all(np.isfinite(v) for v in metrics.values())


def test_train_entry_on_cuda(cuda, tmp_path):
    """`train()` at ViT-B width, 1024^2, batch 4, bf16: one epoch of 4
    steps and its validation batch with K1-K5 twice a block a step (the
    remat recompute) and K8 once, checkpoints, a resume that trains only
    the new epoch, the export served by BackgroundRemoval; then the tiny
    checkpoint fine-tuned through the same entry point (D = 32) still
    segments the fixture (IoU >= 0.9)."""
    from s3od_torch import BackgroundRemoval
    from s3od_torch.configs import segmentation_config
    from s3od_torch.training.train import train

    write_fixture_dataset(tmp_path)
    blocks = segmentation_config("dinov3_base").num_encoder_layers_used
    steps, val_batches = 16 // 4, 4 // 4
    reset_counts()
    metrics = train(train_args(tmp_path, "a", "backend.max_epochs=1"))
    want = steps * 2 * blocks + val_batches * blocks
    assert launch_counts() == dict.fromkeys(launch_counts(), want)
    assert k8_launches() == steps * blocks
    assert _finite(metrics)
    run = only_run(tmp_path / "a")
    index = json.loads((run / "index.json").read_text())
    assert index["last"]["epoch"] == 0 and (run / "last" / "state.pt").exists()
    assert index["best"] and (run / index["best"][0]["path"]).exists()

    reset_counts()
    train(train_args(tmp_path, "b", "backend.max_epochs=2",
                     f"checkpoint_path={run / 'last'}"))
    run2 = only_run(tmp_path / "b")
    index2 = json.loads((run2 / "index.json").read_text())
    tree = torch.load(run2 / "last" / "state.pt", map_location="cpu",
                      weights_only=False)
    assert k8_launches() == steps * blocks and index2["last"]["epoch"] == 1
    assert [e["epoch"] for e in index2["best"]] == [1] and tree["step"] == 2 * steps

    image, mask = fixture_pair()
    res = BackgroundRemoval(str(run2 / "s3od_final.npz"), image_size=1024,
                            device="cuda").remove_background(image)
    assert res.predicted_mask.shape == image.shape[:2]
    assert np.isfinite(res.all_masks).all()

    reset_counts()
    train(train_args(tmp_path, "tiny", "model=tiny", "backend.max_epochs=1",
                     f"init_checkpoint={TINY_1024}"))
    assert k8_launches() == steps * 4
    pred = BackgroundRemoval(str(only_run(tmp_path / "tiny") / "s3od_final.npz"),
                             image_size=1024, device="cuda")
    assert iou(pred.remove_background(image).predicted_mask, mask > 128) >= 0.9


def test_train_step_on_cuda(cuda):
    """`train_step` at ViT-B, 1024^2, batch 4, bf16 on one repeated batch:
    K1-K5 twice a block a step (forward and remat recompute), K8 and the
    backward passes of K2, K4 and K5 once a block; the loss finite and
    falling over 8 steps."""
    from s3od_torch.ops import attn_epilogue, mlp_fused, qkv_project
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    model = seeded_model(2)
    opt = Optimizer(model, 1e-4, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    batch = fixture_batch(4, 1024)
    blocks = model.cfg.num_encoder_layers_used
    passes = (qkv_project.rope_bwd, attn_epilogue.ln_bwd, mlp_fused.gelu_bwd)
    losses = []
    for i in range(8):
        reset_counts()
        losses.append(float(train_step(
            model, opt, loss_module, batch, 0, i,
            generator=torch.Generator().manual_seed(i),
            compute_dtype=torch.bfloat16)["loss"]))
        if i == 1:
            assert launch_counts() == dict.fromkeys(launch_counts(), 2 * blocks)
            assert k8_launches() == blocks
            assert [fn.launches for fn in passes] == [blocks] * 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_grad_agreement_on_cuda(cuda):
    """Gradients of the bf16 kernel route at ViT-B, 1024^2, batch 2: the
    training loss's against float32 exact mode per parameter group and
    of the loss (GRAD_TOL); a loss on the encoder's taps (no decoder, so
    the backward is deterministic) with K8 against K8's plain version as
    the backward of the same forward (K8_GRAD_TOL). A planted K8 fault (dk
    x 1.01 and x 1.1) must fail the second."""
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import preprocess

    model = seeded_model(3)
    cfg = model.cfg
    blocks, c = cfg.num_encoder_layers_used, cfg.encoder.hidden_size
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    batch = preprocess(fixture_batch(2, 1024))
    bn = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    gen = torch.Generator(device="cuda").manual_seed(5)
    tap_w = [torch.randn(2, 4096, c, generator=gen, device="cuda")
             for _ in cfg.tap_layers]

    def group_grads(module):
        return torch.cat([p.grad.flatten().float() for p in module.parameters()
                          if p.grad is not None])

    def model_grads(dtype):
        model.zero_grad()
        loss, _ = loss_module(model(batch["images"].to(dtype), training=True), batch, 0)
        loss.backward()
        model.load_state_dict(bn, strict=False)  # undo the running-stat step
        return {"loss": loss.detach().reshape(1),
                "encoder": group_grads(model.encoder), "head": group_grads(model.seg_head)}

    def tap_grads():
        model.zero_grad()
        taps = model.encoder(batch["images"].to(torch.bfloat16), cfg.tap_layers,
                             "kernel", remat=True)
        sum((t.float() * w).sum() for t, w in zip(taps, tap_w)).backward()
        return {"encoder": group_grads(model.encoder), "qkv_k": torch.stack([
            blk.attention.qkv.weight.grad[c: 2 * c].float().norm()
            for blk in model.encoder.layer[:blocks]])}

    def rel(got, ref):
        out = {k: float((got[k] - ref[k]).norm() / ref[k].norm())
               for k in ref if k != "qkv_k"}
        if "qkv_k" in ref:
            out["qkv_k_norm"] = abs(float(got["qkv_k"].norm() / ref["qkv_k"].norm()) - 1)
        return out

    def outside(err, tol):
        return [k for k in tol if err[k] > tol[k]]

    def plain_bwd(*args):
        return fa.flash_attention_bwd_plain(*args)

    g32 = model_grads(torch.float32)
    err = rel(model_grads(torch.bfloat16), g32)
    assert not outside(err, GRAD_TOL), err
    t_kernel = tap_grads()
    with standing_in(fa, "flash_attention_bwd", plain_bwd):
        t_plain = tap_grads()
    err_k8 = rel(t_kernel, t_plain)
    assert not outside(err_k8, K8_GRAD_TOL), err_k8
    real = fa.flash_attention_bwd
    for factor in (1.01, 1.1):
        def faulty(*args, _f=factor):
            dq, dk, dv = real(*args)
            return dq, dk * _f, dv
        with standing_in(fa, "flash_attention_bwd", faulty):
            assert outside(rel(tap_grads(), t_plain), K8_GRAD_TOL), factor


def test_highres_train_step_on_cuda(cuda):
    """One `train_step` at 2048^2, batch 1 (config/dataset/dis2048.yaml's
    canvas): K6 forward and K8 at 16448 tokens, K8 once a block; the loss
    and every gradient finite."""
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    model = seeded_model(4)
    opt = Optimizer(model, 1e-5, steps_per_epoch=1)
    reset_counts()
    out = train_step(model, opt, LossModule(LOSS_PRESETS["focal_iou"]),
                     fixture_batch(1, 2048), 0, 0,
                     generator=torch.Generator().manual_seed(0),
                     compute_dtype=torch.bfloat16)
    assert np.isfinite(float(out["loss"]))
    assert all(bool(p.grad.isfinite().all()) for p in model.parameters()
               if p.grad is not None)
    assert k8_launches() == model.cfg.num_encoder_layers_used


def test_decoder_gate_train_step_on_cuda(cuda):
    """One `train_step` at ViT-B 1024^2 b4 bf16 with the Winograd gate on:
    the loss finite; K9a's forward and dx launches as the copied rule
    gives them, no K9b (training keeps the BNs) and no K10."""
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    model = seeded_model(2)
    fwd, dx = decoder_rule_counts(model.cfg, 1024, training=True)
    with decoder_gates(True):
        reset_counts()
        loss = float(train_step(model, Optimizer(model, 1e-4, steps_per_epoch=100),
                                LossModule(LOSS_PRESETS["focal_iou"]),
                                fixture_batch(4, 1024), 0, 0,
                                compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))["loss"])
    assert np.isfinite(loss)
    assert decoder_counts() == {"K9a": fwd + dx, "K9b": 0, "K10": 0}


def _host_geometry(n: int, size: int, mode: str, seed: int):
    """The loader's per-sample geometry for one batch: crop p 0.5, then
    the rotation and (synthetic) distortion draws."""
    from s3od_torch.training.data import PrefetchLoader

    loader = PrefetchLoader([], n, seed=seed, random_resized_crop_p=0.5,
                            geometric_mode=mode)
    return loader.draw_geometry(0, 0, n, size)


def _forced_plan(gen, b, h, w, mode, device):
    """An `augment_batch` plan in which every branch of every stage runs:
    sample i takes branch i mod the stage's branch count; every sample is
    rotated and, in synthetic mode, distorted (optical, grid, elastic,
    perspective in turn)."""
    from s3od_torch.ops import augment as A

    geo = A.draw_geometric_warp(gen, b, h, w, device, mode, p_rotate=1.0,
                                p_distort=1.0)
    if mode == "synthetic":
        geo["distort"] = torch.arange(b, device=device) % 4
    plan = {"mode": mode, "flips": A._to(A.draw_flips(gen, b), device),
            "geometric": geo, "stages": []}
    for name, _, _, ops in A._stages(mode, h % 8 == 0 and w % 8 == 0):
        branch = [i % len(ops) for i in range(b)]
        plan["stages"].append({"name": name, "branch": branch, "params": {
            i: draw(gen, branch.count(i), h, w, device)
            for i, (_, draw) in enumerate(ops)}})
    return plan


def _to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree


@pytest.mark.parametrize("mode", ["regular", "synthetic"])
def test_augment_on_cuda(cuda, mode):
    """The training input pipeline at 1024^2, batch 4 (config/dataset/
    synth.yaml's batch): every stage of a plan that takes every branch,
    run on the card and on the CPU from the same input and parameters
    (AUG_TOL; the warps AUG_WARP_TOL; JPEG by the share of values past
    AUG_TOL), the loader's host geometry within one grey level, the masks
    unchanged by the photometric stages, and `train_pre`'s output."""
    from s3od_torch.ops import augment as A
    from s3od_torch.ops.warp import apply_host_geometry
    from s3od_torch.training.train import train_pre

    batch = fixture_batch(4, 1024)
    images, masks = batch["images"], batch["masks"]
    plan = _forced_plan(torch.Generator().manual_seed(3), 4, 1024, 1024, mode,
                        images.device)
    cpu_plan = _to_device(plan, "cpu")
    x, m = A.random_flips(images.float() / 255.0, masks.float() / 255.0, plan["flips"])
    xg, mg = A.geometric_warp(x, m, plan["geometric"])
    xc, mc = A.geometric_warp(x.cpu(), m.cpu(), cpu_plan["geometric"])
    assert float((xg.cpu() - xc).abs().max()) <= AUG_WARP_TOL
    assert torch.equal(mg.cpu(), mc)
    for (name, _, _, ops), st, cst in zip(A._stages(mode, True), plan["stages"],
                                           cpu_plan["stages"]):
        for i, (op, _) in enumerate(ops):
            inp = xg[[j for j, k in enumerate(st["branch"]) if k == i]]
            d = (op(inp, st["params"][i]).cpu() - op(inp.cpu(), cst["params"][i])).abs()
            key = f"{name}.{op.__name__}"
            if key == "quality.jpeg_compression":
                assert float((d > AUG_TOL).float().mean()) <= AUG_ROUNDED_SHARE
            else:
                assert float(d.max()) <= AUG_TOL, key
    geo = _host_geometry(4, 1024, mode, seed=5)
    hi, hm = apply_host_geometry(images, masks, geo)
    ci, cm = apply_host_geometry(images.cpu(), masks.cpu(), geo)
    assert float((hi.cpu().float() - ci.float()).abs().max()) <= 1.0
    assert torch.equal(hm.cpu(), cm)

    photo = {**plan, "flips": {k: torch.zeros_like(v) if v.dtype == torch.bool else v
                               for k, v in plan["flips"].items()}}
    photo.pop("geometric")
    _, m_out = A.apply_augment(images, masks.float() / 255.0, photo)
    assert torch.equal(m_out, masks.float() / 255.0)
    out = train_pre(batch, _host_geometry(4, 1024, mode, 1), mode,
                    torch.Generator().manual_seed(1))
    assert out["images"].shape == (4, 1024, 1024, 3) and out["masks"].shape == (4, 1024, 1024)
    assert bool(out["images"].isfinite().all())


def test_remat_on_cuda(cuda):
    """`train_step` at ViT-B, 1024^2, batch 4, bf16 on a synthetic-mode
    augmented batch under each remat policy: K3 twice a block a step
    without remat, once under flash and dots_flash, K8 once; the loss
    finite."""
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train import train_pre
    from s3od_torch.training.train_step import train_step

    model = seeded_model(6)
    opt = Optimizer(model, 1e-5, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    batch = train_pre(fixture_batch(4, 1024), _host_geometry(4, 1024, "synthetic", 9),
                      "synthetic", torch.Generator().manual_seed(9))
    blocks = model.cfg.num_encoder_layers_used
    for i, policy in enumerate(REMAT_K3):
        reset_counts()
        loss = float(train_step(model, opt, loss_module, batch, 0, i,
                                generator=torch.Generator().manual_seed(0),
                                compute_dtype=torch.bfloat16, remat_policy=policy,
                                preprocessed=True)["loss"])
        assert launch_counts()["K3"] == REMAT_K3[policy] * blocks, policy
        assert k8_launches() == blocks and np.isfinite(loss), policy


def test_train_options_on_cuda(cuda, tmp_path):
    """The entry point with `dataset.transform_mode=synthetic
    backend.remat_policy=flash backend.split_augment=true` at ViT-B 1024^2
    b4 (K3 once a block a step under flash, the others twice); then at the
    tiny checkpoint's width `dataset.cache=true` (the letterbox cache
    built) and `train_stage.enable_image_logging=true` (the panels
    written, where tensorboard is installed)."""
    from s3od_torch.configs import segmentation_config
    from s3od_torch.training.train import train

    write_fixture_dataset(tmp_path)
    blocks = segmentation_config("dinov3_base").num_encoder_layers_used
    steps, val_batches = 16 // 4, 4 // 4
    args = [a for a in train_args(tmp_path, "c") if "transform_mode" not in a]
    reset_counts()
    metrics = train(args + ["dataset.transform_mode=synthetic",
                            "backend.remat_policy=flash",
                            "backend.split_augment=true", "backend.max_epochs=1"])
    for name, cnt in launch_counts().items():
        assert cnt == steps * (1 if name == "K3" else 2) * blocks + val_batches * blocks
    assert k8_launches() == steps * blocks and _finite(metrics)

    tiny = ["model=tiny", f"init_checkpoint={TINY_1024}", "backend.max_epochs=1",
            "dataset.transform_mode=regular"]
    base = [a for a in train_args(tmp_path, "d") if "transform_mode" not in a]
    assert _finite(train(base + tiny + ["dataset.cache=true"]))
    cache = tmp_path / "fixture" / ".s3od_cache" / "s1024"
    assert (cache / "images.npy").exists() and (cache / "meta.json").exists()
    base = [a for a in train_args(tmp_path, "e") if "transform_mode" not in a]
    train(base + tiny + ["train_stage.enable_image_logging=true"])
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:  # train() runs without a writer and logs no panels
        return
    ea = EventAccumulator(str(next((tmp_path / "e" / "logs").iterdir())))
    ea.Reload()
    tags = ea.Tags()["images"]
    assert 1 <= len(tags) <= 8
    assert tags == [f"val_images/epoch_0_img_{i}" for i in range(len(tags))]


def test_demo_on_cuda(cuda, tmp_path):
    """`demo_e2e.run` at DEMO_ARGS: the procedural dataset (600 images),
    ViT-S trained from scratch at 160^2 (float32, regular augmentation,
    remat flash, bce_iou_ssim with the IoU-ranking term), the export
    reloaded by BackgroundRemoval and scored: val_dice > 0.5 and holdout
    IoU > 0.5 (the script's gate; the selection gap it adds with the
    ranking term closes only with longer training). Float32 training
    turns TF32 off process-wide; the flags are restored after."""
    from s3od_torch.training import demo_e2e

    with tf32_restored():
        summary = demo_e2e.run(demo_e2e.parse_args(
            ["--root", str(tmp_path / "demo"), *DEMO_ARGS]))
    assert summary["val_dice"] > 0.5 and summary["holdout_iou"] > 0.5, summary
