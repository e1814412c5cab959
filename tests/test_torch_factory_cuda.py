"""On the card: the synthetic-data factory at FLUX.1-dev's widths, from
seeds, in bf16: the MMDiT (19 dual + 38 single blocks, 24 heads of 128),
T5-XXL, CLIP-L, the FLUX VAE and the ViT-L teacher. The orchestrator,
`generate`, `extract_features` and `SODTeacherPredictor` with K7 and the
q/k pass launched once an attention; the full-depth step's K7 held to its
plain version call by call with a planted fault caught; teacher training;
int8 residency; the converters bit for bit; LoRA fine-tuning (launches a
step, the loss falling, every K8 call held to its plain version, the
gradients against fp32, the adapters merged, the CLI); the MMDiT sharded
in place by FSDP2. The pipeline is built once for the module (~37 GiB);
the LoRA test frees T5 after encoding its captions, and the last test
shards the MMDiT, so the tests run in the order written. The file imports
no JAX: run it on the card with

    python3 chip_smoke.py -k factory
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _cuda import (FLASH_NORM_TOL, IMAGE, K8D_CALL_TOL, REPO, close, cuda,  # noqa: F401
                   fixture_pair, k8_launches, launch_counts, only_run, planted,
                   rel_norm, reset_counts, standing_in, tf32_restored)

pytestmark = pytest.mark.cuda

FACTORY_CLASS = "tabby cat"
PROMPT = "a photograph of a tabby cat"
# The accuracy bounds: 1.5x the values measured on an H100 80GB HBM3 at
# 700 W. The full-depth step with K7 against the same step with K7's plain
# version, end to end (which amplifies bf16 rounding over 57 blocks of
# seeded weights) and per attention call, and the 2 dual + 4 single block
# model's bf16 kernel route against fp32 exact. ||a - b|| / ||b|| per
# output; the inputs and kernels are deterministic.
K7_STEP_TOL = {"velocity": 2.6e-2, "taps": 2.5e-2, "maps": 2.6e-2}
K7_CALL_TOL = 2.9e-3
BF16_STEP_TOL = {"velocity": 1.45e-2, "taps": 1.4e-2, "maps": 9.6e-3}
# The teacher's step: ViT-L (24 blocks, taps 4, 11, 17, 23: 23 run, none
# rematerialised), so each of K1-K5 and K8 runs once a block a step.
TEACHER_BLOCKS = 23
# The int8 MMDiT against the bf16 one it was quantized from: the JAX
# test's bound on the velocity (`tests/test_quant.py:101`).
INT8_VELOCITY_TOL = 5e-2
# The learning rate of the full-width LoRA steps. The base is bf16, and the
# merge rounds delta.astype(bf16) into W, as the JAX package's does: at the
# CLI's default 1e-4 one AdamW step moves a delta entry by ~0.25 x 1e-4
# (rank 16, A ~ N(0, 1) / 16), under half a bf16 step at |W| ~ 0.02
# (~6e-5), so the step would mostly round away and the loss could not
# fall; at 1e-3 it moves ~4 such steps (the first update still moves every
# entry of B by lr, and the loss rises once before it falls).
LORA_LR = 1e-3
LORA_STEPS = 8
# The LoRA gradients (and the loss) of the bf16 kernel route (K7 + K8)
# against the fp32 exact route on 2 dual + 4 single blocks at full width,
# after one update: ||bf16 - fp32|| / ||fp32|| of the A leaves, the B
# leaves and the loss; 1.5x measured on the same card (3.6e-4, 8.3e-3,
# 1.8e-2).
LORA_GRAD_TOL = {"loss": 5.4e-4, "A": 1.25e-2, "B": 2.75e-2}


@pytest.fixture(scope="module")
def pipe(cuda):
    """`MMDiTConfig()` (FLUX.1-dev) in bf16, T5-XXL and CLIP-L in bf16 and
    the FLUX VAE, from seeds, made on the card."""
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models.mmdit import MMDiTConfig, init_mmdit
    from s3od_torch.models.vae import VAE, VAEConfig, init_vae

    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    vcfg = VAEConfig()
    out = ConceptAttentionPipeline(
        init_mmdit(MMDiTConfig(), gen(11), dtype=torch.bfloat16),
        text_encoders=TorchTextEncoders.random_init(12),
        vae=VAE(*init_vae(vcfg, gen(13)), vcfg))
    yield out
    del out
    torch.cuda.empty_cache()


def _per_step(pipe):
    """K7 launches of a plain step, of a concept step, of a sample."""
    cfg = pipe.cfg
    step = cfg.num_dual_blocks + cfg.num_single_blocks
    concept = step + cfg.num_dual_blocks
    return step, concept, (pipe.num_inference_steps - 3) * step + 3 * concept


def step_inputs(pipe, height, width, seed=3):
    """One concept step's inputs at the given canvas: T5/CLIP of a real
    prompt and concepts, seeded latents, the schedule's step 25 of 28."""
    from s3od_torch.datagen.diffusion import calculate_shift, make_img_ids, shifted_sigmas

    ph, pw = height // 16, width // 16
    dev = pipe.device
    t5, pooled = pipe.text_encoders.encode([PROMPT])
    cemb, cpool = pipe.text_encoders.encode_concepts([FACTORY_CLASS, "background"])
    g = torch.Generator(device=dev).manual_seed(seed)
    sig = shifted_sigmas(28, calculate_shift(ph * pw))[25]
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(latents=torch.randn(1, ph * pw, pipe.cfg.in_channels, generator=g,
                                    device=dev),
                txt=t(t5), pooled=t(pooled),
                timestep=torch.full((1,), float(sig), device=dev),
                img_ids=t(make_img_ids(ph, pw)),
                txt_ids=torch.zeros(t5.shape[1], 3, device=dev),
                guidance=torch.full((1,), 3.5, device=dev),
                concepts=t(cemb), pooled_concepts=t(cpool),
                concept_layers=pipe.concept_layers, compute_dtype=torch.bfloat16)


def step_errors(got, ref):
    """Relative errors of one MMDiT step's outputs: the velocity, the worst
    feature tap and the concept maps."""
    return {"velocity": rel_norm(got["output"], ref["output"]),
            "taps": max(rel_norm(g, r) for g, r in zip(got["features"], ref["features"])),
            "maps": rel_norm(got["concept_maps"], ref["concept_maps"])}


def within(errs, tol) -> bool:
    return all(errs[k] <= tol[k] for k in tol)


def cut_models(pipe):
    """The factory's MMDiT at full width cut to 2 dual + 4 single blocks,
    in fp32 and bf16, its weights copied."""
    from s3od_torch.models.mmdit import MMDiT

    cut = dataclasses.replace(pipe.cfg, num_dual_blocks=2, num_single_blocks=4,
                              feature_taps=(0, 1, 2, 3))
    m32 = MMDiT(cut, device="meta", dtype=torch.float32).to_empty(device="cuda")
    src = pipe.model.state_dict()
    with torch.no_grad():
        for name, p in m32.state_dict().items():
            p.copy_(src[name].float())
    m16 = MMDiT(cut, device="cuda", dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    return cut, m32, m16


def test_factory_on_cuda(cuda, pipe, tmp_path):
    """The orchestrator (`process_class`, one class, 2 samples, jpg + png
    on disk) with the ViT-L teacher of `model/flux_teacher.yaml`: K7 and
    the q/k pass once an attention of every step (28 steps, concepts on
    the last 3), no q/k backward, the teacher's K1-K5 once a block a
    sample; a direct 1024^2 `generate` (K7 a step as the step's kind
    gives it, 4 finite (4096, 768) taps, concept maps in [0, 1]); one
    `extract_features` (one concept step); `SODTeacherPredictor` on the
    fixture photo."""
    from s3od_torch.configs import segmentation_config
    from s3od_torch.datagen import generate_train_images as gti
    from s3od_torch.datagen.mask_generator import MaskGenerator
    from s3od_torch.evaluation.teacher_predictor import SODTeacherPredictor
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops import qk_norm_rope as qr

    teacher = MaskGenerator(model=init_flux_teacher(
        FluxTeacherConfig(base=segmentation_config("dinov3_large")),
        torch.Generator().manual_seed(14)))
    per_step, per_concept_step, per_sample = _per_step(pipe)
    orch = gti.ImageMaskGenerationPipeline(gti.GenerationConfig(
        output_dir=str(tmp_path / "out"), prompts_dir=str(tmp_path / "prompts"),
        prompts_per_class=2), pipe, teacher)
    reset_counts()
    assert orch.process_class(FACTORY_CLASS, 2) == 2
    assert fa.flash_attention_online.launches == 2 * per_sample
    assert (qr.qk_norm_rope.launches, qr.qk_norm_rope_bwd.launches) == (2 * per_sample, 0)
    blocks_t = teacher.cfg.base.num_encoder_layers_used
    assert launch_counts() == dict.fromkeys(launch_counts(), 2 * blocks_t)
    for i in range(2):
        stem = f"{FACTORY_CLASS.replace(' ', '_')}_{i:04d}"
        img = Image.open(tmp_path / "out" / "images" / f"{stem}.jpg")
        assert img.size == Image.open(tmp_path / "out" / "masks" / f"{stem}.png").size
    del orch

    kinds = set()
    real_step = pipe._step

    def step(*args):
        before = fa.flash_attention_online.launches
        out = real_step(*args)
        kinds.add((args[-2] is not None, fa.flash_attention_online.launches - before))
        return out

    pipe._step = step
    try:
        reset_counts()
        image, feats, cmaps = pipe.generate(PROMPT, FACTORY_CLASS, 1024, 1024, 7)
    finally:
        pipe._step = real_step
    assert fa.flash_attention_online.launches == per_sample
    assert qr.qk_norm_rope.launches == per_sample
    assert kinds == {(False, per_step), (True, per_concept_step)}
    assert image.shape == (1024, 1024, 3) and image.dtype == np.uint8
    assert len(feats) == 4
    assert all(f.shape == (4096, 768) and np.isfinite(f).all() for f in feats)
    for m in (cmaps["category"], cmaps["background"]):
        assert m.shape == (64, 64) and np.isfinite(m).all()
        assert m.min() >= 0.0 and m.max() <= 1.0 + 1e-6

    lat = pipe.vae.encode(image)
    reset_counts()
    ext = pipe.extract_features(lat, PROMPT, [FACTORY_CLASS, "background"], 1024, 1024)
    assert fa.flash_attention_online.launches == per_concept_step
    assert all(np.isfinite(f).all() for f in ext.features)
    maps = np.stack(list(ext.concept_maps.values()))
    assert np.isfinite(maps).all() and maps.min() >= 0 and maps.max() <= 1 + 1e-6

    photo = fixture_pair()[0]
    reset_counts()
    res = SODTeacherPredictor(None, mask_generator=teacher, pipeline=pipe,
                              vae=pipe.vae).predict(photo, "a photograph", "object")
    assert fa.flash_attention_online.launches == per_concept_step
    assert res.soft_mask.shape == photo.shape[:2] and np.isfinite(res.soft_mask).all()


def test_k7_accuracy_on_cuda(cuda, pipe):
    """The full-depth bf16 concept step at 1024^2 with K7 against the same
    step with K7's plain version (K7_STEP_TOL), and each of its 76
    attentions against K7's plain version on that call's inputs
    (K7_CALL_TOL), where a planted o x 1.01 fails; then full width at 2
    dual + 4 single blocks, the bf16 kernel route against fp32 exact (TF32
    off, BF16_STEP_TOL)."""
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops.precision import set_exact_float32

    inp = step_inputs(pipe, 1024, 1024)
    real = fa.flash_attention_online

    def run(kernel):
        # the attention's autograd Function calls K7 through this name
        with standing_in(fa, "flash_attention_online", kernel), torch.inference_mode():
            return pipe.model(**inp)

    def faulty(q, k, v, n_valid):
        o, lse = real(q, k, v, n_valid)
        return o * 1.01, lse

    def shadowed(kernel, worst):
        def call(q, k, v, n_valid):
            o, lse = kernel(q, k, v, n_valid)
            o_ref, _ = fa.flash_attention_online_plain(q, k, v, n_valid)
            worst.append(rel_norm(o, o_ref))
            return o, lse
        return call

    errs = step_errors(run(real), run(fa.flash_attention_online_plain))
    assert within(errs, K7_STEP_TOL), errs
    calls, calls_bad = [], []
    run(shadowed(real, calls))
    run(shadowed(faulty, calls_bad))
    assert len(calls) == 76 and max(calls) <= K7_CALL_TOL, max(calls)
    assert max(calls_bad) > K7_CALL_TOL

    _, m32, m16 = cut_models(pipe)
    inp_cut = dict(inp, concept_layers=None)
    with tf32_restored(), torch.inference_mode():
        set_exact_float32()
        errs = step_errors(m16(**inp_cut), m32(**dict(inp_cut, compute_dtype=torch.float32)))
    assert within(errs, BF16_STEP_TOL), errs


def _teacher_samples():
    """Three image/mask pairs from the fixture pair, one per bucket: the
    photo (480 x 640 -> 896 x 1152), the photo turned (-> 1152 x 896) and
    its square centre (-> 1024^2). The names put the turned one in the
    validation split (`dataset.val_split=0.34`, seed 42), so the CLI trains
    on a non-square and the 1024^2 bucket."""
    image, mask = fixture_pair()
    c0 = (image.shape[1] - image.shape[0]) // 2
    sq = slice(c0, c0 + image.shape[0])
    return [("p_land", image, mask), ("q_tall", np.rot90(image), np.rot90(mask)),
            ("r_square", image[:, sq], mask[:, sq])]


def _shadow_calls(kernel, plain, worst, n_out):
    """`kernel`, and beside each of its calls `plain` on the same inputs:
    the worst relative norm of each of the first `n_out` outputs in
    `worst[i]`, the smallest norm of a reference output in
    `worst["min_ref"]` (a zero cotangent would make the comparison
    vacuous), and each call's (q shape, n_valid) in `worst["calls"]`."""
    def call(*args):
        got, ref = kernel(*args), plain(*args)
        for i in range(n_out):
            worst[i] = max(worst.get(i, 0.0), rel_norm(got[i], ref[i]))
            worst["min_ref"] = min(worst.get("min_ref", float("inf")),
                                   float(ref[i].float().norm()))
        worst.setdefault("calls", []).append((tuple(args[0].shape), int(args[-1])))
        return got
    return call


def test_teacher_on_cuda(cuda, pipe, tmp_path):
    """Teacher training at `model/flux_teacher.yaml`'s width (ViT-L, 256
    features, FLUX dim 768, concept maps), bf16, on features the port's
    `feature_extraction.py` makes with the factory's models for three
    fixture-made images: the CLI `config_name=train_teacher` for one epoch
    (its checkpoint through `convert.load_teacher` equal to its export,
    which `SODTeacherPredictor` serves); one step on the 896 x 1152 sample
    with every K3 and K8 call held to its plain version (FLASH_NORM_TOL),
    with planted K3 o x 1.01 and K8 dk x 1.01 caught at that shape; 8
    steps on the 1024^2 sample at the recipe's learning rates (K1-K5 and
    K8 once a block a step, the loss falling)."""
    from s3od_torch.configs import segmentation_config
    from s3od_torch.convert import load_teacher, save_native, teacher_tree_from_state_dict
    from s3od_torch.datagen.feature_extraction import FeatureStorage, FluxFeatureExtractor
    from s3od_torch.evaluation.teacher_predictor import SODTeacherPredictor
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.training.checkpoint import restore_external
    from s3od_torch.training.data import FluxFeatureDataset, collate_dicts
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train import train, upload
    from s3od_torch.training.train_step import teacher_forward, train_step

    ds = tmp_path / "DUTS-TR"
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir(parents=True)
    storage = FeatureStorage(str(tmp_path / "flux_features"))
    extractor = FluxFeatureExtractor(pipe, pipe.vae)
    for stem, im, m in _teacher_samples():
        Image.fromarray(np.ascontiguousarray(im)).save(ds / "images" / f"{stem}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(ds / "masks" / f"{stem}.png")
        feats, cmaps = extractor.extract(np.ascontiguousarray(im), "a photograph", "object")
        storage.save(f"DUTS-TR_{stem}", feats, cmaps)  # the prefix fallback

    base = tmp_path / "out"
    metrics = train(["config_name=train_teacher", "backend=1chip",
                     "dataset.paths=[DUTS-TR]", "dataset.val_split=0.34",
                     "dataset.test_datasets=[]", "backend.max_epochs=1",
                     "backend.num_threads=4", f"data_dir={tmp_path}", f"base_dir={base}",
                     f"flux_features_dir={tmp_path / 'flux_features'}"])
    assert np.isfinite(metrics["train_loss"]) and np.isfinite(metrics["val_loss"])
    run = only_run(base)
    exported = load_teacher(str(run / "s3od_final.npz"))
    assert exported.cfg.base.encoder.hidden_size == 1024 and exported.cfg.flux_dim == 768
    sd = restore_external(str(run / "last"))[0]["model"]
    assert set(sd) == set(exported.state_dict())
    save_native(str(tmp_path / "ckpt.npz"), *teacher_tree_from_state_dict(sd))
    back = load_teacher(str(tmp_path / "ckpt.npz")).state_dict()
    assert all(torch.equal(v, back[k]) for k, v in exported.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    del exported, back, sd
    photo = fixture_pair()[0]
    res = SODTeacherPredictor(str(run / "s3od_final.npz"), pipeline=pipe,
                              vae=pipe.vae).predict(photo, "a photograph", "object")
    assert res.soft_mask.shape == photo.shape[:2] and np.isfinite(res.soft_mask).all()
    torch.cuda.empty_cache()

    ds_all = FluxFeatureDataset(str(ds), 1024, "train", 0.0,
                                flux_features_dir=str(tmp_path / "flux_features"))
    by_stem = {Path(f).stem: i for i, f in enumerate(ds_all.files)}
    model = init_flux_teacher(FluxTeacherConfig(base=segmentation_config("dinov3_large")),
                              torch.Generator().manual_seed(15)).cuda()
    # the recipe's AdamW (optimizer/adamw.yaml: 1e-5, the head at 10x)
    opt = Optimizer(model, 1e-5, head_lr_mult=10.0, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])

    def step(stem, i):
        batch = upload(collate_dicts([ds_all.load(by_stem[stem])]), torch.device("cuda"))
        if i == 0:
            assert tuple(batch["images"].shape[1:3]) == (896, 1152)
        return float(train_step(model, opt, loss_module, batch, 0, i,
                                generator=torch.Generator().manual_seed(i),
                                compute_dtype=torch.bfloat16,
                                forward=teacher_forward)["loss"])

    k3_worst, k8_worst = {}, {}
    with standing_in(fa, "flash_attention", _shadow_calls(
            fa.flash_attention, fa.flash_attention_plain, k3_worst, 1)), \
            standing_in(fa, "flash_attention_bwd", _shadow_calls(
                fa.flash_attention_bwd, fa.flash_attention_bwd_plain, k8_worst, 3)):
        step("p_land", 0)
    assert sorted(set(k3_worst.pop("calls"))) == [((16, 4096, 64), 4037)]
    assert len(k8_worst.pop("calls")) == TEACHER_BLOCKS and k8_worst.pop("min_ref") > 0
    k3_worst.pop("min_ref")
    assert k3_worst[0] <= FLASH_NORM_TOL and max(k8_worst.values()) <= FLASH_NORM_TOL

    losses = []
    for i in range(1, 1 + 8):
        reset_counts()
        losses.append(step("r_square", i))
        if i == 2:
            assert launch_counts() == dict.fromkeys(launch_counts(), TEACHER_BLOCKS)
            assert k8_launches() == TEACHER_BLOCKS
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    q, k, v = (torch.randn(16, 4096, 64, device="cuda", dtype=torch.bfloat16) * s
               for s in (0.125, 1.0, 1.0))
    got = fa.flash_attention(q, k, v, 4037)
    ref = fa.flash_attention_plain(q, k, v, 4037)
    close(got, ref, lse=1, norm_tol=FLASH_NORM_TOL)
    with pytest.raises(AssertionError):
        close(planted(got, 0), ref, lse=1, norm_tol=FLASH_NORM_TOL)
    g = torch.randn_like(q)
    g[:, 4037:] = 0
    grads = fa.flash_attention_bwd(q, k, v, *got, g, 4037)
    grads_ref = fa.flash_attention_bwd_plain(q, k, v, *got, g, 4037)
    close(grads, grads_ref, norm_tol=FLASH_NORM_TOL)
    with pytest.raises(AssertionError):
        close(planted(grads, 1), grads_ref, norm_tol=FLASH_NORM_TOL)


def _step_run(model, inputs):
    """A plain and a concept MMDiT step: the velocity and the K7 launches
    of each, each K7 call fed by one q/k pass."""
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops import qk_norm_rope as qr

    out = {}
    for name, kw in (("plain", dict(inputs, concepts=None, pooled_concepts=None)),
                     ("concept", inputs)):
        with torch.no_grad():  # FSDP2's gathers need version counters
            reset_counts()
            res = model(**kw)
        assert qr.qk_norm_rope.launches == fa.flash_attention_online.launches, name
        out[name] = (res["output"].float().clone(), fa.flash_attention_online.launches)
    return out


def test_int8_on_cuda(cuda, pipe):
    """Int8 weight residency on the full-depth FLUX.1-dev MMDiT at 1024^2:
    `init_mmdit(int8_weights=True)` runs a plain and a concept step (K7 57
    and 76), finite; `quantize_mmdit` of the factory's bf16 model: each
    step's velocity against the bf16 step's (INT8_VELOCITY_TOL)."""
    from s3od_torch.models.mmdit import init_mmdit, quantize_mmdit

    cfg = pipe.cfg
    per_step, per_concept_step, _ = _per_step(pipe)
    inp = step_inputs(pipe, 1024, 1024)
    bf16 = _step_run(pipe.model, inp)
    m8 = init_mmdit(cfg, torch.Generator(device="cuda").manual_seed(21),
                    dtype=torch.bfloat16, int8_weights=True)
    int8 = _step_run(m8, inp)
    assert (int8["plain"][1], int8["concept"][1]) == (per_step, per_concept_step)
    assert torch.isfinite(int8["concept"][0]).all()
    del m8, int8
    torch.cuda.empty_cache()
    quant = _step_run(quantize_mmdit(pipe.model), inp)
    for name in ("plain", "concept"):
        assert rel_norm(quant[name][0], bf16[name][0]) <= INT8_VELOCITY_TOL, name


def _module_tree(module):
    """A module's tensors as its JAX-path tree without copies: `weight`
    (out, in) becomes `kernel` as the transposed view (the layout of
    `convert.state_dict_to_tree`, kept on the module's device and dtype)."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        parts = name.split(".")
        if parts[-1] == "weight" and t.dim() == 2:
            parts[-1], t = "kernel", t.t()
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    lists = lambda n: ([lists(n[str(i)]) for i in range(len(n))]
                       if isinstance(n, dict) and n and all(k.isdigit() for k in n)
                       else {k: lists(v) for k, v in n.items()}
                       if isinstance(n, dict) else n)
    return lists(tree)


def _diffusers_transformer_sd(tree):
    """An MMDiT tree (`_module_tree`, torch leaves) -> the diffusers
    `FluxTransformer2DModel` state dict on the host:
    `convert_flux_transformer` read backwards (q, k, v split out of the
    fused qkv, `norm_out` back to [scale, shift])."""
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = p["kernel"].T
        if "bias" in p:
            sd[f"{name}.bias"] = p["bias"]

    def qkv(names, p):
        d = p["kernel"].shape[1] // 3
        for i, name in enumerate(names):
            lin(name, {"kernel": p["kernel"][:, i * d:(i + 1) * d],
                       "bias": p["bias"][i * d:(i + 1) * d]})

    def norms(pre, p, q, k):
        sd[f"{pre}.{q}.weight"], sd[f"{pre}.{k}.weight"] = p["q"], p["k"]

    tte = "time_text_embed"
    lin("x_embedder", tree["img_in"])
    lin("context_embedder", tree["txt_in"])
    for src, dst in (("time_in", "timestep_embedder"), ("guidance_in", "guidance_embedder"),
                     ("vector_in", "text_embedder")):
        lin(f"{tte}.{dst}.linear_1", tree[src]["fc1"])
        lin(f"{tte}.{dst}.linear_2", tree[src]["fc2"])
    for i, b in enumerate(tree["dual_blocks"]):
        a = f"transformer_blocks.{i}"
        lin(f"{a}.norm1.linear", b["img_mod"])
        lin(f"{a}.norm1_context.linear", b["txt_mod"])
        qkv([f"{a}.attn.to_{x}" for x in "qkv"], b["img_attn"]["qkv"])
        qkv([f"{a}.attn.add_{x}_proj" for x in "qkv"], b["txt_attn"]["qkv"])
        lin(f"{a}.attn.to_out.0", b["img_attn"]["proj"])
        lin(f"{a}.attn.to_add_out", b["txt_attn"]["proj"])
        norms(f"{a}.attn", b["img_attn"]["qk_norm"], "norm_q", "norm_k")
        norms(f"{a}.attn", b["txt_attn"]["qk_norm"], "norm_added_q", "norm_added_k")
        lin(f"{a}.ff.net.0.proj", b["img_mlp"]["fc1"])
        lin(f"{a}.ff.net.2", b["img_mlp"]["fc2"])
        lin(f"{a}.ff_context.net.0.proj", b["txt_mlp"]["fc1"])
        lin(f"{a}.ff_context.net.2", b["txt_mlp"]["fc2"])
    for i, b in enumerate(tree["single_blocks"]):
        a = f"single_transformer_blocks.{i}"
        lin(f"{a}.norm.linear", b["mod"])
        qkv([f"{a}.attn.to_{x}" for x in "qkv"], b["qkv"])
        norms(f"{a}.attn", b["qk_norm"], "norm_q", "norm_k")
        lin(f"{a}.proj_mlp", b["mlp_in"])
        lin(f"{a}.proj_out", b["proj_out"])
    fm = tree["final_mod"]
    d = fm["kernel"].shape[1] // 2
    lin("norm_out.linear", {
        "kernel": torch.cat([fm["kernel"][:, d:], fm["kernel"][:, :d]], 1),
        "bias": torch.cat([fm["bias"][d:], fm["bias"][:d]])})
    lin("proj_out", tree["proj_out"])
    return {k: v.contiguous().cpu() for k, v in sd.items()}


def _diffusers_vae_sd(enc, dec, dtype):
    """The VAE's (enc, dec) trees -> the diffusers `AutoencoderKL` state
    dict in `dtype`: `convert_diffusers_vae` read backwards."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = p["kernel"].transpose(3, 2, 0, 1)
        if "bias" in p:
            sd[f"{name}.bias"] = p["bias"]

    def gn(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["weight"], p["bias"]

    def lin(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["kernel"].T, p["bias"]

    def res(name, p):
        gn(f"{name}.norm1", p["norm1"])
        conv(f"{name}.conv1", p["conv1"])
        gn(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv2", p["conv2"])
        if "shortcut" in p:
            conv(f"{name}.conv_shortcut", p["shortcut"])

    def mid(side, p):
        res(f"{side}.mid_block.resnets.0", p["res1"])
        res(f"{side}.mid_block.resnets.1", p["res2"])
        a = f"{side}.mid_block.attentions.0"
        gn(f"{a}.group_norm", p["attn"]["norm"])
        for x in "qkv":
            lin(f"{a}.to_{x}", p["attn"][x])
        lin(f"{a}.to_out.0", p["attn"]["proj"])

    for side, tree, blocks, key in (("encoder", enc, "down_blocks", "down"),
                                    ("decoder", dec, "up_blocks", "up")):
        conv(f"{side}.conv_in", tree["conv_in"])
        mid(side, tree["mid"])
        for i, stage in enumerate(tree[key]):
            for j, p in enumerate(stage["resnets"]):
                res(f"{side}.{blocks}.{i}.resnets.{j}", p)
            for sample, sub in (("downsample", "downsamplers"), ("upsample", "upsamplers")):
                if sample in stage:
                    conv(f"{side}.{blocks}.{i}.{sub}.0.conv", stage[sample])
        gn(f"{side}.conv_norm_out", tree["norm_out"])
        conv(f"{side}.conv_out", tree["conv_out"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype) for k, v in sd.items()}


def _hf_text_dirs(root: Path, t5, clip):
    """Seeded T5 and CLIP text encoders written as `save_pretrained`
    directories (config.json + model.safetensors in the encoders' dtype):
    the transformers key layout `convert_t5_encoder` / `convert_clip_text`
    read."""
    from safetensors.torch import save_file

    from s3od_torch.convert import state_dict_to_tree

    t = state_dict_to_tree(t5.state_dict())
    sd = {"shared.weight": t["embedding"],
          "encoder.final_layer_norm.weight": t["final_layer_norm"]}
    for i, layer in enumerate(t["layers"]):
        pre, a, f = f"encoder.block.{i}.layer", layer["attention"], layer["ff"]
        sd[f"{pre}.0.layer_norm.weight"] = a["layer_norm"]
        for x in "qkvo":
            sd[f"{pre}.0.SelfAttention.{x}.weight"] = a[x]["kernel"].T
        if i == 0:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = \
                a["relative_attention_bias"]
        sd[f"{pre}.1.layer_norm.weight"] = f["layer_norm"]
        for x in ("wi_0", "wi_1", "wo"):
            sd[f"{pre}.1.DenseReluDense.{x}.weight"] = f[x]["kernel"].T
    c = t5.cfg
    t5_cfg = {"model_type": "t5", "architectures": ["T5EncoderModel"],
              "vocab_size": c.vocab_size, "d_model": c.d_model, "d_kv": c.d_kv,
              "d_ff": c.d_ff, "num_layers": c.num_layers, "num_heads": c.num_heads,
              "relative_attention_num_buckets": c.relative_attention_num_buckets,
              "relative_attention_max_distance": c.relative_attention_max_distance,
              "layer_norm_epsilon": c.layer_norm_epsilon,
              "feed_forward_proj": "gated-gelu", "dropout_rate": 0.0,
              "tie_word_embeddings": False}
    t = state_dict_to_tree(clip.state_dict())
    tm = "text_model"
    csd = {f"{tm}.embeddings.token_embedding.weight": t["token_embedding"],
           f"{tm}.embeddings.position_embedding.weight": t["position_embedding"],
           f"{tm}.final_layer_norm.weight": t["final_layer_norm"]["weight"],
           f"{tm}.final_layer_norm.bias": t["final_layer_norm"]["bias"]}
    for i, layer in enumerate(t["layers"]):
        pre = f"{tm}.encoder.layers.{i}"
        for src, dst in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            csd[f"{pre}.{dst}.weight"] = layer[src]["weight"]
            csd[f"{pre}.{dst}.bias"] = layer[src]["bias"]
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "out_proj")):
            csd[f"{pre}.self_attn.{dst}.weight"] = layer["attn"][src]["kernel"].T
            csd[f"{pre}.self_attn.{dst}.bias"] = layer["attn"][src]["bias"]
        for x in ("fc1", "fc2"):
            csd[f"{pre}.mlp.{x}.weight"] = layer["mlp"][x]["kernel"].T
            csd[f"{pre}.mlp.{x}.bias"] = layer["mlp"][x]["bias"]
    c = clip.cfg
    clip_cfg = {"model_type": "clip_text_model", "architectures": ["CLIPTextModel"],
                "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                "intermediate_size": c.intermediate_size,
                "num_hidden_layers": c.num_layers, "num_attention_heads": c.num_heads,
                "max_position_embeddings": c.max_position_embeddings,
                "layer_norm_eps": c.layer_norm_eps, "hidden_act": "quick_gelu",
                "eos_token_id": c.vocab_size - 1, "bos_token_id": c.vocab_size - 2,
                "attention_dropout": 0.0}
    for name, sd_, cfg_, mod in (("t5", sd, t5_cfg, t5), ("clip", csd, clip_cfg, clip)):
        d = root / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(cfg_))
        dt = next(mod.parameters()).dtype
        save_file({k: torch.from_numpy(np.ascontiguousarray(v)).to(dt)
                   for k, v in sd_.items()}, str(d / "model.safetensors"))
    return root / "t5", root / "clip"


def test_converters_on_cuda(cuda, pipe, tmp_path):
    """The converters on seeded weights in the source layouts, each output
    loaded back and run on the card against its source, bit for bit: the
    MMDiT at full width cut to 2 dual + 4 single blocks (the full depth is
    47.6 GB in fp32 on the host) and the FLUX VAE at full size, written as
    diffusers `.safetensors` (bf16), through `python -m
    s3od_torch.datagen.convert_flux`; T5-XXL and CLIP-L at full width and
    2 layers as `save_pretrained` directories through `python -m
    s3od_torch.datagen.convert_text_encoders --verify` (against
    transformers, when the host has it). The two CLIs run side by side."""
    from safetensors.torch import save_file

    from s3od_torch.convert import (load_clip_text, load_mmdit, load_t5,
                                    load_vae_modules, state_dict_to_tree)
    from s3od_torch.models.text_encoders import (CLIPTextConfig, T5Config,
                                                 init_clip_text, init_t5)

    cut, _, m16 = cut_models(pipe)
    save_file(_diffusers_transformer_sd(_module_tree(m16)),
              str(tmp_path / "transformer.safetensors"))
    vae = pipe.vae
    vdt = next(vae.dec.parameters()).dtype
    save_file(_diffusers_vae_sd(state_dict_to_tree(vae.enc.state_dict()),
                                state_dict_to_tree(vae.dec.state_dict()), vdt),
              str(tmp_path / "vae.safetensors"))
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    # bf16 weights (as the checkpoints ship), run in float32
    t5 = init_t5(dataclasses.replace(T5Config(), num_layers=2), gen(31),
                 dtype=torch.bfloat16)
    clip = init_clip_text(dataclasses.replace(CLIPTextConfig(), num_layers=2), gen(32),
                          dtype=torch.bfloat16)
    t5_dir, clip_dir = _hf_text_dirs(tmp_path / "hf", t5, clip)
    out = tmp_path / "npz"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd in (
        [sys.executable, "-m", "s3od_torch.datagen.convert_flux",
         "--transformer", str(tmp_path / "transformer.safetensors"),
         "--vae", str(tmp_path / "vae.safetensors"),
         "--out_transformer", str(out / "flux_mmdit.npz"),
         "--out_vae", str(out / "flux_vae.npz")],
        [sys.executable, "-m", "s3od_torch.datagen.convert_text_encoders",
         "--t5", str(t5_dir), "--clip", str(clip_dir), "--out-dir", str(out),
         "--verify"])]
    for p in procs:
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text[-3000:]

    inp = dict(step_inputs(pipe, 1024, 1024), concept_layers=None)
    conv = load_mmdit(str(out / "flux_mmdit.npz"), cut, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        a, b = m16(**inp), conv(**inp)
    assert torch.equal(a["output"], b["output"])
    assert all(torch.equal(x, y) for x, y in zip(a["features"], b["features"]))
    assert torch.equal(a["concept_maps"], b["concept_maps"])
    del m16, conv, a, b
    enc, dec, _ = load_vae_modules(str(out / "flux_vae.npz"))
    enc, dec = (m.to("cuda", vdt) for m in (enc, dec))
    g = gen(33)  # the inputs in the VAE's compute dtype, as `VAE` runs it
    lat = torch.randn(1, 64, 64, 16, generator=g, device="cuda").to(vae.dtype)
    img = (torch.rand(1, 512, 512, 3, generator=g, device="cuda") * 2 - 1).to(vae.dtype)
    with torch.inference_mode():
        assert torch.equal(dec(lat), vae.dec(lat))
        assert torch.equal(enc(img), vae.enc(img))
    del enc, dec
    ids = torch.randint(0, 32000, (1, 64), generator=g, device="cuda")
    cids = torch.randint(0, 49407, (1, 77), generator=g, device="cuda")
    cids[0, 20] = 49407
    # in bf16, as `TorchTextEncoders` casts and runs them
    bf = torch.bfloat16
    t5c = load_t5(str(out / "t5_encoder.npz")).to("cuda", bf)
    clipc = load_clip_text(str(out / "clip_text.npz")).to("cuda", bf)
    with torch.inference_mode():
        assert torch.equal(t5c(ids, compute_dtype=bf), t5(ids, compute_dtype=bf))
        assert all(torch.equal(x, y) for x, y in zip(clipc(cids, compute_dtype=bf),
                                                     clip(cids, compute_dtype=bf)))


def _lora_dataset(root: Path) -> Path:
    """Three captioned images of at least 1024^2 pixels made from the
    fixture photo: two 1280 x 1280 (the 1024^2 bucket) and one 1000 x 1462
    (the 832 x 1216 bucket), with captions.json in the metadata layout."""
    photo = Image.open(IMAGE).convert("RGB")
    images = root / "data" / "real" / "images"
    images.mkdir(parents=True)
    for i, (h, w) in enumerate(((1280, 1280), (1280, 1280), (1000, 1462))):
        im = photo.resize((w, h), Image.LANCZOS)
        if i == 1:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        im.save(images / f"r{i}.png")
    meta = root / "meta" / "real"
    meta.mkdir(parents=True)
    (meta / "captions.json").write_text(json.dumps(
        [{"image_path": f"r{i}.png", "caption": f"{PROMPT}, view {i}"} for i in range(3)]))
    return root


def _lora_batch(pipe, sample, text):
    """One sample as the CLI batches it: VAE latents of the bucket-resized
    image, packed; T5 / CLIP of the caption (encoded beforehand); RoPE
    ids of the packed grid."""
    from s3od_torch.datagen.diffusion import make_img_ids, pack_latents
    from s3od_torch.datagen.resizer import FluxResizer

    dev = pipe.device
    image = np.array(Image.open(sample["image"]).convert("RGB"))
    resized, hw = FluxResizer().resize_image(image)
    lat = torch.as_tensor(pipe.vae.encode(resized), device=dev)
    t5, pooled = text[sample["caption"]]
    ph, pw = lat.shape[1] // 2, lat.shape[2] // 2
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return hw, {"latents": pack_latents(lat), "txt": as_t(t5), "pooled": as_t(pooled),
                "img_ids": as_t(make_img_ids(ph, pw)),
                "txt_ids": torch.zeros(t5.shape[1], 3, device=dev)}


def _lora_launches():
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops import qk_norm_rope as qr

    return (fa.flash_attention_online.launches, fa.flash_attention_bwd.launches,
            qr.qk_norm_rope.launches, qr.qk_norm_rope_bwd.launches)


def test_lora_on_cuda(cuda, pipe, tmp_path):
    """LoRA fine-tuning (rank 16, alpha 16, AdamW at LORA_LR) on the
    seeded FLUX.1-dev model, K7 forward and K8 backward at D = 128 on
    every attention. (a) 8 steps at the 1024^2 bucket (4096 + 512 tokens)
    on one fixed draw: K7, K8 and the two q/k passes exactly once a block
    a step each, the loss falling; with per-block recomputation, K7 and
    the forward pass twice. (b, c) one step at each bucket (832 x 1216:
    3952 + 512 tokens, padded to 4480) with every K8 call against its
    plain version (K8D_CALL_TOL), where planted dk x 1.01 and dq x 1.01
    fail. (d) the gradients of the bf16 kernel route against the fp32
    exact route on full-width 2 dual + 4 single blocks after one update
    (LORA_GRAD_TOL). (e) the adapters written by `save_native` and merged
    by `ConceptAttentionPipeline(lora=path)`, which generates one 1024^2
    image with K7 and the q/k pass once an attention, the base untouched.
    T5-XXL is freed once the captions are encoded."""
    from s3od_torch.convert import load_native, save_native
    from s3od_torch.datagen import flux_finetune as ff
    from s3od_torch.datagen import lora as L
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops.precision import set_exact_float32

    dev = pipe.device
    root = _lora_dataset(tmp_path)
    samples = ff.collect_samples(str(root / "data"), ["real"], str(root / "meta"))
    assert len(samples) == 3
    concepts = [FACTORY_CLASS, "background"]
    text = {s["caption"]: pipe.text_encoders.encode([s["caption"]]) for s in samples}
    emb = pipe.text_encoders.encode([PROMPT])
    cemb, cpool = pipe.text_encoders.encode_concepts(concepts)
    pipe.text_encoders.t5 = None  # the captions are encoded
    torch.cuda.empty_cache()
    (hw0, b0), _, (hw2, b2) = (_lora_batch(pipe, s, text) for s in samples)
    assert hw0 == (1024, 1024) and hw2 == (832, 1216)

    model = pipe.model
    blocks = model.cfg.num_dual_blocks + model.cfg.num_single_blocks
    lcfg = L.LoRAConfig()
    lora = L.init_lora_params(torch.Generator(device=dev).manual_seed(0), model, lcfg)
    opt = L.lora_optimizer(lora, LORA_LR)
    step = L.make_lora_train_step(model, lcfg, opt)
    fixed = lambda: torch.Generator(device=dev).manual_seed(5)
    losses = []
    for _ in range(LORA_STEPS):
        reset_counts()
        losses.append(float(step(lora, b0, fixed())))
        assert _lora_launches() == (blocks,) * 4
    with torch.no_grad():
        final = float(L.lora_loss(model, lora, lcfg, b0, fixed()))
    assert final < losses[0], (losses, final)
    adapters = L.lora_parameters(lora)
    after_a = [t.detach().clone() for t in adapters]
    reset_counts()
    L.make_lora_train_step(model, lcfg, opt, remat=True)(lora, b0, fixed())
    assert _lora_launches() == (2 * blocks, blocks, 2 * blocks, blocks)

    real = fa.flash_attention_bwd
    for batch, n, n_valid in ((b0, 4608, 4608), (b2, 4480, 4464)):
        with torch.no_grad():
            for t, a in zip(adapters, after_a):
                t.copy_(a)
        seen = []

        def shadow(q, k, v, o, lse, g, nv):
            got = real(q, k, v, o, lse, g, nv)
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, nv)
            seen.append((tuple(q.shape), nv))
            close(got, ref, norm_tol=K8D_CALL_TOL)
            for which in (0, 1):
                with pytest.raises(AssertionError):
                    close(planted(got, which), ref, norm_tol=K8D_CALL_TOL)
            return got

        with standing_in(fa, "flash_attention_bwd", shadow):
            assert np.isfinite(float(step(lora, batch, fixed())))
        assert shadow.launches == blocks
        assert seen == [((24, n, 128), n_valid)] * blocks

    path = str(tmp_path / "flux_lora.npz")
    save_native(path, lora, {"alpha": np.float32(lcfg.alpha), "rank": np.int32(lcfg.rank),
                             "pack_order": np.bytes_(L.PACK_ORDER)})
    _, meta = load_native(path)
    assert float(meta["alpha"]) == 16.0 and int(meta["rank"]) == 16
    probe = model.dual_blocks[1].img_attn.qkv.weight
    before = probe.detach().clone()
    lpipe = ConceptAttentionPipeline(model, text_encoders=pipe.text_encoders,
                                     vae=pipe.vae, lora=path, device=dev)
    assert rel_norm(lpipe.merged["dual_blocks.1.img_attn.qkv.weight"], probe) > 0
    assert torch.equal(probe, before)
    reset_counts()
    out = lpipe(PROMPT, height=1024, width=1024, seed=7, concepts=concepts,
                prompt_embeds=emb, concept_embeds=cemb, concept_pooled=cpool)
    _, _, per_sample = _per_step(pipe)
    assert _lora_launches()[0] == _lora_launches()[2] == per_sample
    assert out.image.shape == (1024, 1024, 3) and out.image.dtype == np.uint8
    assert all(np.isfinite(f).all() for f in out.features)
    del lpipe, out, lora, opt, step

    _, m32, m16 = cut_models(pipe)
    gen = lambda: torch.Generator(device=dev).manual_seed(21)
    lora = L.init_lora_params(gen(), m16, lcfg)
    m32.requires_grad_(False)

    def grads(m, dtype):
        for p in L.lora_parameters(lora):
            p.grad = None
        loss = L.lora_loss(m, lora, lcfg, b0, gen(), compute_dtype=dtype)
        loss.backward()
        ps = L.lora_parameters(lora)
        return {"loss": loss.detach().reshape(1),
                "A": torch.cat([p.grad.flatten() for p in ps[::2]]),
                "B": torch.cat([p.grad.flatten() for p in ps[1::2]])}

    with tf32_restored():
        set_exact_float32()
        L.make_lora_train_step(m16, lcfg, L.lora_optimizer(lora, LORA_LR))(lora, b0, gen())
        reset_counts()
        g16 = grads(m16, torch.bfloat16)
        assert _lora_launches()[:2] == (6, 6)
        g32 = grads(m32, torch.float32)
    err = {k: rel_norm(g16[k], g32[k]) for k in g32}
    assert within(err, LORA_GRAD_TOL), err


def _leaves(node):
    """A LoRA block's {'A', 'B'} leaves in order (nested dicts)."""
    if "A" in node:
        return [node["A"], node["B"]]
    return [x for v in node.values() for x in _leaves(v)]


def test_lora_cli_on_cuda(cuda, tmp_path):
    """`flux_finetune.run` end to end on the card at the tiny MMDiT
    configuration (64^2 images: the tiny VAE's 32 x 32 latents, 256 image
    tokens): 3 steps, the adapters written with their pack order, B
    trained, loadable by the pipeline."""
    from s3od_torch.convert import load_native, save_factory_npz
    from s3od_torch.datagen import flux_finetune as ff
    from s3od_torch.datagen import lora as L
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models.mmdit import init_mmdit, tiny_mmdit_config
    from s3od_torch.models.text_encoders import CLIPTextConfig, T5Config
    from s3od_torch.models.vae import VAE, init_vae, tiny_vae_config

    dev = torch.device("cuda")
    root = _lora_dataset(tmp_path)
    tcfg = tiny_mmdit_config()
    tiny = init_mmdit(tcfg, torch.Generator(device=dev).manual_seed(31))
    save_factory_npz(str(tmp_path / "tiny_mmdit.npz"), tiny, tcfg)
    vcfg = tiny_vae_config()
    vae = VAE(*init_vae(vcfg, torch.Generator(device=dev).manual_seed(32)), vcfg,
              device=dev)
    enc = TorchTextEncoders.random_init(
        33, T5Config(vocab_size=300, d_model=tcfg.text_dim, d_kv=16, d_ff=96,
                     num_layers=2, num_heads=4),
        CLIPTextConfig(vocab_size=400, hidden_size=tcfg.pooled_dim,
                       intermediate_size=64, num_layers=2, num_heads=2),
        max_t5_tokens=32, device=dev)

    class SmallBuckets:
        def resize_image(self, image):
            return np.array(Image.fromarray(image).resize((64, 64))), (64, 64)

    conf = dict(flux_checkpoint=str(tmp_path / "tiny_mmdit.npz"),
                input_dir=str(root / "data"), datasets=["real"],
                metadata_dir=str(root / "meta"), rank=4, steps=3, lr=1e-3,
                out_lora=str(tmp_path / "tiny_lora.npz"), device=str(dev))
    (tmp_path / "finetune.yaml").write_text(json.dumps(conf))
    out_path = ff.run(str(tmp_path / "finetune.yaml"), _vae=vae, _text=enc,
                      _resizer=SmallBuckets())
    tree, meta = load_native(out_path)
    leaves = [np.asarray(x) for d in tree["dual_blocks"] + tree["single_blocks"]
              for x in _leaves(d)]
    assert len(leaves) == 2 * (4 * tcfg.num_dual_blocks + 2 * tcfg.num_single_blocks)
    assert all(np.isfinite(x).all() for x in leaves)
    assert any(np.abs(x).max() > 0 for x in leaves[1::2])
    assert bytes(np.asarray(meta["pack_order"])) == L.PACK_ORDER
    ConceptAttentionPipeline(tiny, text_encoders=enc, vae=vae, lora=out_path, device=dev)


def test_sharded_factory_on_cuda(cuda, pipe):
    """The factory's MMDiT at FLUX.1-dev's full width: one plain and one
    concept step at 1024^2 unsharded, then the same module sharded in
    place by FSDP2 over a one-rank mesh (`shard_module(wrap="fsdp")`, as
    `from_config(fsdp=1)` shards it): K7 57 and 76 launches a step both
    ways, the velocity within K7_STEP_TOL. Runs last: the module stays
    sharded."""
    from s3od_torch.datagen.diffusion import calculate_shift, make_img_ids, shifted_sigmas
    from s3od_torch.parallel import distributed as pd
    from s3od_torch.parallel.mesh import make_mesh, shard_module

    cfg, dev = pipe.cfg, pipe.device
    g = torch.Generator(device=dev).manual_seed(21)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    sig = shifted_sigmas(28, calculate_shift(64 * 64))[25]
    inputs = dict(latents=randn(1, 64 * 64, cfg.in_channels),
                  txt=randn(1, 512, cfg.text_dim), pooled=randn(1, cfg.pooled_dim),
                  timestep=torch.full((1,), float(sig), device=dev),
                  img_ids=torch.from_numpy(make_img_ids(64, 64)).to(dev),
                  txt_ids=torch.zeros(512, 3, device=dev),
                  guidance=torch.full((1,), 3.5, device=dev),
                  concepts=randn(1, 2, cfg.text_dim), pooled_concepts=randn(1, cfg.pooled_dim),
                  concept_layers=pipe.concept_layers, compute_dtype=torch.bfloat16)
    base = _step_run(pipe.model, inputs)
    pd.ensure_group("cuda")
    try:
        shard_module(pipe.model, make_mesh(fsdp=1, device_type="cuda"), wrap="fsdp")
        sharded = _step_run(pipe.model, inputs)
    finally:
        pd.destroy()
    per_step, per_concept_step, _ = _per_step(pipe)
    for name, want in (("plain", per_step), ("concept", per_concept_step)):
        assert base[name][1] == sharded[name][1] == want, name
        assert rel_norm(sharded[name][0], base[name][0]) <= K7_STEP_TOL["velocity"], name
