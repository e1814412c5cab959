#!/usr/bin/env python3
"""Smoke run of the s3od_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --turns DIR   # also times the parent's K4, E2, K8, K10

Builds the port's kernels from `s3od_torch/csrc` (one nvcc per source,
all started together) and the Triton kernel, then:
  1. checks each kernel (K1-K6) against its plain PyTorch version in bf16
     (K4, the cluster wgmma kernel, at ViT-B b1, b16 and 2048^2, ViT-L,
     ViT-S, D = 32 and on rows of near-zero variance, x' and h by max
     error and relative norm, with planted x' x 1.01 and h x 1.01 caught,
     timed by CUDA events beside the unfused route; K1
     by relative norm too;
     K5, two wgmma GEMMs a call, also at ViT-B b4, ViT-L, ViT-S and the
     tiny widths, each launch against its plain half, with a planted
     hidden x 1.01 caught; K2 at ViT-B b1 and b16, ViT-L and D = 32, by
     max error and relative norm, with a planted q x 1.01 caught, timed
     by CUDA events beside F.linear and the unfused route) at the main
     paths' shapes (DINOv3-ViT-B/16 at
     1024^2: 4101 tokens padded to 4160, C = 768, F = 3072, 12 heads of
     64; batch 1 and batch 16; at 2048^2: 16389 tokens padded to 16448,
     RoPE on the 128 x 128 grid, K1, K2, K4 and K5 at batch 1 and K6 at
     D = 64 and 32),
     including the flash kernel's +-40 edge and adversarial
     +-1000-scale inputs, hot and cold (held to the plain version, o also
     by its relative norm, with a planted o x 1.01 caught), and times
     both at batch 1 (device time from a profiler trace of 20 calls;
     CUDA events around single calls, median of 25, which include the
     host launch; K3 and K6, and K8 below, also by CUDA events around
     back-to-back calls, the time they report, with SDPA by the same
     clocks); it logs which kernel serves D = 32; then the Triton pass of
     each of K2's, K4's and K5's backwards (`rope_bwd`, `ln_bwd`,
     `gelu_bwd`) at the training step's ViT-B 1024^2 b4 shapes against its
     plain version, by max error and relative norm, a planted output x 1.01
     caught, timed by the profiler beside the plain version and the bound;
  2. drives the 1024^2 path — `BackgroundRemoval.remove_background` and
     `remove_background_batch` (16 images) — at full ViT-B width with
     seeded random weights in bf16, checks that every kernel (K1-K5)
     launched 11 times per forward and that each batch result matches the
     single-image call on the same image (results and encoder taps),
     reports img/s at batch 1 and 16 and the device time of the forward by
     kernel, and compares against the port's float32 exact mode on the
     card: encoder taps per image at batch 4, and the masks and IoU scores;
  3. checks quality: the committed tiny checkpoint trained at 1024^2
     reaches IoU >= 0.9 on the fixture through the kernels (D = 32);
  4. drives the 2048^2 path — `remove_background_stream` (batch 1,
     payload "best", bucketed upload) at full ViT-B width — checks 11
     launches of K1-K5 per image and each result against
     `remove_background(payload="full")`, compares the encoder taps with
     float32 exact mode per image, runs the tiny checkpoint through
     `SODPredictor` at 2048^2 in bf16 and float32, and reports the
     forward's device time by kernel and the stream's img/s (also at
     1024^2);
  5. serves the 1024^2 predictor through `InferenceServer`: concurrent
     requests, each answer equal to a direct call;
  5b. runs the decoder's gated kernels (`S3OD_WINOGRAD`: K9a, the
     Winograd conv, and K9b, the chained RCU; `MASK_TAIL_FUSED`: K10, the
     fused mask tail): each against its plain version at the 1024^2
     shapes (K9a at each of its three 1024^2 b1 convs and the training
     step's 256 -> 512 dx, by relative norm too, with U's transform timed
     apart; K9b also at the 2048^2 path's refinenet1 shape), timed beside
     the cuDNN chain and the bound; the 1024^2 path
     with both gates on (b1 and b16: launches as the copied rule gives
     them, every gated call against its plain version on its own inputs,
     a planted K9b x 1.01 and a planted K9a x 1.01 caught there, results
     against fp32 exact mode,
     device time and img/s beside the gates off); one 2048^2 forward and
     stream the same way, and its device time with the gates off and on;
     one ViT-B 1024^2 b4 train step with the
     Winograd gate (K9a forward and dx launches) and K9a's dx against the
     plain version's vjp; K10 alone on random inputs at 1024^2 b1 and b16
     and 2048^2 (NCHW memory), on NHWC memory and on H-innermost memory,
     by relative norm with a planted out x 1.01 caught, timed with the
     card held (warm and after an L2 flush) with the clocks sampled;
  5c. exports serving bundles of the seeded ViT-B on the card
     (`s3od_torch.aot`: K1-K6, K9a, K9b and K10 as `s3od::` ops in
     `torch.export` graphs that take the weights as inputs): 1024² b1/b16
     x full/best, 2048² b1 best (K6 through a graph), 1024² b1 full with
     both decoder gates on; runs `verify_bundle` on each; holds the
     bundle predictor's answers against the eager predictor's (max|d|
     <= 1e-5 on "full", one uint8 step on "best") with K1-K5 launched 11
     times a forward through each graph and K9a/K9b/K10 as the eager
     gated forward launches them; checks that the graphs hold no
     weights (< 5% of weights.npz); times both routes (img/s, host ms to
     enqueue a forward) at 1024² b1/b16 in turns, and the cold
     start to the first answer in a fresh process from the bundle and
     from a `.npz`;
  5d. runs the tools: `evaluation.test_efficiency` at ViT-B 840² b1 and
     b16 with the profiler summary (the s3od:: ops' FLOPs held to the
     formulas over the 2752 padded tokens), `evaluation.mine_samples`
     with the tiny 1024² checkpoint (bf16 scores against fp32,
     `MINE_TOL`), `export_model --verify --aot-output` on it, and the
     demo's HTTP server answering `POST /predict` equal to a direct call;
  6. checks K8, the attention backward, against its plain version at the
     training shapes (12 and 48 x 4160 tokens, D = 64 and 32) and at
     2048^2, with +-1000-scale inputs, hot and cold, and cold rows near
     the window, and times it beside the SDPA backward (CUDA events);
  7. trains through the entry point, `s3od_torch.training.train.train`:
     ViT-B at 1024^2, batch 4, bf16, on PNG variants of the fixture pair
     (one epoch + validation, 11 x 2 launches of K1-K5 and 11 of K8 per
     step), resumes for one more epoch, serves the exported `.npz`, and
     fine-tunes the tiny checkpoint (D = 32) keeping IoU >= 0.9;
  8. times `train_step` (median ms, img/s, peak memory, device time by
     kernel), checks 11 x 2 launches of K1-K5, 11 of K8 and 11 of each
     backward pass in one step, and that the loss falls over 8 steps on
     one batch;
  9. holds the bf16 kernel route's gradients against fp32 exact mode and
     against K8's plain version, and shows that a planted K8 fault
     (dk x 1.01) fails the second check; then one 2048^2 train step;
  9b. runs the training input pipeline at 1024^2, batch 4, regular and
     synthetic: every stage of a plan that takes every branch on the card
     against the CPU on the same input and draws, masks unchanged by the
     photometric stages, ms a batch and the profiler's top five ops; the
     ViT-B 1024^2 b4 step on a synthetic-augmented batch under the remat
     policies none / flash / dots_flash in turns (step ms, peak GiB, K3
     22 / 11 / 11 and K8 11 launches a step); `train()` with synthetic
     augmentation, remat flash and split_augment at ViT-B, then with
     `dataset.cache=true` and with image logging at the tiny width; and
     the training demo (`s3od_torch.training.demo_e2e`, cut to ViT-S at
     160^2, 4 epochs), whose val dice and holdout IoU must pass 0.5;
 10. checks K7, the online-softmax attention forward, against its plain
     version at the MMDiT's shapes (24 heads of 128: 4608, 4160 with
     n_valid 4098, 3840 tokens; and D = 64) and on adversarial logits
     (+-600, row maxima rising along the keys), timed beside its bound and
     SDPA;
 10b. runs each script's `main()` of `s3od_torch.experiments`, the ports
     of the Pallas experiments of `benchmarks/`, once at its defaults, with
     the launches of E1-E4 counted around them: E1 (online-softmax
     variants), E4 (single-block variants with lse), E3a (the base-2
     static-bound forward, at the DIS and the ViT shape), E3b (the
     exponential throughput loop) and E2 (the single-pass LayerNorm,
     CUDA: also by relative norm with a planted y x 1.01 caught, and timed
     with F.layer_norm by one clock, warm and with L2 flushed, 5 readings
     each, the clocks sampled around them). Each main compares every variant's kernel with its plain
     version and times both; the phase holds those numbers to the limits
     (E3b bit-equal, also at 1-4 steps, where exp and exp2 stay finite),
     adds bounds, the exponentials' time and SDPA or F.layer_norm on the
     scripts' inputs, and holds one call of each of the five template
     instances of E1/E3a/E4 (E1's three variants, E4 base and nomax_clip2,
     E3a at both shapes) to its plain version by relative norm, where a
     planted o x 1.01 must fail;
 11. drives the synthetic-data factory at FLUX.1-dev width and depth with
     seeded weights in bf16 (T5-XXL + CLIP-L -> 28 MMDiT steps with the
     concept stream on the last 3 -> FLUX VAE -> ViT-L FluxDPT teacher
     mask -> jpg + png): `ImageMaskGenerationPipeline.process_class` for
     one class and 2 samples (both written, K7 launched exactly 1653 times
     a sample), one direct timed `generate` at 1024^2 (device ms per plain
     and concept step, a stage table, samples per minute, peak memory),
     one `extract_features`, one `SODTeacherPredictor.predict`, the
     full-depth step with K7 against K7's plain version end to end and
     per attention call (a planted K7 fault, o x 1.01, must fail the
     per-call check), and 2 dual + 4 single blocks at full width in bf16
     against fp32 exact;
 12. fine-tunes a LoRA on the same seeded FLUX.1-dev MMDiT (bf16, rank 16;
     `s3od_torch.datagen.lora`), on three >= 1024^2 images it writes with
     captions.json, the captions encoded before T5 is freed: K8 at D = 128
     (the attention backward on K7's lse, one single-pass kernel) against
     its plain version at (24, 4608, 128) and (24, 4480, 128) with n_valid
     4464, planted dk x 1.01 and dq x 1.01 caught, two calls on the same
     inputs compared (dk, dv equal; dq, summed across key blocks in no fixed
     order, within one rounding), timed beside its bound and the SDPA
     backward; 8
     full-width `make_lora_train_step` steps at the 1024^2 bucket (4608
     tokens; K7 and K8 exactly 57 launches a step, the loss at one fixed
     draw falling; step ms, img/s, peak GiB, the idle share; one step
     with each block recomputed, peak GiB again); one step at each of the
     1024^2 and 832 x 1216 (4464 tokens, padded to 4480) buckets with
     every K8 call held against its plain version by relative norm (a
     planted dk x 1.01 and a planted dq x 1.01 must fail); the LoRA
     gradients of 2 dual + 4 single
     blocks, bf16 K7 + K8 vs fp32 exact, after one update; the adapters
     written by `save_native`, loaded by `ConceptAttentionPipeline(lora=
     path)` and one 1024^2 image generated with them merged; and
     `flux_finetune.run` end to end on the card at the tiny MMDiT;
 13. runs the modules ported last, before the LoRA phase frees T5:
     teacher training (`teacher_phase`: features extracted by 11's models
     for three fixture-made images, `config_name=train_teacher` for one
     epoch at ViT-L, its checkpoint and export through
     `convert.load_teacher` and `SODTeacherPredictor`; a 896 x 1152 step
     with every K3 and K8 call against its plain version, planted o and
     dk x 1.01 caught; 8 steps on the 1024^2 sample, the loss falling,
     23 launches of each of K1-K5 and K8 a step, step ms, peak GiB, the
     idle share); int8 residency (`int8_phase`: the full-depth MMDiT from
     `init_mmdit(int8_weights=True)`, resident GiB, a plain and a concept
     step with K7 57 / 76, and `quantize_mmdit` of 11's model against its
     bf16 step, velocity within 5e-2); the converters (`converters_phase`:
     11's MMDiT cut to 2 + 4 blocks and the VAE as diffusers
     `.safetensors`, T5-XXL and CLIP-L at 2 layers as `save_pretrained`
     directories, through both CLIs, loaded and run bit-equal to their
     sources); and, after the tools, the filter chain (`filtering_phase`:
     `run_filtering` on the seeded ViT-B at 840^2, batch 8, 11 launches
     of K1-K5 a chunk, and the tiny checkpoint's verdicts on the card
     equal to the CPU's).

With `--turns DIR`, DIR holds the parent commit's
`s3od_torch/csrc/{attn_epilogue.cu, flash_attention_bwd.cu, mask_tail.cu,
hopper.cuh, mma.cuh}` and `s3od_torch/experiments/exp_layernorm.py` (not in
the repository; e.g. `git show <parent>:<path>`): the run builds the CUDA
sources beside the library (one nvcc each, all at once, DIR first on the
include path, C symbols renamed) and times each old kernel in turns with
the kernel that replaced it (old / new / new / old): K4 and E2, K8 at
D = 128 by CUDA events beside the SDPA backward, K10 with the card held,
warm and after an L2 flush.

Any failed check raises, so the run exits non-zero, as does a run that
loaded jax or any module of s3od_tpu. Without a CUDA device, or outside
the repository, it exits non-zero before printing a result. The last
lines are the kernel summary and the device result as JSON.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
IMAGE = REPO / "tests" / "fixture" / "image.jpg"
MASK = REPO / "tests" / "fixture" / "mask.png"
TINY_1024 = REPO / "tests" / "fixture" / "tiny_s3od_1024.npz"

KERNELS = {
    "K1_layer_norm": ("triton", "s3od_torch/ops/layernorm.py",
                      "s3od_tpu/ops/layernorm.py:76"),
    "K2_qkv_project_rope": ("cuda", "s3od_torch/csrc/qkv_project.cu",
                            "s3od_tpu/ops/qkv_project.py:132"),
    "K3_flash_attention": ("cuda", "s3od_torch/csrc/flash_attention.cu",
                           "s3od_tpu/ops/flash_attention.py:258"),
    "K4_attn_epilogue": ("cuda", "s3od_torch/csrc/attn_epilogue.cu",
                         "s3od_tpu/ops/attn_epilogue.py:69"),
    "K5_mlp_fused": ("cuda", "s3od_torch/csrc/mlp_fused.cu",
                     "s3od_tpu/ops/mlp_fused.py:119"),
    "K2_vjp_rope_bwd": ("triton", "s3od_torch/ops/qkv_project.py",
                        "s3od_tpu/ops/qkv_project.py:163"),
    "K4_vjp_ln_bwd": ("triton", "s3od_torch/ops/attn_epilogue.py",
                      "s3od_tpu/ops/attn_epilogue.py:116"),
    "K5_vjp_gelu_bwd": ("triton", "s3od_torch/ops/mlp_fused.py",
                        "s3od_tpu/ops/mlp_fused.py:162"),
    "K6_flash_attention_stream": ("cuda", "s3od_torch/csrc/flash_attention.cu",
                                  "s3od_tpu/ops/flash_attention.py:105"),
    "K8_flash_attention_bwd": ("cuda", "s3od_torch/csrc/flash_attention_bwd.cu",
                               "s3od_tpu/ops/flash_attention.py:492"),
    "K8_flash_attention_bwd_d128": ("cuda",
                                    "s3od_torch/csrc/flash_attention_bwd.cu",
                                    "s3od_tpu/ops/flash_attention.py:492"),
    "K7_flash_attention_online": ("cuda",
                                  "s3od_torch/csrc/flash_attention_online.cu",
                                  "s3od_tpu/ops/flash_attention.py:37"),
    "K9a_winograd_conv": ("cuda", "s3od_torch/csrc/winograd.cu",
                          "s3od_tpu/ops/experimental/winograd.py:201"),
    "K9b_winograd_rcu": ("cuda", "s3od_torch/csrc/winograd.cu",
                         "s3od_tpu/ops/experimental/winograd.py:420"),
    "K10_mask_tail": ("cuda", "s3od_torch/csrc/mask_tail.cu",
                      "s3od_tpu/ops/experimental/mask_tail.py:138"),
    "E1_flash_softmax": ("cuda", "s3od_torch/csrc/exp_flash_variants.cu",
                         "benchmarks/exp_flash_softmax.py:83"),
    "E2_layer_norm_single_pass": ("cuda", "s3od_torch/csrc/exp_layernorm.cu",
                                  "benchmarks/exp_layernorm.py:92"),
    "E3_exp2_flash": ("cuda", "s3od_torch/csrc/exp_flash_variants.cu",
                      "benchmarks/exp_exp2.py:124"),
    "E3_exp_loop": ("cuda", "s3od_torch/csrc/exp_loop.cu",
                    "benchmarks/exp_exp2.py:172"),
    "E4_flash_single": ("cuda", "s3od_torch/csrc/exp_flash_variants.cu",
                        "benchmarks/exp_flash_single.py:81"),
}
# Published dense peaks of one H100 SXM at 700 W (bf16 tensor cores, fp32
# outside them) and its HBM rate: the bound of a kernel is the larger of
# its operations over the peak of their type and its bytes (each input
# read once, each output written once) over the memory rate.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM = 3.35e12
REL_TOL = 1e-2   # max|kernel - plain| / max|plain| per output, bf16
LSE_TOL = 1e-3   # max|kernel - plain| of the fp32 lse
TAP_TOL = 1.5e-2  # ||bf16 kernel-route tap - fp32 exact tap|| / ||fp32 tap||
FLASH_NORM_TOL = 5e-3  # ||kernel o - plain o|| / ||plain o|| of K3/K6 per call:
                  # the two round the same fp32 sums to bf16, which differ in
                  # order only; half the planted o x 1.01 (1.0e-2), which
                  # REL_TOL alone sits on the edge of
LN_NORM_TOL = 5e-3  # ||kernel - plain|| / ||plain|| of K4's x' and h, K1's
                  # and E2's y per call: the two round the same fp32 values,
                  # summed in another order, to bf16 (K4 ~4e-5, E2 ~1.4e-5 on
                  # the H100); half the planted x 1.01 (1.0e-2), which
                  # REL_TOL alone sits on the edge of (as on K3 and K2)
BEST_TOL = 1 / 510 + 2.0**-9 + 1e-6  # payload "best" vs "full": the uint8
                  # step plus one bf16 rounding of a sigmoid in [0.5, 1)
BATCH_TOL = 1e-2  # batch vs single image: max|d| of masks and IoU scores,
                  # ||d|| / ||single|| of the encoder taps
B16 = 16          # remove_background_batch's chunk: the batch-16 shapes
SPIN_CYCLES = 400_000  # `held_ms`: ~0.2 ms of spin a call, above the host's
                  # enqueue of one wrapped launch (<= 0.09 ms measured on the H100 host)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"CHECK FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 25) -> float:
    """Median time of one call between CUDA events, after warm-up. It
    includes the host's launch wherever the device waits for it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, iters: int = 20) -> float:
    """Device time of one call from CUDA events around a run of `iters`
    back-to-back calls, after warm-up: for a kernel of a millisecond the
    host enqueues far ahead and the launch cost hides. (The profiler once
    reported half of every K7 time late in a long run, against this
    method and the profiler's own per-step breakdown.)"""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def held_ms(fn, iters: int = 20, flush=None) -> float:
    """Device time of one call by CUDA events with the host's launch cost
    kept out: a spin kernel (`torch.cuda._sleep`) holds the card while the
    host enqueues the events and calls, so they run back to back. Warm:
    `iters` calls back to back after warm-up. With `flush` (a tensor of
    at least 128 MB): each call alone after writing it, which evicts the
    50 MB L2, and the mean over `iters` calls. Where the host's enqueue of
    a call outlasts the call (small kernels, slow hosts), `run_ms` and
    `cuda_ms` read the host instead."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush is None:
        torch.cuda._sleep(SPIN_CYCLES * iters)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    total = 0.0
    for _ in range(iters):
        flush.fill_(1.0)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the summed time of every kernel the call
    launches (profiler trace of `iters` calls). Unlike CUDA events around
    a call, it leaves out the host's launch overhead, which can exceed a
    small kernel's run time. Where every trace came back empty (the
    profiler lost them all, as it did once on an H100 late in a run), the
    time comes from CUDA events around back-to-back calls, and the log
    says so."""
    total = sum(ms for _, ms, _ in kernel_breakdown(fn, iters))
    if total > 0:
        return total
    log("  the profiler recorded no device time; CUDA events over "
        f"{iters} back-to-back calls instead")
    return run_ms(fn, iters)


def kernel_breakdown(fn, iters: int):
    """[(kernel name, device ms per call, launches per call)], largest
    first, from torch.profiler traces of `iters` calls. A trace can lose
    events (one did on an H100: a kernel read half its time while the same
    run's other traces showed it whole, and another run's traces held no
    device event at all), and a lost event only lowers the total, so three
    traces that hold events are taken (of at most six) and the one with
    the median total is kept; [] if none held any."""
    import torch

    fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    traces = []
    for _ in range(6):
        with torch.profiler.profile(activities=[cuda]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 1e3 / iters,
                 round(e.count / iters))
                for e in prof.key_averages()
                if getattr(e, "device_time_total", 0.0) > 0
                and not e.key.startswith("Activity Buffer")]  # bookkeeping
        if rows:
            traces.append(sorted(rows, key=lambda r: -r[1]))
        if len(traces) == 3:
            break
    if not traces:
        return []
    traces.sort(key=lambda rows: sum(ms for _, ms, _ in rows))
    return traces[len(traces) // 2]


def time_pair(name, kernel_fn, plain_fn, results, iters: int = 20):
    """Kernel and plain version: device time (reported) and host-inclusive
    CUDA-event time (logged), measured in turns on the same inputs."""
    r = results[name]
    r["ms"] = device_ms(kernel_fn, iters)
    r["plain_ms"] = device_ms(plain_fn, iters)
    r["event_ms"] = cuda_ms(kernel_fn, iters)
    r["plain_event_ms"] = cuda_ms(plain_fn, iters)


def set_bound(results, name, bf16_ops, nbytes, fp32_ops=0.0):
    """The least time the card could take for one call: the larger of the
    operations over their peak rate and the bytes over HBM's rate."""
    t_ops = bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    t_mem = nbytes / HBM
    r = results[name]
    r["bound_ms"] = max(t_ops, t_mem) * 1e3
    r["bound_by"] = "operations" if t_ops >= t_mem else "bytes"


def sdpa_inputs(q, k, v, n_valid):
    """(1, BH, N, D) views and the key mask, for the SDPA yardstick (the
    scale is already folded into q)."""
    import torch

    n = q.shape[1]
    mask = torch.zeros(n, dtype=torch.bool, device=q.device)
    mask[:n_valid] = True
    return [t[None] for t in (q, k, v)], mask[None, None, None]


def row_max_window(q, k, n_valid):
    """Smallest and largest row maximum of the logits over the valid keys:
    SDPA computes the static-bound function only while every row maximum
    lies inside [-40, 40]."""
    import torch

    from s3od_torch.ops import flash_attention as fa

    lo, hi = float("inf"), -float("inf")
    kt = k[:, :n_valid].float().transpose(1, 2)
    for i, j in fa.row_chunks(q.shape[1], fa.query_chunk(*q.shape[:2])):
        m = torch.matmul(q[:, i: j].float(), kt).amax(-1)
        lo, hi = min(lo, float(m.min())), max(hi, float(m.max()))
    return lo, hi


def compare(name, got, ref, results, lse=None, norm_tol=None):
    """Relative max error per output; lse (index into the tuples) is
    checked in absolute terms; with `norm_tol`, each other output's
    ||kernel - plain|| / ||plain|| too. Returns the largest absolute
    error."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        check(bool(g.isfinite().all()), f"{name} output {i} not finite")
        err = float((g - r).abs().max())
        worst = max(worst, err)
        if i == lse:
            log(f"  {name} out{i} (lse): max|d| {err:.3e}")
            check(err <= LSE_TOL, f"{name} lse max|d| {err} > {LSE_TOL}")
        else:
            rel = err / max(float(r.abs().max()), 1e-30)
            msg = f"  {name} out{i}: max|d| {err:.3e} rel {rel:.3e}"
            if norm_tol is not None:
                nrm = float((g - r).norm()) / max(float(r.norm()), 1e-30)
                msg += f" rel. norm {nrm:.3e}"
            log(msg)
            check(rel <= REL_TOL, f"{name} out{i} rel {rel} > {REL_TOL}")
            if norm_tol is not None:
                check(nrm <= norm_tol,
                      f"{name} out{i} rel. norm {nrm} > {norm_tol}")
    results.setdefault(name, {"max_abs_err": 0.0})
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], worst)
    return worst


def flash_adversarial(name, randn, k, v, n_valid, results, plant=False):
    """K3/K6 against the plain version on +-1000-scale queries (logits
    ~ +-8000): hot rows saturate the +40 clip; on cold rows (q <= 0,
    k >= 1) every logit sits below -40, so each key below N weighs e^-80,
    those from n_valid to N too, and keys past N (zeros in the kernel's
    last tile) none: o is the mean of v over the N keys, where a key
    weighed wrongly shows. With `plant`, o x 1.01 on each must fail."""
    import torch

    from s3od_torch.ops import flash_attention as fa

    bh, n, d = k.shape
    q_hot = randn(bh, n, d, scale=1000.0)
    cases = (("hot", q_hot, k),
             ("cold", (-q_hot.float().abs()).to(torch.bfloat16),
              (k.float().abs() + 1.0).to(torch.bfloat16)))
    for label, qq, kk in cases:
        log(f"  adversarial {label} (+-1000-scale q)")
        got = fa.flash_attention(qq, kk, v, n_valid)
        ref = fa.flash_attention_plain(qq, kk, v, n_valid)
        compare(name, got, ref, results, lse=1, norm_tol=FLASH_NORM_TOL)
        if plant:
            planted_o(name, got, ref)


def planted_o(name, got, ref):
    """The comparison must fail on the kernel's o x 1.01."""
    o, lse = got
    try:
        compare(f"{name} (planted o x 1.01)", [(o.float() * 1.01).to(o.dtype),
                                               lse], ref, {}, lse=1,
                norm_tol=FLASH_NORM_TOL)
    except RuntimeError as err:
        log(f"  planted o x 1.01 caught: {err}")
        return
    check(False, f"{name}: the planted o x 1.01 went unnoticed")


def time_flash(results, name, kern, plain, lib, q, k, n_valid, iters=20):
    """K3/K6/K8, their plain versions and the SDPA yardstick by the same
    clocks: `ms`, `plain_ms` and `library_ms` from CUDA events around
    `iters` back-to-back calls (`run_ms`), `*event_ms` per call with the
    host's launch (`cuda_ms`), and the profiler's device time beside
    them (`*profiler_ms`; it misread K7, PERF.md section 6). SDPA
    computes the static-bound function only while every row maximum lies
    inside +-40, which is recorded."""
    r = results[name]
    r["ms"], r["event_ms"] = run_ms(kern, iters), cuda_ms(kern, iters)
    rows = kernel_breakdown(kern, iters)
    r["profiler_ms"] = sum(ms for _, ms, _ in rows) if rows else None
    for key, ms, count in rows:
        log(f"    profiler: {key[:90]}: {ms:.4f} ms x{count}")
    r["plain_ms"], r["plain_event_ms"] = run_ms(plain, iters), cuda_ms(plain, iters)
    r["library_ms"], r["library_event_ms"] = run_ms(lib, iters), cuda_ms(lib, iters)
    r["library_profiler_ms"] = device_ms(lib, iters)
    lo, hi = row_max_window(q, k, n_valid)
    r["library_same_function"] = -40.0 <= lo and hi <= 40.0
    log(f"  {name} (CUDA events): kernel {r['ms']:.4f} ms, SDPA "
        f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}; per call "
        f"{r['event_ms']:.4f} / {r['library_event_ms']:.4f}; profiler "
        f"{r['profiler_ms']} / {r['library_profiler_ms']:.4f}; row maxima "
        f"in [{lo:.2f}, {hi:.2f}], inside +-40 (same function): "
        f"{r['library_same_function']}")


def kernel_phases(results):
    import torch

    from s3od_torch import _build
    from s3od_torch.models.dinov3 import _full_tables
    from s3od_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    from s3od_torch.ops import layernorm as ln
    from s3od_torch.ops import mlp_fused as mf
    from s3od_torch.ops import qkv_project as qp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    n_valid, n, c, h, d = 4101, fa.flash_seq_len(4101), 768, 12, 64

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(bf)

    # K1
    log("phase K1 layer_norm (4160 x 768)")
    x = randn(n, c, scale=2.0, shift=0.5)
    w, b = randn(c, scale=0.5, shift=1.0), randn(c, scale=0.2)
    compare("K1_layer_norm", ln.layer_norm(x, w, b, 1e-5),
            ln.layer_norm_plain(x, w, b, 1e-5), results, norm_tol=LN_NORM_TOL)
    check((_build.build_dir() / "triton").is_dir(),
          "Triton's cache must land in the build directory")
    x16 = randn(B16 * n, c, scale=2.0, shift=0.5)
    log(f"  at the batch-16 shape ({B16 * n} x {c})")
    compare("K1_layer_norm", ln.layer_norm(x16, w, b, 1e-5),
            ln.layer_norm_plain(x16, w, b, 1e-5), results, norm_tol=LN_NORM_TOL)
    time_pair("K1_layer_norm", lambda: ln.layer_norm(x, w, b, 1e-5),
              lambda: ln.layer_norm_plain(x, w, b, 1e-5), results)
    results["K1_layer_norm"]["library_ms"] = device_ms(
        lambda: F.layer_norm(x, (c,), w, b, 1e-5))
    set_bound(results, "K1_layer_norm", 0.0, 2 * 2 * n * c + 2 * 2 * c + 8 * n,
              fp32_ops=8.0 * n * c)

    # K2: each shape of the repo's configs, held by max and relative norm,
    # a planted q x 1.01 caught; CUDA-event timings beside F.linear and the
    # unfused route
    wq, bq = k2_phase(results, randn, n, c, h, d, dev)

    # K3
    log(f"phase K3 flash_attention (12 x 4160 x 64, n_valid 4101): the "
        f"{fa.kernel_route(d)} kernel; D = 32 takes the "
        f"{fa.kernel_route(32)} kernel")
    name = "K3_flash_attention"
    q = randn(h, n, d, scale=0.5 * d**-0.5)
    k, v = randn(h, n, d, scale=0.5), randn(h, n, d)
    got = fa.flash_attention(q, k, v, n_valid)
    ref = fa.flash_attention_plain(q, k, v, n_valid)
    compare(name, got, ref, results, lse=1, norm_tol=FLASH_NORM_TOL)
    planted_o(name, got, ref)
    # row maxima pushed near the +40 edge of the window
    smax = float((q.float() @ k.float().transpose(1, 2))[:, :, :n_valid].max())
    q_edge = (q.float() * (35.0 / smax)).to(bf)
    log(f"  edge case: max logit {smax:.2f} -> ~35")
    compare(name, fa.flash_attention(q_edge, k, v, n_valid),
            fa.flash_attention_plain(q_edge, k, v, n_valid), results, lse=1,
            norm_tol=FLASH_NORM_TOL)
    flash_adversarial(name, randn, k, v, n_valid, results, plant=True)
    q16, k16, v16 = (randn(B16 * h, n, d, scale=s)
                     for s in (0.5 * d**-0.5, 0.5, 1.0))
    log(f"  at the batch-16 shape ({B16 * h} x {n} x {d})")
    plain16 = [fa.flash_attention_plain(q16[i: i + h], k16[i: i + h],
                                        v16[i: i + h], n_valid)
               for i in range(0, B16 * h, h)]  # per image: bounded memory
    compare(name, fa.flash_attention(q16, k16, v16, n_valid),
            [torch.cat(t) for t in zip(*plain16)], results, lse=1,
            norm_tol=FLASH_NORM_TOL)
    results[name]["b16_ms"] = run_ms(
        lambda: fa.flash_attention(q16, k16, v16, n_valid), 5)
    log(f"  K3 at batch 16 (CUDA events): {results[name]['b16_ms']:.4f} ms")
    del q16, k16, v16, plain16
    (qs, ks, vs), mask = sdpa_inputs(q, k, v, n_valid)
    time_flash(results, name, lambda: fa.flash_attention(q, k, v, n_valid),
               lambda: fa.flash_attention_plain(q, k, v, n_valid),
               lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, attn_mask=mask, scale=1.0), q, k, n_valid)
    set_bound(results, name, 4.0 * h * n * n * d,
              4 * 2 * h * n * d + 4 * h * n)

    # K4: each shape of the repo's configs and rows of near-zero variance,
    # x' and h held by max and relative norm, planted x' and h faults
    # caught; the kernel, the parent's kernel (with --turns) and the unfused
    # route timed; the 2048^2 shape is among them
    k4_phase(results, randn, n, c, h, d, dev)

    # K5: two wgmma GEMMs a call; each shape of the repo's configs, each
    # launch against its plain half, a planted hidden fault
    f = 4 * c
    k5_phase(results, randn, n, c, f)

    # the Triton passes of K2's, K4's and K5's backwards at the training
    # step's shapes, each against its plain version
    vjp_pass_phase(results, randn, n, c, h, d, dev)

    # K1, K2, K5 at the 2048^2 path's shapes (K4's are in `k4_phase`):
    # 16448 rows, RoPE on the 128 x 128 patch grid
    n2_valid = 16389
    n2 = fa.flash_seq_len(n2_valid)
    log(f"phase K1, K2, K5 at the 2048^2 shapes ({n2} tokens)")
    x2 = randn(n2, c, scale=2.0, shift=0.5)
    compare("K1_layer_norm", ln.layer_norm(x2, w, b, 1e-5),
            ln.layer_norm_plain(x2, w, b, 1e-5), results, norm_tol=LN_NORM_TOL)
    cos2, sin2 = _full_tables(128, 128, d, 100.0, 5, n2, dev)
    args2 = (randn(1, n2, c), wq, bq, cos2, sin2, h, d**-0.5)
    compare("K2_qkv_project_rope", qp.qkv_project_rope(*args2),
            qp.qkv_project_rope_plain(*args2), results, norm_tol=K2_NORM_TOL)
    results["K2_qkv_project_rope"]["at_2048"] = {
        "ms": run_ms(lambda: qp.qkv_project_rope(*args2), 10),
        "library_ms": run_ms(lambda: F.linear(args2[0], wq, bq), 10)}
    log(f"  K2 at 2048^2 (CUDA events): {results['K2_qkv_project_rope']['at_2048']}")
    wu, bu = randn(f, c, scale=0.02), randn(f, scale=0.1)
    wd, bd = randn(c, f, scale=0.02), randn(c, scale=0.1)
    ls2 = randn(c, scale=0.5, shift=1.0)
    args2 = (randn(1, n2, c), wu, bu, wd, bd, randn(1, n2, c), ls2)
    compare("K5_mlp_fused", [mf.mlp_fused(*args2)],
            [mf.mlp_fused_plain(*args2)], results)
    del x2, args2

    # K6: the same kernel as K3 at the 2048^2 length
    name = "K6_flash_attention_stream"
    for d2 in (64, 32):
        log(f"phase K6 flash_attention at 2048^2 ({h} x {n2} x {d2}, "
            f"n_valid {n2_valid}, the {fa.kernel_route(d2)} kernel)")
        q2, k2, v2 = (randn(h, n2, d2, scale=s_) for s_ in
                      (0.5 * d2**-0.5, 0.5, 1.0))
        compare(name, fa.flash_attention(q2, k2, v2, n2_valid),
                fa.flash_attention_plain(q2, k2, v2, n2_valid), results, lse=1,
                norm_tol=FLASH_NORM_TOL)
        flash_adversarial(name, randn, k2, v2, n2_valid, results)
        if d2 == 64:
            (qs, ks, vs), mask = sdpa_inputs(q2, k2, v2, n2_valid)
            time_flash(results, name,
                       lambda: fa.flash_attention(q2, k2, v2, n2_valid),
                       lambda: fa.flash_attention_plain(q2, k2, v2, n2_valid),
                       lambda: F.scaled_dot_product_attention(
                           qs, ks, vs, attn_mask=mask, scale=1.0),
                       q2, k2, n2_valid, iters=5)
            set_bound(results, name, 4.0 * h * n2 * n2 * d2,
                      4 * 2 * h * n2 * d2 + 4 * h * n2)
            del qs, ks, vs
        del q2, k2, v2
        torch.cuda.empty_cache()

    k8_phase(results, randn, n, n_valid, n2, n2_valid)
    for name, r in results.items():
        log(f"  {name}: device time kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms; with host launch (CUDA events) kernel "
            f"{r['event_ms']:.4f} ms, plain {r['plain_event_ms']:.4f} ms")


# ||kernel q, k, v - plain|| / ||plain|| of each K2 call: the two round the
# same fp32 values to bf16 (the sums in another order), about 6e-5 on the
# H100; half the planted q x 1.01 (1.0e-2), which REL_TOL alone sits on the
# edge of (as on K3, PERF.md section 2).
K2_NORM_TOL = 5e-3


def k2_phase(results, randn, n, c, h, d, dev):
    """K2 against its plain version at ViT-B 1024^2 b1 and b16, ViT-L (C =
    1024, 16 heads) and the tiny checkpoints' D = 32 (the mma.sync kernel, by
    the dispatch on D), each output by max error and relative norm, one
    launch counted a call, a planted q x 1.01 caught; then kernel, plain
    version, F.linear of the same product (the library call) and the
    unfused route (F.linear, RoPE, scale and head split in PyTorch) by CUDA
    events around back-to-back calls at b1 and b16, the profiler's device
    time beside them, and the bound. Returns ViT-B's weight and bias."""
    import torch.nn.functional as F

    from s3od_torch.models.dinov3 import _full_tables
    from s3od_torch.ops import qkv_project as qp

    name = "K2_qkv_project_rope"

    def inputs(b, nn, cc, hh, grid):
        dd = cc // hh
        w, bias = randn(3 * cc, cc, scale=0.02), randn(3 * cc, scale=0.1)
        bias[cc: 2 * cc] = 0  # no key bias
        cos, sin = _full_tables(grid, grid, dd, 100.0, 5, nn, dev)
        return (randn(b, nn, cc), w, bias, cos, sin, hh, dd**-0.5)

    def unfused(x, w, bias, cos, sin, hh, scale):
        b, nn, cc = x.shape
        y = F.linear(x, w, bias).view(b, nn, 3, hh, cc // hh).permute(2, 0, 3, 1, 4)
        rope = lambda t: t * cos + qp.rotate_half(t) * sin
        return (rope(y[0]) * scale).to(x.dtype), rope(y[1]).to(x.dtype), y[2].contiguous()

    args = inputs(1, n, c, h, 64)
    r = results.setdefault(name, {"max_abs_err": 0.0})
    cases = (("ViT-B 1024^2 b1", args), ("ViT-B 1024^2 b16", (randn(B16, n, c),) + args[1:]),
             ("ViT-L 1024^2 b1", inputs(1, n, 1024, 16, 64)),
             ("tiny, D = 32", inputs(2, n, 64, 2, 64)))
    for label, a in cases:
        b, nn, cc = a[0].shape
        dd = cc // a[5]
        plan = qp.plan(b, nn, cc)
        log(f"phase K2 qkv_project_rope ({label}: {b} x {nn} x {cc} -> 3 x ({b}, "
            f"{a[5]}, {nn}, {dd}); the {qp.kernel_route(dd)} kernel"
            + (f", {plan['row_tiles']} row tiles a batch element x {plan['col_tiles']} "
               f"of {plan['bn']} columns, grid {plan['grid']})" if dd == 64 else ")"))
        before = qp.qkv_project_rope.launches
        got = qp.qkv_project_rope(*a)
        check(qp.qkv_project_rope.launches == before + 1, "K2 counts one launch a call")
        ref = qp.qkv_project_rope_plain(*a)
        compare(name, got, ref, results, norm_tol=K2_NORM_TOL)
        if label == "ViT-B 1024^2 b1":
            planted = [(got[0].float() * 1.01).to(got[0].dtype)] + list(got[1:])
            try:
                compare(f"{name} (planted q x 1.01)", planted, ref, {},
                        norm_tol=K2_NORM_TOL)
            except RuntimeError as err:
                log(f"  planted q x 1.01 caught: {err}")
            else:
                check(False, "K2: the planted q x 1.01 went unnoticed")
        del got, ref
    timed = {}
    for label, a, iters in (("b1", args, 20), ("b16", cases[1][1], 5)):
        kern = lambda: qp.qkv_project_rope(*a)
        t = {"ms": run_ms(kern, iters),
             "library_ms": run_ms(lambda: F.linear(a[0], a[1], a[2]), iters),
             "unfused_ms": run_ms(lambda: unfused(*a), iters)}
        t["plain_ms"] = run_ms(lambda: qp.qkv_project_rope_plain(*a), max(2, iters // 4))
        timed[label] = t
        log(f"  K2 {label} (CUDA events): kernel {t['ms']:.4f} ms, F.linear "
            f"{t['library_ms']:.4f}, unfused route {t['unfused_ms']:.4f}, plain "
            f"{t['plain_ms']:.4f}")
    r.update(timed["b1"])
    r["b16"] = timed["b16"]
    r["event_ms"] = cuda_ms(lambda: qp.qkv_project_rope(*args))  # with the host's launch
    r["plain_event_ms"] = cuda_ms(lambda: qp.qkv_project_rope_plain(*args))
    r["profiler_ms"] = device_ms(lambda: qp.qkv_project_rope(*args))
    r["library_profiler_ms"] = device_ms(lambda: F.linear(args[0], args[1], args[2]))
    set_bound(results, name, 2.0 * n * c * 3 * c,
              2 * n * c + 2 * 3 * c * c + 2 * 3 * c + 2 * 4 * n * d + 3 * 2 * n * c)
    log(f"  K2 profiler device time {r['profiler_ms']:.4f} ms (F.linear "
        f"{r['library_profiler_ms']:.4f}); bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return args[1], args[2]


# The parent commit's sources (`--turns DIR`), to time each redesigned
# kernel in turns with the kernel it replaced; None without.
TURNS: Path | None = None
# The parent's CUDA sources built into one library each (C symbols renamed),
# all nvcc processes started together, with DIR first on the include path
# so that they build against the parent's hopper.cuh and mma.cuh.
TURNS_SOURCES = {"attn_epilogue.cu": "s3od_attn_epilogue",
                 "flash_attention_bwd.cu": "s3od_flash_attention_bwd",
                 "mask_tail.cu": "s3od_mask_tail"}
_TURNS_LIBS: dict = {}


def turns_library(source: str):
    """The parent's C entry point of TURNS/`source` (renamed `<name>_parent`),
    building every source of TURNS_SOURCES on the first call; None without
    --turns."""
    import ctypes

    from s3od_torch import _build

    if TURNS is None:
        return None
    if not _TURNS_LIBS:
        procs = []
        for src, sym in TURNS_SOURCES.items():
            renamed = TURNS / src.replace(".cu", "_parent.cu")
            renamed.write_text((TURNS / src).read_text().replace(
                f"{sym}(", f"{sym}_parent("))
            so = TURNS / src.replace(".cu", "_parent.so")
            procs.append((src, sym, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(TURNS),
                 "-I", str(_build.CSRC), "-o", str(so), str(renamed)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for src, sym, so, proc in procs:
            out = proc.communicate()[0]
            check(proc.returncode == 0, f"the parent's {src} did not build:\n{out[-3000:]}")
            _TURNS_LIBS[src] = getattr(ctypes.CDLL(str(so)), f"{sym}_parent")
    return _TURNS_LIBS[source]


def turns_k4():
    """The parent's K4 entry point (TURNS/attn_epilogue.cu), or None."""
    import ctypes

    from s3od_torch import _build

    if TURNS is None:
        return None
    fn = turns_library("attn_epilogue.cu")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(a, wo, bo, x, ls, lw, lb, eps):
        import torch

        b, n, c = x.shape
        h = a.shape[0] // b
        xn, hn = torch.empty_like(x), torch.empty_like(x)
        code = fn(a.data_ptr(), wo.data_ptr(), bo.data_ptr(), x.data_ptr(),
                  ls.data_ptr(), lw.data_ptr(), lb.data_ptr(), xn.data_ptr(),
                  hn.data_ptr(), b, n, c, h, c // h, float(eps),
                  _build.stream_ptr(x))
        _build.check(code, "the parent's attn_epilogue")
        return xn, hn

    return call


def turns_k8():
    """The parent's K8 entry point (TURNS/flash_attention_bwd.cu: at D = 128
    the split dkv + dq kernels), as `flash_attention_bwd` calls it, or
    None."""
    import ctypes

    from s3od_torch import _build

    if TURNS is None:
        return None
    fn = turns_library("flash_attention_bwd.cu")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, o, lse, g, n_valid):
        import torch

        q, k, v, o, lse, g = (_build.aligned16(t) for t in (q, k, v, o, lse, g))
        bh, n, d = q.shape
        delta = torch.empty((bh, n), device=q.device, dtype=torch.float32)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        code = fn(*(t.data_ptr() for t in (q, k, v, o, g, lse, delta, dq, dk, dv)),
                  bh, n, d, n_valid, _build.stream_ptr(q))
        _build.check(code, "the parent's flash_attention_bwd")
        return dq, dk, dv

    return call


def turns_k10():
    """The parent's K10 entry point (TURNS/mask_tail.cu), as `mask_tail`
    calls it, or None."""
    import ctypes

    from s3od_torch import _build
    from s3od_torch.ops.experimental.winograd import _empty_like_layout

    if TURNS is None:
        return None
    fn = turns_library("mask_tail.cu")
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w1, b1, w0, b0, k1, bk):
        w1, b1, w0, b0, k1, bk = (_build.aligned16(t) for t in (w1, b1, w0, b0, k1, bk))
        out = _empty_like_layout(x, k1.shape[-1])
        code = fn(*(t.data_ptr() for t in (x, w1, b1, w0, b0, k1, bk, out)),
                  *x.shape, w0.shape[-1], k1.shape[-1], *x.stride(),
                  *out.stride(), _build.stream_ptr(x))
        _build.check(code, "the parent's mask_tail")
        return out

    return call


def turns_e2():
    """The parent's E2 wrapper (Triton), from TURNS/exp_layernorm.py, or
    None."""
    import importlib.util

    if TURNS is None:
        return None
    spec = importlib.util.spec_from_file_location(
        "exp_layernorm_parent", TURNS / "exp_layernorm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.layer_norm_single_pass


def planted_out(name, got, ref, which, tol):
    """The comparison must fail on output `which` x 1.01."""
    bad = list(got)
    bad[which] = (got[which].float() * 1.01).to(got[which].dtype)
    try:
        compare(f"{name} (planted out{which} x 1.01)", bad, ref, {},
                norm_tol=tol)
    except RuntimeError as err:
        log(f"  planted out{which} x 1.01 caught: {err}")
        return
    check(False, f"{name}: the planted out{which} x 1.01 went unnoticed")


def turns(fns, clock, rounds=2):
    """`clock(fn)` of each callable in turns: the order, then the reverse,
    `rounds` times over (a / b / b / a)."""
    out = {k: [] for k in fns}
    order = list(fns)
    for i in range(2 * rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            out[k].append(clock(fns[k]))
    return out


def k4_phase(results, randn, n, c, h, d, dev):
    """K4 against its plain version at ViT-B 1024^2 b1 and b16, 2048^2,
    ViT-L (C = 1024, 16 heads), ViT-S (C = 384, 6 heads), the tiny
    checkpoints' D = 32 (the mma.sync kernel) and ViT-B rows of near-zero
    variance (x = 3 + 1e-3 noise, Wo ~ 1e-5: the variance clamp and the
    cross-block sums matter most there), x' and h each by max error and
    relative norm, one launch counted a call; planted x' x 1.01 and h x
    1.01 caught at b1. Then, at b1, b16 and 2048^2, the kernel, the
    parent's kernel (with --turns) and the unfused route (head permute, F.linear,
    mul-add, F.layer_norm: a yardstick, no one PyTorch call computes K4)
    by CUDA events in turns, both with the card held while the host
    enqueues (`held_ms`, the device's time: the row's `ms`) and around
    plain back-to-back calls (`run_ms`, which follows the host at b1); the
    profiler's device time at b1, the plain version and the bound."""
    import torch.nn.functional as F

    from s3od_torch.ops import attn_epilogue as ae

    name = "K4_attn_epilogue"

    def inputs(b, nn, cc, hh, flat=False):
        dd = cc // hh
        a = randn(b * hh, nn, dd, scale=0.5)
        wo, bo = randn(cc, cc, scale=1e-5 if flat else 0.02), randn(cc, scale=0.1)
        x = randn(b, nn, cc, scale=1e-3, shift=3.0) if flat else randn(b, nn, cc)
        ls, lw = randn(cc, scale=0.5, shift=1.0), randn(cc, scale=0.5, shift=1.0)
        return (a, wo, bo, x, ls, lw, randn(cc, scale=0.2), 1e-5)

    def unfused(a, wo, bo, x, ls, lw, lb, eps):
        b, nn, cc = x.shape
        a2 = a.view(b, a.shape[0] // b, nn, -1).permute(0, 2, 1, 3).reshape(b, nn, cc)
        xn = x + F.linear(a2, wo, bo) * ls
        return xn, F.layer_norm(xn, (cc,), lw, lb, eps)

    n2 = 16448
    args = inputs(1, n, c, h)
    cases = {"ViT-B 1024^2 b1": args, "ViT-B 1024^2 b16": inputs(B16, n, c, h),
             "ViT-B 2048^2 b1": inputs(1, n2, c, h),
             "ViT-L 1024^2 b1": inputs(1, n, 1024, 16),
             "ViT-S 1024^2 b1": inputs(1, n, 384, 6),
             "tiny, D = 32": inputs(2, n, 64, 2),
             "ViT-B b1, near-zero variance rows": inputs(1, n, c, h, flat=True)}
    r = results.setdefault(name, {"max_abs_err": 0.0})
    for label, a in cases.items():
        b, nn, cc = a[3].shape
        dd = cc // (a[0].shape[0] // b)
        plan = ae.plan(b, nn, cc, dd)
        log(f"phase K4 attn_epilogue ({label}: {b * cc // dd} x {nn} x {dd} -> 2 x "
            f"({b}, {nn}, {cc}); the {plan['route']} kernel"
            + (f": {plan['row_tiles']} row tiles, {plan['blocks']} blocks of "
               f"{plan['block_cols']} columns, {plan['consumers']} consumer warpgroups, "
               f"{plan['stages']} stages, {plan['smem']} B of shared memory)"
               if dd == 64 else ")"))
        before = ae.attn_epilogue.launches
        got = ae.attn_epilogue(*a)
        check(ae.attn_epilogue.launches == before + 1, "K4 counts one launch a call")
        ref = ae.attn_epilogue_plain(*a)
        compare(name, got, ref, results, norm_tol=LN_NORM_TOL)
        if label == "ViT-B 1024^2 b1":
            planted_out(name, got, ref, 0, LN_NORM_TOL)
            planted_out(name, got, ref, 1, LN_NORM_TOL)
        del got, ref
    parent = turns_k4()
    timed = {}
    for label, key, iters in (("ViT-B 1024^2 b1", "b1", 20), ("ViT-B 1024^2 b16", "b16", 5),
                              ("ViT-B 2048^2 b1", "2048", 10)):
        a = cases[label]
        fns = {"parent": lambda: parent(*a)} if parent is not None else {}
        fns["kernel"] = lambda: ae.attn_epilogue(*a)
        fns["unfused"] = lambda: unfused(*a)
        timed[key] = {}
        for clock, ck in ((lambda fn: held_ms(fn, iters), "held"),
                          (lambda fn: run_ms(fn, iters), "events")):
            t = turns(fns, clock)
            timed[key][ck] = {k: statistics.median(v) for k, v in t.items()}
            timed[key][ck + "_readings"] = t
            log(f"  K4 {key} ({ck}: CUDA events" + (", the card held while the host "
                "enqueues" if ck == "held" else ", back to back") + "; in turns, median): "
                + ", ".join(f"{k} {timed[key][ck][k]:.4f}" for k in fns) + f"; readings {t}")
    del cases
    r["ms"] = timed["b1"]["held"]["kernel"]
    r["event_ms"] = timed["b1"]["events"]["kernel"]
    r["profiler_ms"] = device_ms(lambda: ae.attn_epilogue(*args))
    r["plain_ms"] = run_ms(lambda: ae.attn_epilogue_plain(*args), 5)
    r["plain_event_ms"] = r["plain_ms"]
    r["library_ms"] = None  # no one PyTorch call computes K4
    r["unfused_ms"] = timed["b1"]["held"]["unfused"]
    r["unfused_profiler_ms"] = device_ms(lambda: unfused(*args))
    r["timed"] = timed
    set_bound(results, name, 2.0 * n * c * c,
              2 * h * n * d + 2 * c * c + 3 * 2 * n * c + 4 * 2 * c)
    r["b16_bound_ms"] = (2 * B16 * h * n * d + 2 * c * c + 3 * 2 * B16 * n * c
                         + 4 * 2 * c) / HBM * 1e3
    log(f"  K4 b1 {r['ms']:.4f} ms (held), profiler {r['profiler_ms']:.4f} ms (unfused route "
        f"{r['unfused_profiler_ms']:.4f}); plain {r['plain_ms']:.4f}; bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} (b16 {r['b16_bound_ms']:.4f})")


# ||launch - plain half|| / ||plain half|| of each K5 launch on its own
# inputs: the kernel and the plain version round the same fp32 sums, which
# differ only in their order, so few elements move by one bf16 step; the
# planted hidden x 1.01 reads 1e-2.
K5_HALF_TOL = 5e-3


def k5_phase(results, randn, n, c, f):
    """K5 against its plain version at every shape the repo's configs give
    it (ViT-B at 1024^2 b1, b4 and b16; ViT-L; ViT-S; the tiny fixtures,
    also at a ragged 100 rows), each of its two launches against its plain
    half on its own inputs (`mlp_up_plain` on x, `mlp_down_plain` on the
    kernel's hidden), one launch counted per call, a planted fault (the
    hidden x 1.01) caught by the up-projection's check, and the timings at
    b1 and b16 beside the unfused cuBLAS MLP and the bound."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops import mlp_fused as mf

    name = "K5_mlp_fused"
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["half_rel"] = 0.0

    def weights(cc, ff):
        return (randn(ff, cc, scale=0.02), randn(ff, scale=0.1),
                randn(cc, ff, scale=0.02), randn(cc, scale=0.1),
                randn(cc, scale=0.5, shift=1.0))

    def half_err(got, ref):
        return float((got.float() - ref.float()).norm()
                     / ref.float().norm())

    timed = {}
    for rows, cc, ff, label in ((n, c, f, "ViT-B 1024^2 b1"),
                                (4 * n, c, f, "ViT-B 1024^2 b4"),
                                (B16 * n, c, f, "ViT-B 1024^2 b16"),
                                (n, 1024, 4096, "ViT-L"),
                                (n, 384, 1536, "ViT-S"),
                                (n, 64, 128, "tiny"),
                                (100, 64, 128, "tiny, 100 rows")):
        plan = mf.plan(rows, cc, ff)
        log(f"phase K5 mlp_fused ({label}: {rows} x {cc}, F {ff}; tiles "
            f"up {plan['up']['tiles']} of 128 x {plan['up']['bn']}, down "
            f"{plan['down']['tiles']} of 128 x {plan['down']['bn']})")
        wu, bu, wd, bd, ls = weights(cc, ff)
        x, res = randn(1, rows, cc), randn(1, rows, cc)
        before = mf.mlp_fused.launches
        out, h = mf.mlp_fused(x, wu, bu, wd, bd, res, ls, return_hidden=True)
        check(mf.mlp_fused.launches == before + 1,
              "K5 counts one launch per call")
        compare(name, [out], [mf.mlp_fused_plain(x, wu, bu, wd, bd, res, ls)],
                results)
        h_ref = mf.mlp_up_plain(x, wu, bu)
        down_ref = mf.mlp_down_plain(h, wd, bd, res, ls)
        compare(name, [h, out], [h_ref, down_ref], results)
        errs = half_err(h, h_ref), half_err(out, down_ref)
        log(f"  launches vs their plain halves (rel. norm): up {errs[0]:.3e}, "
            f"down {errs[1]:.3e} (limit {K5_HALF_TOL})")
        check(max(errs) <= K5_HALF_TOL, f"K5 half rel {max(errs)} > {K5_HALF_TOL}")
        r["half_rel"] = max(r["half_rel"], *errs)
        if label == "ViT-B 1024^2 b1":
            # rounding against fp64: the share of bf16 outputs whose
            # rounding differs from fp64's, each launch on its own inputs
            h64 = torch.matmul(x.double(), wu.double().t()) + bu.double()
            h64 = 0.5 * h64 * (1 + torch.erf(h64 * 0.5**0.5))
            o64 = res.double() + (torch.matmul(h.double(), wd.double().t())
                                  + bd.double()) * ls.double()
            flips = {name_: float((got != ref.to(got.dtype)).float().mean())
                     for name_, got, ref in (
                         ("up", h, h64), ("up plain", h_ref, h64),
                         ("down", out, o64), ("down plain", down_ref, o64))}
            log("  outputs rounded otherwise than fp64: " + ", ".join(
                f"{k_} {100 * v_:.4f}%" for k_, v_ in flips.items()))
            r["fp64_flips"] = flips
            del h64, o64
            planted = half_err((h.float() * 1.01).to(h.dtype), h_ref)
            log(f"  planted hidden x 1.01: {planted:.3e} (must exceed "
                f"{K5_HALF_TOL})")
            check(planted > K5_HALF_TOL, "the planted K5 hidden fault passed")
            r["planted_half_rel"] = planted
        if label in ("ViT-B 1024^2 b1", "ViT-B 1024^2 b16"):
            kern = lambda: mf.mlp_fused(x, wu, bu, wd, bd, res, ls)
            unfused = lambda: res + F.linear(F.gelu(F.linear(x, wu, bu)),
                                             wd, bd) * ls
            bound = 4.0 * rows * cc * ff / PEAK_BF16 * 1e3
            ms, unf = run_ms(kern), run_ms(unfused)
            timed[label] = {"ms": ms, "unfused_bf16_ms": unf, "bound_ms": bound,
                            "bound_pct": 100 * bound / ms,
                            "hidden_mb": 2 * rows * ff / 1e6}
            log(f"  K5 {ms:.4f} ms (CUDA events), unfused bf16 MLP (cuBLAS) "
                f"{unf:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%); "
                f"hidden {2 * rows * ff / 1e6:.1f} MB")
            if label == "ViT-B 1024^2 b1":
                time_pair(name, kern,
                          lambda: mf.mlp_fused_plain(x, wu, bu, wd, bd, res, ls),
                          results)
                r["unfused_bf16_ms"] = device_ms(unfused)
                r["library_ms"] = None  # no one call: see unfused
                set_bound(results, name, 4.0 * rows * cc * ff,
                          3 * 2 * rows * cc + 2 * 2 * cc * ff + 2 * (ff + 2 * cc))
                log(f"  profiler device time: K5 {r['ms']:.4f} ms, unfused "
                    f"{r['unfused_bf16_ms']:.4f} ms")
        del x, res, out, h, h_ref, down_ref
        torch.cuda.empty_cache()
    r["timed"] = timed


# ||pass - plain|| / ||plain|| of each bf16 output of the backward passes
# (dy, dxn, du, h): the two round the same fp32 values to bf16 and differ
# only where erf's, exp's or rsqrt's last fp32 bits do, so few elements
# move by one bf16 step (4.7e-6 to 1.1e-5 in two runs at ViT-B 1024^2 b4
# on an H100 80GB HBM3 at 700 W); half the planted x 1.01 (1.0e-2).
# VJP_SUM_TOL: the fp32 column sums, which differ in summation order alone
# (1.5e-7 to 1.9e-7 there); a thousandth of the planted x 1.01.
VJP_NORM_TOL = 5e-3
VJP_SUM_TOL = 1e-5
VJP_PASSES = ("K2_vjp_rope_bwd", "K4_vjp_ln_bwd", "K5_vjp_gelu_bwd")


def vjp_passes():
    """The Triton pass of each written-out backward (K2, K4, K5), one
    launch a backward."""
    from s3od_torch.ops import attn_epilogue, mlp_fused, qkv_project

    return dict(zip(VJP_PASSES, (qkv_project.rope_bwd, attn_epilogue.ln_bwd,
                                 mlp_fused.gelu_bwd)))


def vjp_pass_phase(results, randn, n, c, h, d, dev):
    """The Triton passes of K2's, K4's and K5's backwards against their
    plain versions at the training step's shapes (ViT-B 1024^2 b4: 16640
    rows, C = 768, F = 3072, 12 heads of 64, the step's RoPE tables), on
    inputs made as the backward makes them (K5's u and dh by the same
    fp32-accumulating products): each bf16 output by max error and
    relative norm (VJP_NORM_TOL), each fp32 column sum by relative norm
    (VJP_SUM_TOL), one launch counted a call, an output x 1.01 caught.
    Timed by the profiler beside the plain version, with the bound (bytes:
    each input read once, each output and the per-program sums written
    once, the sums read once more)."""
    import torch

    from s3od_torch.models.dinov3 import _full_tables
    from s3od_torch.ops import attn_epilogue as ae
    from s3od_torch.ops import mlp_fused as mf
    from s3od_torch.ops import qkv_project as qp
    from s3od_torch.ops.autograd import mm_f32, scale_rows

    b, f = 4, 4 * c
    rows = b * n
    cos, sin = _full_tables(64, 64, d, 100.0, 5, n, dev)
    wu, bu = randn(f, c, scale=c**-0.5), randn(f, scale=0.1)
    wd, ls = randn(c, f, scale=f**-0.5), randn(c, scale=0.3, shift=1.0)
    x_ln, g = randn(rows, c), randn(rows, c, scale=1e-3)
    cases = {
        "K2_vjp_rope_bwd": (
            qp.rope_bwd, qp.rope_bwd_plain,
            (*(randn(b, h, n, d, scale=1e-3) for _ in range(3)), cos, sin,
             d**-0.5),
            # gq, gk, gv read; dy written; tables read; sums twice
            2 * 3 * rows * c + 2 * 3 * rows * c + 2 * 4 * n * d
            + 2 * 4 * b * -(-n // qp.BWD_TOKENS) * 3 * c,
            4.0 * 2 * rows * c),
        "K4_vjp_ln_bwd": (
            ae.ln_bwd, ae.ln_bwd_plain,
            (randn(b, n, c, scale=2.0, shift=0.5), randn(b, n, c, scale=1e-3),
             randn(b, n, c, scale=1e-3), randn(c, scale=0.3, shift=1.0), 1e-6),
            # x', gx, gh read; dxn written; sums twice
            2 * 3 * rows * c + 2 * rows * c
            + 2 * 4 * -(-rows // ae.BWD_ROWS) * 3 * c,
            16.0 * rows * c),
        "K5_vjp_gelu_bwd": (
            mf.gelu_bwd, mf.gelu_bwd_plain,
            (mm_f32(x_ln, wu.t()), mm_f32(g, scale_rows(ls, wd)), bu),
            # u, dh read (fp32); du, h written (bf16); sums twice
            8 * rows * f + 4 * rows * f
            + 2 * 4 * -(-rows // mf.BWD_ROWS) * f,
            20.0 * rows * f),
    }
    del x_ln, g
    for name, (kern, plain, args, nbytes, fp32_ops) in cases.items():
        log(f"phase {name} ({kern.__name__} at ViT-B 1024^2 b4: {rows} rows, "
            f"C {c}, F {f})")
        before = kern.launches
        got = kern(*args)
        check(kern.launches == before + 1, f"{name} counts one launch a call")
        ref = plain(*args)
        nb = len(got) - 1  # the last output is the fp32 column sums
        check(all(t.dtype == torch.bfloat16 for t in got[:nb])
              and got[-1].dtype == torch.float32, f"{name} output dtypes")
        compare(name, got[:nb], ref[:nb], results, norm_tol=VJP_NORM_TOL)
        compare(name, got[nb:], ref[nb:], results, norm_tol=VJP_SUM_TOL)
        planted_out(name, got[:nb], ref[:nb], 0, VJP_NORM_TOL)
        planted_out(name, got[nb:], ref[nb:], 0, VJP_SUM_TOL)
        time_pair(name, lambda: kern(*args), lambda: plain(*args), results)
        r = results[name]
        r["library_ms"] = None  # no one PyTorch call computes the pass
        set_bound(results, name, 0.0, nbytes, fp32_ops=fp32_ops)
        log(f"  {name}: {r['ms']:.4f} ms (profiler), plain {r['plain_ms']:.4f}; "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({nbytes / 1e6:.1f} MB; {100 * r['bound_ms'] / r['ms']:.0f}%)")
        del got, ref
    del cases
    torch.cuda.empty_cache()


def k8_phase(results, randn, n, n_valid, n2, n2_valid):
    """K8 against its plain version: the training shapes (ViT-B at 1024^2,
    batch 1 and 4; the tiny checkpoint's D = 32) and the 2048^2 length,
    n_valid < N, the padded rows' cotangent zero as the tap slice makes
    it, and adversarial rows held to the plain version too: hot and cold
    +-1000-scale queries, and cold rows near the window (logits ~ -50);
    timed by CUDA events with the plain version, the SDPA backward and
    the bound at batch 4."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops import flash_attention as fa

    name = "K8_flash_attention_bwd"

    def case(bh, nn_, nv, d):
        q, k, v, g = (randn(bh, nn_, d, scale=s_)
                      for s_ in (0.5 * d**-0.5, 0.5, 1.0, 1.0))
        g[:, nv:] = 0
        o, lse = fa.flash_attention(q, k, v, nv)
        return q, k, v, o, lse, g

    for bh, nn_, nv, d in ((12, n, n_valid, 64), (48, n, n_valid, 64),
                           (12, n, n_valid, 32), (12, n2, n2_valid, 64)):
        log(f"phase K8 flash_attention_bwd ({bh} x {nn_} x {d}, n_valid {nv}; "
            f"the {fa.kernel_route(d)} kernels)")
        q, k, v, o, lse, g = case(bh, nn_, nv, d)
        compare(name, fa.flash_attention_bwd(q, k, v, o, lse, g, nv),
                fa.flash_attention_bwd_plain(q, k, v, o, lse, g, nv), results)
        q_hot = randn(bh, nn_, d, scale=1000.0)
        q_cold = (-q_hot.float().abs()).to(torch.bfloat16)
        k_pos = (k.float().abs() + 1.0).to(torch.bfloat16)
        # cold rows near the window: logits about -50, so lse = -40 + log N
        # and p = exp(min(s - lse, 0)) is small but not zero
        q_cool = torch.full_like(q, -0.15 * 64 / d)
        k_cool = (k.float().abs() * 0.5 + 5.0).to(torch.bfloat16)
        for label, qq, kk in (("hot, +-1000-scale q", q_hot, k),
                              ("cold, +-1000-scale q", q_cold, k_pos),
                              ("cold, logits ~ -50", q_cool, k_cool)):
            log(f"  adversarial {label}")
            oo, ll = fa.flash_attention(qq, kk, v, nv)
            compare(name, fa.flash_attention_bwd(qq, kk, v, oo, ll, g, nv),
                    fa.flash_attention_bwd_plain(qq, kk, v, oo, ll, g, nv),
                    results)
            del oo, ll
        if bh == 48:
            (qs, ks, vs), mask = sdpa_inputs(q, k, v, nv)
            qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, vs))
            out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                 scale=1.0)
            time_flash(results, name,
                       lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, nv),
                       lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, g, nv),
                       lambda: torch.autograd.grad(out, (qs, ks, vs), g[None],
                                                   retain_graph=True),
                       q, k, nv, iters=5)
            set_bound(results, name, 5 * 2.0 * bh * nn_ * nn_ * d,
                      8 * 2 * bh * nn_ * d + 4 * bh * nn_)
            del qs, ks, vs, out
        elif nn_ == n2:
            results[name]["ms_2048"] = run_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, nv), 3)
            log(f"  K8 at 2048^2 (CUDA events): {results[name]['ms_2048']:.4f} ms")
        elif d == 64:
            results[name]["ms_b1"] = run_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, nv))
            log(f"  K8 at batch 1 (CUDA events): {results[name]['ms_b1']:.4f} ms")
        del q, k, v, o, lse, g, q_hot, q_cold, k_pos, q_cool, k_cool
        torch.cuda.empty_cache()


K7 = "K7_flash_attention_online"


def k7_inputs(randn, bh, n, d, kind="normal"):
    """q (pre-scaled, as the MMDiT's attention hands it over), k, v.
    "adversarial": every query row is a_i u and every key c_j u for one
    unit vector u, with c_j rising from -400 to 400 along the keys, so the
    logits a_i c_j reach +-600 and each row's maximum grows tile by tile:
    a static-bound kernel (clip at +-40) is wrong there, and one that
    skipped the rescale would overflow."""
    import torch

    if kind == "normal":
        return (randn(bh, n, d, scale=d**-0.5), randn(bh, n, d),
                randn(bh, n, d))
    u = torch.nn.functional.normalize(randn(d).float(), dim=0)
    a = torch.linspace(0.5, 1.5, n, device=u.device)
    c = torch.linspace(-400.0, 400.0, n, device=u.device)
    q = (a[None, :, None] * u).expand(bh, n, d)
    k = (c[None, :, None] * u).expand(bh, n, d)
    k = k + 0.05 * randn(bh, n, d).float()
    return (q.to(torch.bfloat16).contiguous(), k.to(torch.bfloat16),
            randn(bh, n, d))


def k7_phase(results):
    """K7 against its plain version at the MMDiT's shapes (24 heads of
    D = 128): the 1024^2 joint sequence (512 + 4096 = 4608 tokens), the
    concept stream (2 + 4096 = 4098 tokens padded to 4160), the 832 x 1024
    bucket (512 + 3328 = 3840), a D = 64 shape (ViT-L at 1024^2: 16 heads,
    4101 tokens) and the adversarial set; at each shape the kernel's
    device time beside its bound and SDPA's (scale 1 on the pre-scaled q,
    the key mask where n_valid < N)."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    r = results.setdefault(K7, {"max_abs_err": 0.0})
    r["shapes"] = {}
    for bh, n, nv, d in ((24, 4608, 4608, 128), (24, 4160, 4098, 128),
                         (24, 3840, 3840, 128), (16, 4160, 4101, 64)):
        log(f"phase K7 flash_attention_online ({bh} x {n} x {d}, n_valid {nv})")
        q, k, v = k7_inputs(randn, bh, n, d)
        compare(K7, fa.flash_attention_online(q, k, v, nv),
                fa.flash_attention_online_plain(q, k, v, nv), results, lse=1)
        qa, ka, va = k7_inputs(randn, bh, n, d, "adversarial")
        smax = float(torch.matmul(qa[:1, -64:].float(),
                                  ka[0, :nv].float().T).amax())
        log(f"  adversarial: logits up to {smax:.1f}, row maxima rising "
            f"along the keys")
        compare(K7, fa.flash_attention_online(qa, ka, va, nv),
                fa.flash_attention_online_plain(qa, ka, va, nv), results,
                lse=1)
        del qa, ka, va
        (qs, ks, vs), mask = sdpa_inputs(q, k, v, nv)
        sdpa_mask = mask if nv < n else None
        kern = lambda: fa.flash_attention_online(q, k, v, nv)
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=sdpa_mask, scale=1.0)
        ms, lib = run_ms(kern), run_ms(sdpa)
        prof = device_ms(kern, 10)
        bound = 4.0 * bh * n * n * d / PEAK_BF16 * 1e3
        r["shapes"][f"{bh}x{n}x{d}/{nv}"] = {"ms": ms, "library_ms": lib,
                                             "bound_ms": bound,
                                             "bound_pct": 100 * bound / ms,
                                             "profiler_ms": prof}
        log(f"  K7 {ms:.4f} ms (profiler {prof:.4f}), bound {bound:.4f} ms "
            f"(4 BH N^2 D at 989 TFLOP/s, {100 * bound / ms:.1f}%), SDPA "
            f"{lib:.4f} ms")
        if n == 4608:
            plain = lambda: fa.flash_attention_online_plain(q, k, v, nv)
            r.update(ms=ms, plain_ms=run_ms(plain, 5), library_ms=lib,
                     profiler_ms=prof, event_ms=cuda_ms(kern),
                     plain_event_ms=cuda_ms(plain, 5))
            set_bound(results, K7, 4.0 * bh * n * n * d,
                      4 * 2 * bh * n * d + 4 * bh * n)
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# The experiments of benchmarks/ (E1-E4), s3od_torch.experiments
# ----------------------------------------------------------------------------

# ||kernel - plain|| / ||plain|| of o per call, for each template instance
# of E1/E3a/E4: two bf16 roundings of o are at most 2^-8 apart; the planted
# o x 1.01 reads 1e-2.
E_CALL_TOL = 5e-3
# Exponentials per second on the H100's special-function units: 3.9e12
# (FlashAttention-3, Shah et al. 2024, arXiv 2407.08608).
EXP_RATE = 3.9e12


def e_held(label, e, lse=False):
    """A script's kernel-vs-plain numbers for one variant against REL_TOL
    (and LSE_TOL for lse); a NaN fails."""
    msg = f"  {label}: max|d| {e['max_abs_err']:.3e} rel {e['rel_vs_plain']:.3e}"
    log(msg + (f", lse max|d| {e['lse_max_abs_err']:.3e}" if lse else ""))
    check(e["rel_vs_plain"] <= REL_TOL, f"{label} rel {e['rel_vs_plain']} > {REL_TOL}")
    if lse:
        check(e["lse_max_abs_err"] <= LSE_TOL,
              f"{label} lse max|d| {e['lse_max_abs_err']} > {LSE_TOL}")


def e_flash_entry(entry, bh, n, extra_bytes, library_ms=None, window=None):
    """Bound (4 BH N^2 D on the tensor cores against q, k, v, o and
    `extra_bytes`), the exponentials' time at EXP_RATE, and the SDPA
    yardstick's time where given; `window` (the row maxima of the logits)
    says whether SDPA computes the same function under a static bound."""
    set_bound({"e": entry}, "e", 4.0 * bh * n * n * 64,
              4 * 2 * bh * n * 64 + extra_bytes)
    entry["exp_ms"] = bh * n * n / EXP_RATE * 1e3
    entry["library_ms"] = library_ms
    if library_ms is not None:
        entry["library_same_function"] = (
            window is None or -40.0 <= window[0] and window[1] <= 40.0)
    log(f"  {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f}), bound "
        f"{entry['bound_ms']:.4f} ms, exponentials {entry['exp_ms']:.4f} ms, "
        f"SDPA {library_ms}")


def e_call(r_all, label, code, o_k, o_p):
    """One call of template instance `code` against its plain version:
    ||d|| / ||plain|| of o within E_CALL_TOL, and the planted o x 1.01
    caught."""
    o_k, o_p = o_k.float(), o_p.float()
    honest = float((o_k - o_p).norm() / o_p.norm())
    planted = float((o_k * 1.01 - o_p).norm() / o_p.norm())
    log(f"  {label} (instance {code}) per call ||d|| / ||plain||: {honest:.3e}; "
        f"planted o x 1.01: {planted:.3e} (tolerance {E_CALL_TOL})")
    check(honest <= E_CALL_TOL, f"{label} {honest} > {E_CALL_TOL}")
    check(planted > E_CALL_TOL, f"the planted {label} fault (o x 1.01) was not caught")
    r_all.setdefault("per_call", {})[label] = {"code": code, "honest": honest,
                                               "planted": planted}


def e_fold(results, name, variants, row_variant):
    """Row `name` holds the numbers of `row_variant`; every variant's go
    under "variants"; max_abs_err is the largest over them."""
    r = results.setdefault(name, {})
    r.update(variants[row_variant])
    r["row_variant"] = row_variant
    r["variants"] = variants
    r["max_abs_err"] = max(v["max_abs_err"] for v in variants.values())


def smi_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def e2_clock(xl, w, bb, dev, readings=5):
    """E2's kernel, F.layer_norm and (with --turns) the
    parent's Triton kernel by one clock, CUDA events, `readings` of each in
    turns, as min / median / max: "events", 20 calls back to back
    (`run_ms`: the clock `slope_time` and earlier runs used, which follows
    the host's enqueue where that outlasts a call); "warm", the same with
    the card held while the host enqueues (`held_ms`); "cold", each call
    alone after writing a 256 MB buffer that evicts the 50 MB L2, the card
    held likewise (10 calls a reading). Beside them the profiler's device
    time, the host's enqueue time a call (200 calls without a
    synchronisation), and the SM and memory clocks before and after."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.experiments import exp_layernorm

    c = xl.shape[-1]
    wb, bbb = w.to(torch.bfloat16), bb.to(torch.bfloat16)  # F.layer_norm: no fp32 affine on bf16 x
    fns = {"kernel": lambda: exp_layernorm.layer_norm_single_pass(xl, w, bb),
           "F.layer_norm": lambda: F.layer_norm(xl, (c,), wb, bbb, 1e-5)}
    parent = turns_e2()
    if parent is not None:
        fns = {"parent": lambda: parent(xl, w, bb), **fns}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB

    def enqueue_us(fn, calls=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    clocks = {"before": smi_clocks()}
    out = {"clocks": clocks}
    summary = lambda v: {"min": min(v), "median": statistics.median(v), "max": max(v),
                         "readings": v}
    for key, clock in (("events", lambda fn: run_ms(fn, 20)),
                       ("warm", lambda fn: held_ms(fn, 20)),
                       ("cold", lambda fn: held_ms(fn, 10, flush=flush))):
        t = turns(fns, clock, rounds=(readings + 1) // 2)
        out[key] = {k: summary(v[:readings]) for k, v in t.items()}
    clocks["after"] = smi_clocks()
    out["profiler_ms"] = {k: device_ms(fn) for k, fn in fns.items()}
    out["enqueue_us"] = {k: enqueue_us(fn) for k, fn in fns.items()}
    del flush
    for k in fns:
        log(f"  E2 {k} (min / median / max of {readings}, ms): " + "; ".join(
            f"{key} {out[key][k]['min']:.4f} / {out[key][k]['median']:.4f} / "
            f"{out[key][k]['max']:.4f}" for key in ("events", "warm", "cold"))
            + f"; profiler {out['profiler_ms'][k]:.4f}; host enqueue "
            f"{out['enqueue_us'][k]:.1f} us a call")
    log(f"  clocks (SM, memory) before: {clocks['before']}; after: {clocks['after']}")
    return out


def experiments_phase(results):
    """Each script's `main()` once at its defaults on the card, the launches
    of E1-E4 counted around those runs. The mains compare every variant's
    kernel with its plain version and time both (slope between CUDA
    events), E3a at the DIS and the ViT shape. Added here: those numbers
    held to the limits, E3b against its plain version at 1-4 steps and
    timed at 4, the bounds, the exponentials' time, SDPA or F.layer_norm on the
    scripts' own inputs, and one call of each template instance of
    E1/E3a/E4 held to its plain version by relative norm, with a planted
    o x 1.01 caught."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.experiments import (exp_exp2, exp_flash_single,
                                        exp_flash_softmax, exp_layernorm,
                                        flash_variants)
    from s3od_torch.profiling import slope_time

    dev = torch.device("cuda")
    # E1, E3a and E4 share one CUDA kernel behind three wrappers
    wrappers_e = {"E1_flash_softmax": exp_flash_softmax.flash_softmax,
                  "E2_layer_norm_single_pass": exp_layernorm.layer_norm_single_pass,
                  "E3_exp2_flash": exp_exp2.exp2_flash,
                  "E3_exp_loop": exp_exp2.exp_loop,
                  "E4_flash_single": exp_flash_single.flash_single}
    for fn in wrappers_e.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mains = {}
    for mod in (exp_flash_softmax, exp_layernorm, exp_exp2, exp_flash_single):
        log(f"phase {mod.__name__}.main() at its defaults")
        mains[mod.__name__.rsplit(".", 1)[1]] = mod.main([])
    main_s = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers_e.items()}
    log(f"  the four scripts in {main_s:.1f} s; launches {counts}")
    for name, cnt in counts.items():
        check(cnt > 0, f"{name} was not launched by its script")
        results.setdefault(name, {})["launches"] = cnt
    r_all = results["_experiments"] = {"main_s": main_s, "launches": counts}

    # E1 at (96, 4104, 64): q, k ~ 0.3 N(0, 1), v ~ N(0, 1), scale 1/8
    bh, n, scale = 96, 4104, 64 ** -0.5
    q, k, v = exp_flash_softmax.inputs(bh, n, dev)
    log(f"phase E1 flash_softmax ({bh} x {n} x 64)")
    variants = mains["exp_flash_softmax"]
    for var, e in variants.items():
        e_held(f"E1[{var}]", e)
        sdpa_ms = None
        if var == "base":  # the same function: softmax(q k^T / 8) v
            sdpa_ms = run_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale), 10)
        e_flash_entry(e, bh, n, 0, sdpa_ms)
    for var in exp_flash_softmax.VARIANTS:  # instances 0, 2, 6
        e_call(r_all, f"E1 {var}", exp_flash_softmax.softmax_for(var, scale).code,
               exp_flash_softmax.flash_softmax(q, k, v, scale, var),
               exp_flash_softmax.flash_softmax_plain(q, k, v, scale, var))
    e_fold(results, "E1_flash_softmax", variants, "base")
    del q, k, v

    # E4 at (96, 4104, 64): q, k, v ~ N(0, 1), -1e30 on the last 3 keys
    q, k, v, bias = exp_flash_single.inputs(bh, n, dev)
    log(f"phase E4 flash_single ({bh} x {n} x 64, -1e30 on the last 3 keys)")
    window = row_max_window((q.float() * scale).to(torch.bfloat16), k, n - 3)
    (qs, ks, vs), mask = sdpa_inputs(q, k, v, n - 3)
    sdpa_ms = run_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, scale=scale), 10)
    log(f"  row maxima of the logits in [{window[0]:.2f}, {window[1]:.2f}]")
    variants = mains["exp_flash_single"]
    for var, e in variants.items():
        e_held(f"E4[{var}]", e, lse=True)
        e_flash_entry(e, bh, n, 4 * n + 4 * bh * n, sdpa_ms,
                      None if var == "base" else window)
    for var in ("base", "nomax_clip2"):  # instances 0 (bias, lse) and 1
        e_call(r_all, f"E4 {var}", exp_flash_single.softmax_for(var, scale).code,
               exp_flash_single.flash_single(q, k, v, bias, scale, var)[0],
               exp_flash_single.flash_single_plain(q, k, v, bias, scale, var)[0])
    e_fold(results, "E4_flash_single", variants, "nomax_clip2")
    del q, k, v, qs, ks, vs

    # E3a at the DIS shape (the row) and the ViT shape, K3/K6 beside it
    x, flash = exp_exp2.inputs(dev)
    shapes = mains["exp_exp2"]["flash"]
    for tag, (q, k, v) in flash.items():
        bh3, n3, _ = q.shape
        e = shapes[tag]
        log(f"phase E3a exp2_flash [{tag}] ({bh3} x {n3} x 64, blocks "
            f"{e['blocks']}; K3/K6 on the same inputs {e['static_ms']:.4f} ms)")
        e_held(f"E3a[{tag}]", e, lse=True)
        window = row_max_window(exp_exp2._scaled(q, scale), k, n3)
        sdpa_ms = run_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=scale), 10)
        e_flash_entry(e, bh3, n3, 4 * bh3 * n3, sdpa_ms, window)
        blocks = e["blocks"]
        e_call(r_all, f"E3a {tag}", exp_exp2.SOFTMAX.code,
               exp_exp2.exp2_flash(q, k, v, scale, *blocks, n3)[0],
               exp_exp2.exp2_flash_plain(q, k, v, scale, *blocks, n3)[0])
    codes = {c["code"] for c in r_all["per_call"].values()}
    check(codes == set(flash_variants.KERNEL_CODES),
          f"per-call checks cover instances {codes}")
    e_fold(results, "E3_exp2_flash", shapes, "DIS-2048")
    del flash, q, k, v
    torch.cuda.empty_cache()

    # E3b: bit-equal at the script's 16 steps, where exp and exp2 are inf
    # everywhere; so also at 1-4 steps, where exp and exp2 stay finite and
    # move every value at every step: a kernel that drops steps differs
    b, programs, reps = x.shape[0], exp_exp2.LOOP_PROGRAMS, exp_exp2.REPS
    log(f"phase E3b exp_loop ({programs} programs x {b}^2 x {reps})")
    variants = mains["exp_exp2"]["loop"]
    for var, e in variants.items():
        log(f"  E3b[{var}]: bit-equal to plain {e['bit_equal']}, inf positions "
            f"equal {e['inf_positions_equal']} ({e['inf_share']:.3f} inf)")
        check(e["inf_positions_equal"], f"E3b {var}: inf positions differ")
        check(e["bit_equal"], f"E3b {var}: kernel differs from its plain version")
        prev = x
        for r in (1, 2, 3, 4):
            ref = exp_exp2.exp_loop_plain(x, var, r)
            check(torch.equal(exp_exp2.exp_loop(x, var, programs, reps=r), ref),
                  f"E3b {var} at {r} steps differs from its plain version")
            if var in ("exp", "exp2"):
                check(bool(ref[:b].isfinite().all() and (ref[:b] != prev).all()),
                      f"E3b {var}: step {r} does not move every value")
            prev = ref[:b]
        # the 16-step rows of exp and exp2 run on inf from step 5 on: their
        # rate on finite values is read at 4 steps
        e["finite4_ms"] = slope_time(
            lambda _v=var: exp_exp2.exp_loop(x, _v, programs, reps=4),
            lambda o: float(o[::64, ::64].sum()), n_small=2, n_large=10,
            device=dev) * 1e3
        e["finite4_gelem_s"] = programs * 4 * b * b / e["finite4_ms"] / 1e6
        set_bound({"e": e}, "e", 0.0, 4 * b * b + 4 * 8 * b * b,
                  fp32_ops=b * b * reps)
        e.update(library_ms=None, sfu_ms=programs * reps * b * b / EXP_RATE * 1e3)
        log(f"    {e['ms']:.4f} ms ({e['gelem_s']:.1f} Gelem/s), plain "
            f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}); "
            f"4 steps {e['finite4_ms']:.4f} ms ({e['finite4_gelem_s']:.1f} Gelem/s)")
    log("  bit-equal at 1, 2, 3, 4 and 16 steps")
    e_fold(results, "E3_exp_loop", variants, "exp")
    del x

    # E2 at (8, 4104, 768)
    rows, c = 8 * 4104, 768
    xl, w, bb = exp_layernorm.inputs(8, 4104, c, dev)
    log(f"phase E2 layer_norm_single_pass (8 x 4104 x {c})")
    e = mains["exp_layernorm"]
    e_held("E2", e)
    log(f"  E2 (the script's main) rel. norm {e['rel_norm_vs_plain']:.3e}")
    check(e["rel_norm_vs_plain"] <= LN_NORM_TOL,
          f"E2 rel. norm {e['rel_norm_vs_plain']} > {LN_NORM_TOL}")
    y = exp_layernorm.layer_norm_single_pass(xl, w, bb)
    y_ref = exp_layernorm.layer_norm_single_pass_plain(xl, w, bb)
    compare("E2 (direct call)", [y], [y_ref], {}, norm_tol=LN_NORM_TOL)
    planted_out("E2", [y], [y_ref], 0, LN_NORM_TOL)
    del y, y_ref
    set_bound({"e": e}, "e", 0.0, 2 * 2 * rows * c + 8 * c,
              fp32_ops=8.0 * rows * c)
    e.update(e2_clock(xl, w, bb, dev))
    e["ms"], e["library_ms"] = e["warm"]["kernel"]["median"], e["warm"]["F.layer_norm"]["median"]
    log(f"  {e['ms']:.4f} ms (warm median, the card held), plain {e['plain_ms']:.4f}, "
        f"bound {e['bound_ms']:.4f} ({e['bound_by']}), F.layer_norm "
        f"{e['library_ms']:.4f}, base {e['base_ms']:.4f}, mxu {e['mxu_ms']:.4f}; "
        f"the script's slope_time: kernel {e['kernel_ms']:.4f}")
    e_fold(results, "E2_layer_norm_single_pass", {"kernel": e}, "kernel")
    del xl, w, bb
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# The synthetic-data factory (FLUX.1-dev MMDiT, T5-XXL, CLIP-L, FLUX VAE,
# the ViT-L FluxDPT teacher), seeded weights, bf16
# ----------------------------------------------------------------------------

FACTORY_CLASS = "tabby cat"
# Bounds of the accuracy checks (d): 1.5x the values measured on the H100
# (PERF.md, section 2): the full-depth step with K7 against the same step
# with K7's plain version, end to end and per attention call, and the
# 2 dual + 4 single block model's bf16 kernel route against fp32 exact.
# ||a - b|| / ||b|| per output; the inputs and kernels are deterministic.
K7_STEP_TOL = {"velocity": 2.6e-2, "taps": 2.5e-2, "maps": 2.6e-2}
K7_CALL_TOL = {"o": 2.9e-3}
BF16_STEP_TOL = {"velocity": 1.45e-2, "taps": 1.4e-2, "maps": 9.6e-3}


def rel_norm(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def step_errors(got, ref):
    """Relative errors of one MMDiT step's outputs: the velocity, the worst
    feature tap and the concept maps."""
    return {"velocity": rel_norm(got["output"], ref["output"]),
            "taps": max(rel_norm(g, r) for g, r in
                        zip(got["features"], ref["features"])),
            "maps": rel_norm(got["concept_maps"], ref["concept_maps"])}


def within(what, errs, tol) -> bool:
    ok = all(errs[k] <= tol[k] for k in tol)
    log(f"  {what}: " + ", ".join(f"{k} {errs[k]:.3e} (<= {tol[k]:.1e})"
                                   for k in tol) + f" -> {'ok' if ok else 'OUT'}")
    return ok


def factory_models():
    """The configuration `MMDiTConfig` defaults to (FLUX.1-dev: hidden
    3072, 24 heads of 128, 19 dual + 38 single blocks) in bf16, T5-XXL and
    CLIP-L in bf16, the FLUX VAE and the ViT-L teacher of
    `training/config/model/flux_teacher.yaml`, all from seeds, made on the
    card (the teacher on the host, then moved)."""
    import torch

    from s3od_torch.configs import segmentation_config
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.datagen.mask_generator import MaskGenerator
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher
    from s3od_torch.models.mmdit import MMDiTConfig, init_mmdit
    from s3od_torch.models.vae import VAE, VAEConfig, init_vae

    dev = torch.device("cuda")
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    t0 = time.perf_counter()
    mmdit = init_mmdit(MMDiTConfig(), gen(11), dtype=torch.bfloat16)
    text = TorchTextEncoders.random_init(12)
    vcfg = VAEConfig()
    vae = VAE(*init_vae(vcfg, gen(13)), vcfg)
    pipe = ConceptAttentionPipeline(mmdit, text_encoders=text, vae=vae)
    tcfg = FluxTeacherConfig(base=segmentation_config("dinov3_large"))
    teacher = MaskGenerator(model=init_flux_teacher(
        tcfg, torch.Generator().manual_seed(14)))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in mmdit.parameters())
    n_t5 = sum(p.numel() for p in text.t5.parameters())
    log(f"  models made in {time.perf_counter() - t0:.1f} s: MMDiT {n / 1e9:.3f}B "
        f"params bf16, T5 {n_t5 / 1e9:.3f}B bf16; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return pipe, teacher


class StageClock:
    """Wraps the factory's stages with host clocks around synchronised work
    and each MMDiT step with CUDA events and the K7 launches it made."""

    def __init__(self, pipe, teacher):
        import torch

        from s3od_torch.ops import flash_attention as fa

        self.sec = {"text encode": 0.0, "denoise": 0.0, "VAE decode": 0.0,
                    "teacher": 0.0}
        self.calls = {}  # stage -> seconds of each call
        self.steps = []  # (start event, end event, with concepts, K7 launches)
        for obj, name, stage in ((pipe.text_encoders, "encode", "text encode"),
                                 (pipe.text_encoders, "encode_concepts",
                                  "text encode"),
                                 (pipe.vae, "decode", "VAE decode"),
                                 (teacher, "generate_mask", "teacher")):
            setattr(obj, name, self._timed(getattr(obj, name), stage))
        real_step = pipe._step

        def step(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = fa.flash_attention_online.launches
            start.record()
            out = self._timed(real_step, "denoise")(*args)
            end.record()
            self.steps.append((start, end, args[-2] is not None,
                               fa.flash_attention_online.launches - before))
            return out

        pipe._step = step

    def _timed(self, fn, stage):
        import torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.sec[stage] += dt
            self.calls.setdefault(stage, []).append(dt)
            return out
        return run

    def reset(self):
        self.sec = dict.fromkeys(self.sec, 0.0)
        self.calls, self.steps = {}, []

    def step_ms(self):
        """Median device ms of the plain and the concept steps, and the K7
        launches each kind made."""
        plain = [s.elapsed_time(e) for s, e, c, _ in self.steps if not c]
        conc = [s.elapsed_time(e) for s, e, c, _ in self.steps if c]
        launches = {(c, n) for _, _, c, n in self.steps}
        return (statistics.median(plain) if plain else None,
                statistics.median(conc) if conc else None, launches)


def factory_phase(results):
    """(b) the seeded full-size factory through the orchestrator and one
    direct timed `generate` at 1024^2; (c) one `extract_features`; (d) the
    accuracy checks. K7 ran in (a), `k7_phase`."""
    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch.datagen import generate_train_images as gti
    from s3od_torch.ops import flash_attention as fa

    r = results["_factory"] = {}
    log("phase factory: FLUX.1-dev MMDiT (19 dual + 38 single blocks, 24 x "
        "128 heads) + T5-XXL + CLIP-L + FLUX VAE + ViT-L FluxDPT teacher, "
        "seeded weights, bf16, 28 steps (concepts on the last 3)")
    pipe, teacher = factory_models()
    cfg = pipe.cfg
    per_step = cfg.num_dual_blocks + cfg.num_single_blocks
    per_concept_step = per_step + cfg.num_dual_blocks
    per_sample = ((pipe.num_inference_steps - 3) * per_step
                  + 3 * per_concept_step)
    clock = StageClock(pipe, teacher)

    # (b) the orchestrator: one class, 2 samples, jpg + png on disk
    out_dir = REPO / "build" / "chip_smoke_factory"
    subprocess.run(["rm", "-rf", str(out_dir)], check=True)
    gcfg = gti.GenerationConfig(output_dir=str(out_dir / "out"),
                                prompts_dir=str(out_dir / "prompts"),
                                prompts_per_class=2)
    orch = gti.ImageMaskGenerationPipeline(gcfg, pipe, teacher)
    blocks_t = teacher.cfg.base.num_encoder_layers_used
    reset_counts()
    fa.flash_attention_online.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = orch.process_class(FACTORY_CLASS, 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k7 = fa.flash_attention_online.launches
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  process_class: {done} of 2 samples in {wall:.2f} s "
        f"({120.0 / wall:.3f} samples/min), peak {peak:.2f} GiB; K7 launches "
        f"{k7} (want {2 * per_sample}), teacher kernels {counts}")
    check(done == 2, f"the orchestrator wrote {done} of 2 samples")
    for i in range(2):
        stem = f"{FACTORY_CLASS.replace(' ', '_')}_{i:04d}"
        img = out_dir / "out" / "images" / f"{stem}.jpg"
        msk = out_dir / "out" / "masks" / f"{stem}.png"
        check(img.exists() and msk.exists(), f"sample {i}: files missing")
        hw_i, hw_m = Image.open(img).size, Image.open(msk).size
        log(f"  sample {i}: image {hw_i}, mask {hw_m} (W x H)")
        check(hw_i == hw_m, f"sample {i}: image {hw_i} vs mask {hw_m}")
    check(k7 == 2 * per_sample, f"K7 launched {k7}, want {2 * per_sample}")
    for name, cnt in counts.items():
        check(cnt == 2 * blocks_t, f"teacher: {name} launched {cnt}, "
              f"want {2 * blocks_t}")
    results[K7]["launches"] = k7 // 2
    stage_s = dict(clock.sec)
    stage_s["save + host rest"] = wall - sum(stage_s.values())
    r.update(samples=done, process_class_s=wall, samples_per_min=120.0 / wall,
             peak_gib=peak, k7_launches_2_samples=k7, stages_s=stage_s,
             teacher_launches=counts)
    log("  stages (s, both samples): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_s.items()))
    log("  per call (s; the first includes one-time set-up): " + ", ".join(
        f"{k} {[round(x, 3) for x in v]}" for k, v in clock.calls.items()
        if k != "denoise"))
    r["stage_calls_s"] = {k: v for k, v in clock.calls.items()
                          if k != "denoise"}
    del orch
    subprocess.run(["rm", "-rf", str(out_dir)], check=True)

    # one direct generate at 1024^2, outside any catch
    clock.reset()
    fa.flash_attention_online.launches = 0
    t0 = time.perf_counter()
    image, feats, cmaps = pipe.generate("a photograph of a tabby cat",
                                        FACTORY_CLASS, 1024, 1024, 7)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    plain_ms, conc_ms, kinds = clock.step_ms()
    k7 = fa.flash_attention_online.launches
    log(f"  generate 1024^2: {gen_s:.2f} s; step device ms: plain "
        f"{plain_ms:.2f}, concept {conc_ms:.2f}; K7 per step "
        f"{sorted(kinds)}, per sample {k7} (want {per_sample})")
    check(k7 == per_sample, f"K7 launched {k7} per sample, want {per_sample}")
    check(kinds == {(False, per_step), (True, per_concept_step)},
          f"K7 launches per step {kinds}")
    check(image.shape == (1024, 1024, 3) and image.dtype == np.uint8,
          "generate: image shape")
    check(len(feats) == 4 and all(f.shape == (4096, 768) and
                                  np.isfinite(f).all() for f in feats),
          "generate: 4 finite (4096, 768) feature taps")
    for k in ("category", "background"):
        m = cmaps[k]
        check(m.shape == (64, 64) and np.isfinite(m).all()
              and m.min() >= 0.0 and m.max() <= 1.0 + 1e-6,
              f"generate: concept map {k} in [0, 1]")
    r.update(generate_1024_s=gen_s, step_ms_plain=plain_ms,
             step_ms_concept=conc_ms, k7_per_sample=k7,
             generate_stages_s=dict(clock.sec))
    log("  stages of the direct generate (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in clock.sec.items()))
    profile_step(pipe, r)

    # (c) one extract_features at 1024^2: VAE encode + one concept step
    lat = pipe.vae.encode(image)
    fa.flash_attention_online.launches = 0
    ext = pipe.extract_features(lat, "a photograph of a tabby cat",
                                [FACTORY_CLASS, "background"], 1024, 1024)
    torch.cuda.synchronize()
    k7 = fa.flash_attention_online.launches
    maps = np.stack(list(ext.concept_maps.values()))
    log(f"  extract_features: latents {lat.shape}, K7 launches {k7} "
        f"(want {per_concept_step}), maps in [{maps.min():.3f}, {maps.max():.3f}]")
    check(k7 == per_concept_step, f"extract_features: K7 launched {k7}")
    check(all(np.isfinite(f).all() for f in ext.features), "extract: features")
    check(np.isfinite(maps).all() and maps.min() >= 0 and maps.max() <= 1 + 1e-6,
          "extract: maps in [0, 1]")
    r["extract_k7_launches"] = k7

    # the teacher predictor on the fixture photo (bucket-resized), the
    # same parts
    from s3od_torch.evaluation.teacher_predictor import SODTeacherPredictor

    photo = np.array(Image.open(IMAGE).convert("RGB"))
    tpred = SODTeacherPredictor(None, mask_generator=teacher, pipeline=pipe,
                                vae=pipe.vae)
    fa.flash_attention_online.launches = 0
    t0 = time.perf_counter()
    res = tpred.predict(photo, "a photograph", "object")
    torch.cuda.synchronize()
    k7 = fa.flash_attention_online.launches
    log(f"  SODTeacherPredictor.predict on {photo.shape[:2]}: "
        f"{time.perf_counter() - t0:.2f} s, K7 launches {k7}, ious "
        f"{np.round(res.all_ious, 4)}")
    check(res.soft_mask.shape == photo.shape[:2]
          and np.isfinite(res.soft_mask).all() and k7 == per_concept_step,
          "teacher predictor: mask shape, finite, one concept step")
    del teacher, tpred
    torch.cuda.empty_cache()
    accuracy_phase(pipe, r)
    return pipe


def profile_step(pipe, r):
    """Where a concept step's device time goes, by kernel (profiler)."""
    import torch

    inp = step_inputs(pipe, 1024, 1024)
    with torch.inference_mode():
        rows = kernel_breakdown(lambda: pipe.model(**inp), iters=2)
    busy = sum(ms for _, ms, _ in rows)
    log(f"  concept step by kernel (device ms per step, busy {busy:.2f}):")
    for key, ms, count in rows[:10]:
        log(f"    {ms:8.3f} ms x{count:4d}  {key[:100]}")
    r["concept_step_busy_ms"] = busy
    r["concept_step_top"] = [(k[:60], ms, c) for k, ms, c in rows[:10]]


def step_inputs(pipe, height, width, seed=3):
    """One concept step's inputs at the given canvas: T5/CLIP of a real
    prompt and concepts, seeded latents, the schedule's step 25 of 28."""
    import torch

    from s3od_torch.datagen.diffusion import (calculate_shift, make_img_ids,
                                              shifted_sigmas)

    ph, pw = height // 16, width // 16
    dev = pipe.device
    t5, pooled = pipe.text_encoders.encode(["a photograph of a tabby cat"])
    cemb, cpool = pipe.text_encoders.encode_concepts([FACTORY_CLASS,
                                                      "background"])
    g = torch.Generator(device=dev).manual_seed(seed)
    sig = shifted_sigmas(28, calculate_shift(ph * pw))[25]
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(latents=torch.randn(1, ph * pw, pipe.cfg.in_channels,
                                    generator=g, device=dev),
                txt=t(t5), pooled=t(pooled),
                timestep=torch.full((1,), float(sig), device=dev),
                img_ids=t(make_img_ids(ph, pw)),
                txt_ids=torch.zeros(t5.shape[1], 3, device=dev),
                guidance=torch.full((1,), 3.5, device=dev),
                concepts=t(cemb), pooled_concepts=t(cpool),
                concept_layers=pipe.concept_layers,
                compute_dtype=torch.bfloat16)


def accuracy_phase(pipe, r):
    """(d) The full-depth bf16 step with K7 against the same step with
    K7's plain version, and with a planted fault (K7's o x 1.01), which
    must fail the bound; then full width at 2 dual + 4 single blocks, the
    bf16 kernel route against fp32 exact (TF32 off), one concept step."""
    import dataclasses

    import torch

    from s3od_torch.models.mmdit import MMDiT
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops.precision import set_exact_float32

    inp = step_inputs(pipe, 1024, 1024)
    real = fa.flash_attention_online

    def run(kernel):
        # the attention's autograd Function calls K7 through this name
        with standing_in(fa, "flash_attention_online", kernel), \
                torch.inference_mode():
            return pipe.model(**inp)

    def faulty(q, k, v, n_valid):
        o, lse = real(q, k, v, n_valid)
        return o * 1.01, lse

    def shadowed(kernel, worst):
        """`kernel`, and beside each of its calls K7's plain version on
        the same q, k, v: the worst per-call error of o."""
        def call(q, k, v, n_valid):
            o, lse = kernel(q, k, v, n_valid)
            o_ref, _ = fa.flash_attention_online_plain(q, k, v, n_valid)
            worst["o"] = max(worst.get("o", 0.0), rel_norm(o, o_ref))
            return o, lse
        return call

    ref = run(fa.flash_attention_online_plain)
    got = run(real)
    bad = run(faulty)
    e_k7, e_bad = step_errors(got, ref), step_errors(bad, ref)
    ok = within("full-depth step, K7 vs its plain version", e_k7, K7_STEP_TOL)
    within("full-depth step, planted K7 fault (o x 1.01) vs plain", e_bad,
           K7_STEP_TOL)
    del ref, got, bad
    # The same step, each of its 76 attentions held against K7's plain
    # version on that call's inputs: the end-to-end errors above amplify
    # bf16 rounding over 57 blocks of seeded weights, this does not.
    call_k7, call_bad = {}, {}
    run(shadowed(real, call_k7))
    run(shadowed(faulty, call_bad))
    ok_call = within("per call of the full-depth step, K7 vs plain", call_k7,
                     K7_CALL_TOL)
    caught = not within("per call, planted K7 fault (o x 1.01) vs plain",
                        call_bad, K7_CALL_TOL)
    r.update(k7_vs_plain=e_k7, planted_fault=e_bad, per_call_k7=call_k7,
             per_call_fault=call_bad, planted_caught=caught)
    check(ok, "full-depth step: K7 against its plain version out of bound")
    check(ok_call, "per call: K7 against its plain version out of bound")
    check(caught, "the planted K7 fault (o x 1.01) went unnoticed")

    # full width, 2 dual + 4 single blocks: bf16 kernels vs fp32 exact
    cut = dataclasses.replace(pipe.cfg, num_dual_blocks=2, num_single_blocks=4,
                              feature_taps=(0, 1, 2, 3))
    m32 = MMDiT(cut, device="meta", dtype=torch.float32).to_empty(device="cuda")
    src = pipe.model.state_dict()
    with torch.no_grad():
        for name, p in m32.state_dict().items():
            p.copy_(src[name].float())
    m16 = MMDiT(cut, device="cuda", dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    inp_cut = dict(inp, concept_layers=None)
    set_exact_float32()
    with torch.inference_mode():
        got = m16(**inp_cut)
        ref = m32(**dict(inp_cut, compute_dtype=torch.float32))
    e16 = step_errors(got, ref)
    r["bf16_vs_fp32_cut"] = e16
    check(within("2 dual + 4 single blocks, bf16 kernel route vs fp32 exact",
                 e16, BF16_STEP_TOL), "bf16 vs fp32 out of bound")
    del m16, m32
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# The MMDiT's LoRA fine-tuning (datagen/lora.py, flux_finetune.py)
# ----------------------------------------------------------------------------

K8D = "K8_flash_attention_bwd_d128"
LORA_ROOT = REPO / "build" / "chip_smoke_lora"
# The learning rate of the full-width steps. The base is bf16, and the merge
# rounds delta.astype(bf16) into W, as the JAX package's does: at the CLI's
# default 1e-4 one AdamW step moves a delta entry by ~0.25 x 1e-4 (rank 16,
# A ~ N(0, 1) / 16), under half a bf16 step at |W| ~ 0.02 (~6e-5), so the
# step would mostly round away and the loss could not fall; at 1e-3 it
# moves ~4 such steps (the first update still moves every entry of B by
# lr, and the loss rises once before it falls: PERF.md, section 6).
LORA_LR = 1e-3
LORA_STEPS = 8
# ||kernel - plain|| / ||plain|| of each of K8's dq, dk, dv per call at
# D = 128, on random inputs and on every call of a LoRA step: 1.5x the
# worst measured on an H100 80GB HBM3 at 700 W (5.06e-4, a call of the
# 832 x 1216 step; 2.6e-4 on random inputs; PERF.md, section 2), tighter
# than K8's 9.0e-3 at D = 64, where the planted dk x 1.01 (9.75e-3 to
# 9.93e-3) sat within 1e-3 of the limit.
K8D_CALL_TOL = 7.6e-4
# The LoRA gradients (and the loss) of the bf16 kernel route (K7 + K8)
# against the fp32 exact route on 2 dual + 4 single blocks at full width,
# after one update: ||bf16 - fp32|| / ||fp32|| of the A leaves, the B
# leaves and the loss; 1.5x measured on the same card (3.6e-4, 8.3e-3,
# 1.8e-2).
LORA_GRAD_TOL = {"loss": 5.4e-4, "A": 1.25e-2, "B": 2.75e-2}


@contextlib.contextmanager
def standing_in(module, name, fn):
    """`module.name` is `fn` inside the block. The kernel wrappers count
    their launches on whatever their module's name resolves to, so `fn`
    carries a count of its own while it stands in."""
    real = getattr(module, name)
    if not hasattr(fn, "launches"):
        fn.launches = 0
    setattr(module, name, fn)
    try:
        yield fn
    finally:
        setattr(module, name, real)


def lora_dataset(root: Path) -> Path:
    """Three captioned images of at least 1024^2 pixels made from the
    fixture photo: two 1280 x 1280 (the 1024^2 bucket) and one 1000 x 1462
    (the 832 x 1216 bucket), with captions.json in the metadata layout."""
    from PIL import Image

    photo = Image.open(IMAGE).convert("RGB")
    images = root / "data" / "real" / "images"
    images.mkdir(parents=True)
    names = []
    for i, (h, w) in enumerate(((1280, 1280), (1280, 1280), (1000, 1462))):
        im = photo.resize((w, h), Image.LANCZOS)
        if i == 1:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        im.save(images / f"r{i}.png")
        names.append(f"r{i}")
    meta = root / "meta" / "real"
    meta.mkdir(parents=True)
    (meta / "captions.json").write_text(json.dumps(
        [{"image_path": f"{n}.png", "caption": f"a photograph of a tabby cat, view {i}"}
         for i, n in enumerate(names)]))
    return root


def k8d_kernel_checks(results, randn):
    """K8 at D = 128 (the single pass) on K7's lse against its plain version
    at the LoRA step's shapes, (24, 4608, 128) and (24, 4480, 128) with
    n_valid 4464, by max error and relative norm, with a planted dk x 1.01
    and a planted dq x 1.01 caught; at 4608 two calls on the same inputs
    (dk and dv equal, dq within the one-rounding rule: its fp32 sum over
    the key blocks runs in another order each call), and the timing by
    CUDA events beside the plain version, the SDPA backward, the bound
    and, with --turns, the parent's split kernels in turns."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops import flash_attention as fa

    r = results.setdefault(K8D, {"max_abs_err": 0.0})
    worst = 0.0
    for bh, n, nv in ((24, 4608, 4608), (24, 4480, 4464)):
        log(f"phase K8 at D = 128 ({bh} x {n} x 128, n_valid {nv}; the "
            f"{fa.kernel_route(128)} single pass, plan {fa.bwd_plan(bh, n, 128, nv)})")
        q, k, v, g = (randn(bh, n, 128, scale=s) for s in (128**-0.5, 1.0, 1.0, 1.0))
        for t in (q, k, v, g):
            t[:, nv:] = 0  # the padded rows, as multi_head_attention pads
        o, lse = fa.flash_attention_online(q, k, v, nv)
        got = fa.flash_attention_bwd(q, k, v, o, lse, g, nv)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, nv)
        compare(K8D, got, ref, results, norm_tol=K8D_CALL_TOL)
        worst = max(worst, max(rel_norm(a, b) for a, b in zip(got, ref)))
        for which, name in ((1, "dk"), (0, "dq")):
            bad = list(got)
            bad[which] = (got[which].float() * 1.01).to(got[which].dtype)
            try:
                compare(f"{K8D} (planted {name} x 1.01)", bad, ref, {},
                        norm_tol=K8D_CALL_TOL)
            except RuntimeError as err:
                log(f"  planted {name} x 1.01 caught: {err}")
            else:
                check(False, f"K8 at D = 128: the planted {name} x 1.01 went unnoticed")
        if n == 4608:
            again = fa.flash_attention_bwd(q, k, v, o, lse, g, nv)
            d = (again[0].float() - got[0].float()).abs()
            mag = torch.maximum(again[0].float().abs(), got[0].float().abs())
            ulps = d / torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
            rerun = {"dk_equal": bool(torch.equal(again[1], got[1])),
                     "dv_equal": bool(torch.equal(again[2], got[2])),
                     "dq_max_abs": float(d.max()),
                     "dq_max_over_max": float(d.max() / got[0].float().abs().max()),
                     "dq_differing": float((d > 0).float().mean()),
                     "dq_max_ulps": float(ulps.max())}
            r["rerun"] = rerun
            log(f"  two calls on the same inputs: {rerun}")
            check(rerun["dk_equal"] and rerun["dv_equal"], "K8 D = 128: dk or dv differ "
                  "between two calls on the same inputs")
            check(rerun["dq_max_over_max"] <= 2.0**-7 and rerun["dq_differing"] < 0.01,
                  f"K8 D = 128: dq differs between two calls beyond one rounding {rerun}")
            del again, d, mag, ulps
            (qs, ks, vs), _ = sdpa_inputs(q, k, v, nv)
            qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, vs))
            out = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
            time_flash(results, K8D,
                       lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, nv),
                       lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, g, nv),
                       lambda: torch.autograd.grad(out, (qs, ks, vs), g[None],
                                                   retain_graph=True),
                       q, k, nv, iters=5)
            set_bound(results, K8D, 5 * 2.0 * bh * n * n * 128,
                      8 * 2 * bh * n * 128 + 4 * bh * n)
            r["exp_ms"] = 2.0 * bh * n * n / EXP_RATE * 1e3
            log(f"  K8 D = 128: {r['ms']:.4f} ms against the bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}; "
                f"{100 * r['bound_ms'] / r['ms']:.1f}%), the exponentials "
                f"{r['exp_ms']:.4f}, SDPA backward {r['library_ms']:.4f}")
            parent = turns_k8()
            if parent is not None:
                pg = parent(q, k, v, o, lse, g, nv)
                compare(f"{K8D} (the parent's)", pg, ref, {}, norm_tol=K8D_CALL_TOL)
                t = turns({"parent": lambda: parent(q, k, v, o, lse, g, nv),
                           "new": lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, nv),
                           "sdpa": lambda: torch.autograd.grad(
                               out, (qs, ks, vs), g[None], retain_graph=True)},
                          lambda f: run_ms(f, 10))
                r["turns"] = t
                r["parent_ms"] = statistics.mean(t["parent"])
                r["turns_ms"] = statistics.mean(t["new"])
                log(f"  in turns (CUDA events, 10 calls each): parent {t['parent']}, "
                    f"single pass {t['new']}, SDPA backward {t['sdpa']}")
                del pg
            del qs, ks, vs, out
        else:
            r["ms_4480"] = run_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, nv), 5)
            log(f"  K8 D = 128 at (24, 4480): {r['ms_4480']:.4f} ms")
        del q, k, v, g, o, lse, got, ref
        torch.cuda.empty_cache()
    r["rel_norm_random"] = worst


def lora_batch(pipe, sample, text):
    """One sample as the CLI batches it: VAE latents of the bucket-resized
    image, packed; T5 / CLIP of the caption (encoded beforehand); RoPE
    ids of the packed grid."""
    import numpy as np
    import torch

    from PIL import Image

    from s3od_torch.datagen.diffusion import make_img_ids, pack_latents
    from s3od_torch.datagen.resizer import FluxResizer

    dev = pipe.device
    image = np.array(Image.open(sample["image"]).convert("RGB"))
    resized, hw = FluxResizer().resize_image(image)
    lat = torch.as_tensor(pipe.vae.encode(resized), device=dev)
    t5, pooled = text[sample["caption"]]
    ph, pw = lat.shape[1] // 2, lat.shape[2] // 2
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return hw, {"latents": pack_latents(lat), "txt": as_t(t5),
                "pooled": as_t(pooled), "img_ids": as_t(make_img_ids(ph, pw)),
                "txt_ids": torch.zeros(t5.shape[1], 3, device=dev)}


def lora_grad_agreement(pipe, batch, r):
    """(d) The LoRA gradients of the bf16 kernel route (K7 + K8) against
    the fp32 exact route, on full-width 2 dual + 4 single blocks of the
    seeded model, at one 1024^2 sample and one fixed draw, after one
    AdamW update from init (B = 0 at init makes dA exactly zero)."""
    import dataclasses

    import torch

    from s3od_torch.datagen import lora as L
    from s3od_torch.models.mmdit import MMDiT
    from s3od_torch.ops.precision import set_exact_float32

    cut = dataclasses.replace(pipe.cfg, num_dual_blocks=2, num_single_blocks=4,
                              feature_taps=(0, 1, 2, 3))
    dev = pipe.device
    m32 = MMDiT(cut, device="meta", dtype=torch.float32).to_empty(device=dev)
    src = pipe.model.state_dict()
    with torch.no_grad():
        for name, p in m32.state_dict().items():
            p.copy_(src[name].float())
    m16 = MMDiT(cut, device=dev, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    set_exact_float32()
    lcfg = L.LoRAConfig()
    gen = lambda: torch.Generator(device=dev).manual_seed(21)
    lora = L.init_lora_params(gen(), m16, lcfg)
    step = L.make_lora_train_step(m16, lcfg, L.lora_optimizer(lora, LORA_LR))
    step(lora, batch, gen())
    m32.requires_grad_(False)

    def grads(model, dtype):
        for p in L.lora_parameters(lora):
            p.grad = None
        loss = L.lora_loss(model, lora, lcfg, batch, gen(), compute_dtype=dtype)
        loss.backward()
        ps = L.lora_parameters(lora)
        return {"loss": loss.detach().reshape(1),
                "A": torch.cat([p.grad.flatten() for p in ps[::2]]),
                "B": torch.cat([p.grad.flatten() for p in ps[1::2]])}

    from s3od_torch.ops import flash_attention as fa

    k7, k8 = fa.flash_attention_online.launches, fa.flash_attention_bwd.launches
    g16 = grads(m16, torch.bfloat16)
    k7, k8 = fa.flash_attention_online.launches - k7, fa.flash_attention_bwd.launches - k8
    g32 = grads(m32, torch.float32)
    err = {k: rel_norm(g16[k], g32[k]) for k in g32}
    r["grad_bf16_vs_fp32"] = err
    log(f"  (d) 2 dual + 4 single blocks, K7 + K8 launches {k7} + {k8} (want 6 + 6)")
    check(k7 == 6 and k8 == 6, f"(d) K7/K8 launched {k7}/{k8}, want 6/6")
    check(within("LoRA gradients, bf16 kernel route vs fp32 exact", err,
                 LORA_GRAD_TOL), f"LoRA gradient agreement {err}")
    del m16, m32, lora, step
    torch.cuda.empty_cache()


def lora_phase(results, pipe):
    """The MMDiT's LoRA fine-tuning on the seeded FLUX.1-dev model of
    `factory_phase` (bf16), K7 forward and K8 backward at D = 128 on
    every attention: (a) full-width steps through `make_lora_train_step`
    at the 1024^2 bucket (4096 + 512 = 4608 tokens; K7 and K8 exactly 57
    launches a step; the loss at one fixed draw falls over 8 steps; step
    ms, img/s, peak GiB without and with per-block recomputation, the
    idle share); (b) one step at the 832 x 1216 bucket (3952 + 512 = 4464
    tokens, padded to 4480); (c) every K8 call of a step at each bucket
    against its plain version, with planted dk x 1.01 and dq x 1.01
    caught, and K8 at D = 128 timed against its bound and the SDPA
    backward; (d) gradient
    agreement, bf16 kernels vs fp32 exact; (e) the adapters written by
    `save_native` and loaded by `ConceptAttentionPipeline(lora=path)`,
    which generates one 1024^2 image; (f) `flux_finetune.run` end to end
    on the card at the tiny MMDiT configuration."""
    import numpy as np
    import torch

    from s3od_torch.convert import load_native, save_factory_npz, save_native
    from s3od_torch.datagen import flux_finetune as ff
    from s3od_torch.datagen import lora as L
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.ops import flash_attention as fa

    log("phase LoRA: FLUX.1-dev MMDiT (seeded, bf16), rank 16, alpha 16, "
        f"AdamW lr {LORA_LR} (weight decay 1e-4), K7 + K8 at D = 128")
    r = results["_lora"] = {}
    dev = pipe.device
    subprocess.run(["rm", "-rf", str(LORA_ROOT)], check=True)
    root = lora_dataset(LORA_ROOT)
    samples = ff.collect_samples(str(root / "data"), ["real"], str(root / "meta"))
    check(len(samples) == 3, f"collect_samples found {len(samples)} of 3")
    prompt = "a photograph of a tabby cat"
    concepts = [FACTORY_CLASS, "background"]
    text = {s["caption"]: pipe.text_encoders.encode([s["caption"]]) for s in samples}
    emb = pipe.text_encoders.encode([prompt])
    cemb, cpool = pipe.text_encoders.encode_concepts(concepts)
    # T5-XXL is no longer needed: the captions are encoded
    pipe.text_encoders.t5 = None
    torch.cuda.empty_cache()
    (hw0, b0), (hw1, _), (hw2, b2) = (lora_batch(pipe, s, text) for s in samples)
    log(f"  samples: buckets {hw0}, {hw1}, {hw2}; tokens "
        f"{b0['latents'].shape[1]} + {b0['txt'].shape[1]}, "
        f"{b2['latents'].shape[1]} + {b2['txt'].shape[1]}")
    check(hw0 == (1024, 1024) and hw2 == (832, 1216), "bucket of the samples")

    gen = torch.Generator(device=dev).manual_seed(0)
    k8d_kernel_checks(results, lambda *s, scale=1.0: (
        torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16))

    model = pipe.model
    blocks = model.cfg.num_dual_blocks + model.cfg.num_single_blocks
    lcfg = L.LoRAConfig()
    lora = L.init_lora_params(torch.Generator(device=dev).manual_seed(0), model, lcfg)
    opt = L.lora_optimizer(lora, LORA_LR)
    step = L.make_lora_train_step(model, lcfg, opt)
    fixed = lambda: torch.Generator(device=dev).manual_seed(5)

    # (a) 8 steps on one sample at one fixed draw, each a run of the main path
    losses, times, counts = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LORA_STEPS):
        fa.flash_attention_online.launches = fa.flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(lora, b0, fixed())))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append((fa.flash_attention_online.launches,
                       fa.flash_attention_bwd.launches))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        final = float(L.lora_loss(model, lora, lcfg, b0, fixed()))
    step_ms = 1e3 * statistics.median(times[1:])
    log(f"  (a) 1024^2 steps: loss at the fixed draw {[round(x, 5) for x in losses]}"
        f" -> {final:.5f} after {LORA_STEPS}; step {step_ms:.1f} ms (median of "
        f"{LORA_STEPS - 1}; first {1e3 * times[0]:.1f}), {1e3 / step_ms:.3f} img/s, "
        f"peak {peak:.2f} GiB; K7, K8 launches a step {sorted(set(counts))}")
    check(all(c == (blocks, blocks) for c in counts),
          f"K7/K8 launches a step {counts}, want {blocks} each")
    check(final < losses[0], f"the LoRA loss did not fall: {losses} -> {final}")
    results[K8D]["launches"] = counts[-1][1]
    r.update(losses=losses, loss_after=final, step_ms=step_ms,
             first_step_ms=1e3 * times[0], img_per_s=1e3 / step_ms,
             peak_gib=peak, launches_per_step=counts[-1])
    # The adapters after (a): (b) and (c) compare K8 per call at this state,
    # however many profiled and recomputed steps move it in between.
    adapters = L.lora_parameters(lora)
    after_a = [t.detach().clone() for t in adapters]

    # the step's device time by kernel and the idle share
    rows = kernel_breakdown(lambda: step(lora, b0, fixed()), 1)
    busy = sum(ms for _, ms, _ in rows)
    r.update(busy_ms=busy, idle_share=1 - busy / step_ms,
             top=[(k[:60], ms, c) for k, ms, c in rows[:10]])
    log(f"  step by kernel (device ms, busy {busy:.1f} of {step_ms:.1f}: idle "
        f"{100 * (1 - busy / step_ms):.1f}%):")
    for key, ms, cnt in rows[:10]:
        log(f"    {ms:8.3f} ms x{cnt:4d}  {key[:100]}")

    # the same step with each block recomputed in the backward
    remat = L.make_lora_train_step(model, lcfg, opt, remat=True)
    remat(lora, b0, fixed())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_online.launches = fa.flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    remat(lora, b0, fixed())
    torch.cuda.synchronize()
    r.update(remat_step_ms=1e3 * (time.perf_counter() - t0),
             remat_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             remat_launches=(fa.flash_attention_online.launches,
                             fa.flash_attention_bwd.launches))
    log(f"  with remat: step {r['remat_step_ms']:.1f} ms, peak "
        f"{r['remat_peak_gib']:.2f} GiB, K7, K8 launches {r['remat_launches']}")
    check(r["remat_launches"] == (2 * blocks, blocks), "remat launches")

    # (b), (c) a step at each bucket, every K8 call against its plain version
    real = fa.flash_attention_bwd
    for tag, batch in (("1024^2", b0), ("832 x 1216", b2)):
        with torch.no_grad():
            for t, a in zip(adapters, after_a):
                t.copy_(a)
        seen = {"calls": 0, "err": 0.0, "planted": 1.0, "planted_dq": 1.0, "n": set()}

        def shadow(q, k, v, o, lse, g, n_valid):
            got = real(q, k, v, o, lse, g, n_valid)
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, g, n_valid)
            seen["calls"] += 1
            seen["n"].add((tuple(q.shape), n_valid))
            seen["err"] = max(seen["err"], *(rel_norm(a, b) for a, b in zip(got, ref)))
            seen["planted"] = min(seen["planted"], rel_norm(got[1] * 1.01, ref[1]))
            seen["planted_dq"] = min(seen["planted_dq"], rel_norm(got[0] * 1.01, ref[0]))
            seen["max_abs"] = max(seen.get("max_abs", 0.0), *(
                float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)))
            return got

        with standing_in(fa, "flash_attention_bwd", shadow):
            loss = float(step(lora, batch, fixed()))
        log(f"  ({'c' if batch is b0 else 'b'}) {tag} step: loss {loss:.5f}; "
            f"{seen['calls']} K8 calls at {sorted(seen['n'])}, worst rel. norm "
            f"vs plain {seen['err']:.3e} (<= {K8D_CALL_TOL}); planted dk, dq x 1.01 "
            f"read {seen['planted']:.3e}, {seen['planted_dq']:.3e} at their least")
        check(seen["calls"] == blocks and shadow.launches == blocks,
              f"{tag}: {seen['calls']} K8 calls, {shadow.launches} launches")
        check(seen["err"] <= K8D_CALL_TOL, f"{tag}: K8 vs plain {seen['err']}")
        check(seen["planted"] > K8D_CALL_TOL, f"{tag}: the planted dk x 1.01 "
              "went unnoticed")
        check(seen["planted_dq"] > K8D_CALL_TOL, f"{tag}: the planted dq x 1.01 "
              "went unnoticed")
        check(np.isfinite(loss), f"{tag}: loss not finite")
        r[f"k8_calls_{tag}"] = {"calls": seen["calls"], "rel_norm": seen["err"],
                                "max_abs_err": seen["max_abs"],
                                "planted_rel_norm": seen["planted"],
                                "planted_dq_rel_norm": seen["planted_dq"],
                                "shapes": sorted(seen["n"])}
        check(all(s == (24, 4608 if batch is b0 else 4480, 128)
                  and nv == (4608 if batch is b0 else 4464)
                  for s, nv in seen["n"]), f"{tag}: K8 shapes {seen['n']}")

    # (e) the adapters on disk, merged by the pipeline, one 1024^2 image
    path = str(LORA_ROOT / "flux_lora.npz")
    save_native(path, lora, {"alpha": np.float32(lcfg.alpha),
                             "rank": np.int32(lcfg.rank),
                             "pack_order": np.bytes_(L.PACK_ORDER)})
    tree, meta = load_native(path)
    check(float(meta["alpha"]) == 16.0 and int(meta["rank"]) == 16,
          "adapter state")
    probe = model.dual_blocks[1].img_attn.qkv.weight
    before = float(probe.float().square().sum())
    lpipe = ConceptAttentionPipeline(model, text_encoders=pipe.text_encoders,
                                     vae=pipe.vae, lora=path, device=dev)
    name = "dual_blocks.1.img_attn.qkv.weight"
    moved = rel_norm(lpipe.merged[name], probe)
    fa.flash_attention_online.launches = 0
    t0 = time.perf_counter()
    out = lpipe(prompt, height=1024, width=1024, seed=7, concepts=concepts,
                prompt_embeds=emb, concept_embeds=cemb, concept_pooled=cpool)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    k7 = fa.flash_attention_online.launches
    want = (pipe.num_inference_steps - 3) * blocks + 3 * (blocks + model.cfg.num_dual_blocks)
    log(f"  (e) adapters written and merged by the pipeline (||W' - W|| / "
        f"||W|| {moved:.3e} on {name}); generate 1024^2 in {gen_s:.2f} s, "
        f"K7 launches {k7} (want {want})")
    check(moved > 0, "the merged weights equal the base")
    check(float(probe.float().square().sum()) == before, "the merge changed the base")
    check(k7 == want, f"LoRA generate: K7 launched {k7}, want {want}")
    check(out.image.shape == (1024, 1024, 3) and out.image.dtype == np.uint8,
          "LoRA generate: image")
    check(all(np.isfinite(f).all() for f in out.features), "LoRA generate: taps")
    r.update(merged_rel_change=moved, generate_s=gen_s, generate_k7=k7)
    del lpipe, out

    # (d) gradient agreement on 2 dual + 4 single blocks
    lora_grad_agreement(pipe, b0, r)

    # (f) the CLI end to end on the card, at the tiny configuration
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models.mmdit import init_mmdit, tiny_mmdit_config
    from s3od_torch.models.text_encoders import CLIPTextConfig, T5Config
    from s3od_torch.models.vae import VAE, init_vae, tiny_vae_config

    tcfg = tiny_mmdit_config()
    tiny = init_mmdit(tcfg, torch.Generator(device=dev).manual_seed(31))
    save_factory_npz(str(LORA_ROOT / "tiny_mmdit.npz"), tiny, tcfg)
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
        """64^2 images: the tiny VAE's 32 x 32 latents, 256 image tokens
        (with 32 text tokens under the flash route's 1024: head_dim 24)."""

        def resize_image(self, image):
            from PIL import Image

            return np.array(Image.fromarray(image).resize((64, 64))), (64, 64)

    conf = dict(flux_checkpoint=str(LORA_ROOT / "tiny_mmdit.npz"),
                input_dir=str(root / "data"), datasets=["real"],
                metadata_dir=str(root / "meta"), rank=4, steps=3, lr=1e-3,
                out_lora=str(LORA_ROOT / "tiny_lora.npz"), device=str(dev))
    (LORA_ROOT / "finetune.yaml").write_text(json.dumps(conf))
    t0 = time.perf_counter()
    out_path = ff.run(str(LORA_ROOT / "finetune.yaml"), _vae=vae, _text=enc,
                      _resizer=SmallBuckets())
    cli_s = time.perf_counter() - t0
    tree, meta = load_native(out_path)
    leaves = [np.asarray(x) for d in tree["dual_blocks"] + tree["single_blocks"]
              for x in _leaves(d)]
    log(f"  (f) flux_finetune.run on the card (tiny MMDiT, 3 steps): {cli_s:.2f} s, "
        f"{len(leaves)} adapter tensors, state {sorted(meta)}")
    check(len(leaves) == 2 * (4 * tcfg.num_dual_blocks + 2 * tcfg.num_single_blocks)
          and all(np.isfinite(x).all() for x in leaves)
          and any(np.abs(x).max() > 0 for x in leaves[1::2]),
          "CLI adapters: count, finite, B trained")
    check(bytes(np.asarray(meta["pack_order"])) == L.PACK_ORDER, "CLI pack_order")
    ConceptAttentionPipeline(tiny, text_encoders=enc, vae=vae, lora=out_path,
                             device=dev)
    r["cli_s"] = cli_s
    subprocess.run(["rm", "-rf", str(LORA_ROOT)], check=True)


def _leaves(node):
    """A LoRA block's {'A', 'B'} leaves in order (nested dicts)."""
    if "A" in node:
        return [node["A"], node["B"]]
    return [x for v in node.values() for x in _leaves(v)]


def wrappers():
    """Kernel wrapper per kernel of the main path; K3 and K6 are one CUDA
    kernel behind one wrapper, told apart by the path that runs it."""
    from s3od_torch.ops import (attn_epilogue, flash_attention, layernorm,
                                mlp_fused, qkv_project)

    return {
        "K1_layer_norm": layernorm.layer_norm,
        "K2_qkv_project_rope": qkv_project.qkv_project_rope,
        "K3_flash_attention": flash_attention.flash_attention,
        "K4_attn_epilogue": attn_epilogue.attn_epilogue,
        "K5_mlp_fused": mlp_fused.mlp_fused,
    }


def launch_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def k8_launches() -> int:
    from s3od_torch.ops.flash_attention import flash_attention_bwd

    return flash_attention_bwd.launches


def reset_counts():
    from s3od_torch.ops.flash_attention import flash_attention_bwd

    for fn in [*wrappers().values(), *vjp_passes().values()]:
        fn.launches = 0
    flash_attention_bwd.launches = 0


def iou(a, b) -> float:
    import numpy as np

    inter = np.logical_and(a > 0.5, b > 0.5).sum()
    union = np.logical_or(a > 0.5, b > 0.5).sum()
    return float(inter / union) if union else 1.0


def test_images(image):
    """16 images of varied aspect and content from the fixture."""
    import numpy as np

    h, w = image.shape[:2]
    imgs = []
    for i in range(16):
        im = image
        if i % 2:
            im = im[:, ::-1]
        if i % 4 >= 2:
            im = im[::-1]
        top, left = (i * 7) % (h // 4), (i * 11) % (w // 4)
        im = im[top: h - (i % 3) * h // 8, left: w - (i % 5) * w // 16]
        if i % 8 >= 4:
            im = im.transpose(1, 0, 2)
        imgs.append(np.ascontiguousarray(im))
    return imgs


def slice_phase(results):
    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch import BackgroundRemoval
    from s3od_torch.configs import segmentation_config
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    image = np.array(Image.open(IMAGE).convert("RGB"))
    cfg = segmentation_config("dinov3_base")
    per_forward = cfg.num_encoder_layers_used
    log(f"phase slice: DINOv3-ViT-B/16 + DPT, seeded weights, 1024^2, "
        f"{per_forward} blocks per forward")
    model = init_weights_(S3ODSegmentation(cfg), torch.Generator().manual_seed(0))
    model32 = copy.deepcopy(model)
    pred = BackgroundRemoval.from_model(model, image_size=1024, device="cuda")
    check(pred.compute_dtype == torch.bfloat16, "default dtype on CUDA is bf16")

    reset_counts()
    res = pred.remove_background(image)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  remove_background launches: {counts}")
    for name, cnt in counts.items():
        check(cnt == per_forward, f"{name} launched {cnt} times, want {per_forward}")
        results[name]["launches"] = cnt
    check(res.predicted_mask.shape == image.shape[:2], "mask shape")
    check(res.all_masks.shape[0] == 3 and res.all_ious.shape == (3,), "3 masks")
    check(bool(np.isfinite(res.all_masks).all() and np.isfinite(res.all_ious).all()),
          "slice output not finite")
    check(res.rgba_image.mode == "RGBA", "RGBA result")
    np.testing.assert_array_equal(res.predicted_mask,
                                  res.all_masks[int(res.all_ious.argmax())])

    imgs = test_images(image)
    reset_counts()
    batch = pred.remove_background_batch(imgs)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  remove_background_batch(16) launches: {counts}")
    for name, cnt in counts.items():
        check(cnt == per_forward, f"batch: {name} launched {cnt}, want {per_forward}")
    check(len(batch) == 16, "16 results")
    for im, r in zip(imgs, batch):
        check(r.predicted_mask.shape == im.shape[:2], "batch mask shape")
        check(bool(np.isfinite(r.all_masks).all()), "batch output not finite")
    d_bm, tap_b = batch_checks(pred, imgs, batch)

    # throughput, host clock around whole calls (each ends in a readback)
    n1, n16 = 20, 4
    pred.remove_background(image)
    t0 = time.perf_counter()
    for _ in range(n1):
        pred.remove_background(image)
    b1 = n1 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(n16):
        pred.remove_background_batch(imgs)
    b16 = 16 * n16 / (time.perf_counter() - t0)
    log(f"  throughput end to end: batch 1 {b1:.3f} img/s, batch 16 {b16:.3f} img/s")
    results["_slice"] = {"img_s_b1": b1, "img_s_b16": b16}
    # device time of the forward alone (normalize -> sigmoid, on canvases)
    c16 = np.stack([pred._preprocess(im)[0] for im in imgs])
    forward_profile(pred, pred._preprocess(image)[0][None], "b1",
                    results["_slice"], iters=20)
    forward_profile(pred, c16, "b16", results["_slice"])
    results["_slice"]["peak_gib_b16"] = peak_gib(pred, c16)
    log(f"  peak memory at batch 16: {results['_slice']['peak_gib_b16']:.2f} GiB")

    # agreement with the port's float32 exact mode on the card
    pred32 = BackgroundRemoval.from_model(model32, image_size=1024,
                                          device="cuda", dtype="float32")
    tap_err = tap_errors("bf16 kernel route vs fp32 exact", cfg.tap_layers,
                         encoder_taps(pred, c16[:4], "kernel"),
                         encoder_taps(pred32, c16[:4], "exact"), TAP_TOL)
    reset_counts()
    res32 = pred32.remove_background(image)
    check(all(v == 0 for v in launch_counts().values()),
          "float32 exact mode must not launch the bf16 kernels")
    agree = float(((res.all_masks > 0.5) == (res32.all_masks > 0.5)).mean())
    d_iou = float(np.abs(res.all_ious - res32.all_ious).max())
    d_mask = float(np.abs(res.all_masks - res32.all_masks).max())
    log(f"  bf16 vs fp32 exact: thresholded mask agreement {agree:.6f}, "
        f"max|d iou score| {d_iou:.3e}, max|d soft mask| {d_mask:.3e}, "
        f"ious bf16 {res.all_ious} fp32 {res32.all_ious}")
    # how much the thresholded agreement can say: seeded random weights
    # put the soft masks near 0.5
    dist = np.abs(res32.all_masks - 0.5)
    near = {tol: float((dist <= tol).mean()) for tol in (d_mask, 1e-2, 1e-1)}
    log(f"  fp32 soft masks: range [{res32.all_masks.min():.4f}, "
        f"{res32.all_masks.max():.4f}], share of pixels within "
        + ", ".join(f"{t:.1e}: {v:.4f}" for t, v in near.items()) + " of 0.5")
    check(agree >= 0.99, f"bf16/fp32 mask agreement {agree} < 0.99")
    check(d_iou <= 2e-2, f"bf16/fp32 IoU score diff {d_iou} > 2e-2")
    results["_slice"].update(agreement=agree, d_iou=d_iou, d_mask=d_mask,
                             near_half=near[1e-2], tap_rel_err=tap_err,
                             batch_vs_single=d_bm, batch_vs_single_taps=tap_b)
    return pred, pred32


def stream_img_s(pred, images, **kwargs) -> float:
    """End-to-end img/s of `remove_background_stream` over `images`, after
    one warm-up image (host clock; the stream ends in readbacks)."""
    import torch

    list(pred.remove_background_stream(images[:1], **kwargs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(pred.remove_background_stream(images, **kwargs))
    rate = len(out) / (time.perf_counter() - t0)
    check(len(out) == len(images), "stream lost results")
    return rate


def peak_gib(pred, canvas) -> float:
    """Peak device memory (GiB) of one forward on a uint8 canvas batch."""
    import torch

    x = torch.from_numpy(canvas).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred._forward_device(x, "full")
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def forward_profile(pred, canvas, tag, results_slot, iters=5):
    """Device time of one forward (normalize -> sigmoid) on a uint8 canvas
    batch: CUDA events around it, and the profiler's kernel breakdown."""
    import torch

    x = torch.from_numpy(canvas).cuda()
    fwd = lambda: pred._forward_device(x, "full")
    span = cuda_ms(fwd, iters=iters)
    rows = kernel_breakdown(fwd, iters=3)
    busy = sum(ms for _, ms, _ in rows)
    log(f"  forward {tag}: {span:.3f} ms between CUDA events, device busy "
        f"{busy:.3f} ms (idle {100 * (1 - busy / span):.1f}%); by kernel "
        f"(device ms per forward):")
    for key, ms, count in rows[:12]:
        log(f"    {ms:8.3f} ms x{count:3d}  {key[:100]}")
    results_slot.update({f"fwd_ms_{tag}": span, f"busy_ms_{tag}": busy,
                         f"top_{tag}": [(k[:60], ms) for k, ms, _ in rows[:8]]})


def highres_phase(results):
    """The 2048^2 path: the stream API at full ViT-B width, K1-K5 per
    image, payload agreement, fp32 taps, and the tiny checkpoint through
    SODPredictor."""
    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch import BackgroundRemoval
    from s3od_torch.configs import segmentation_config
    from s3od_torch.evaluation.predictor import SODPredictor
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    image = np.array(Image.open(IMAGE).convert("RGB"))
    cfg = segmentation_config("dinov3_base")
    per_image = cfg.num_encoder_layers_used
    log("phase high-res: DINOv3-ViT-B/16 + DPT, seeded weights, 2048^2 "
        "(16389 tokens), remove_background_stream(batch=1, payload='best', "
        "upload='bucket')")
    model = init_weights_(S3ODSegmentation(cfg), torch.Generator().manual_seed(0))
    model32 = copy.deepcopy(model)
    pred = BackgroundRemoval.from_model(model, image_size=2048, device="cuda")
    imgs = test_images(image)[:4]

    reset_counts()
    streamed = list(pred.remove_background_stream(
        imgs, batch=1, payload="best", upload="bucket"))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  stream of {len(imgs)} images, launches: {counts}")
    check(len(streamed) == len(imgs), "stream result count")
    want = per_image * len(imgs)
    for name, cnt in counts.items():
        check(cnt == want, f"2048 stream: {name} launched {cnt}, want {want}")
    results["K6_flash_attention_stream"]["launches"] = counts["K3_flash_attention"]

    d_best = d_iou = 0.0
    for im, res in zip(imgs, streamed):
        full = pred.remove_background(im)
        check(res.all_masks.shape == (1,) + im.shape[:2], "best payload shape")
        check(bool(np.isfinite(res.predicted_mask).all()), "2048 mask not finite")
        d_best = max(d_best, float(np.abs(res.predicted_mask
                                          - full.predicted_mask).max()))
        d_iou = max(d_iou, float(np.abs(res.all_ious - full.all_ious).max()))
    log(f"  stream payload 'best' vs remove_background(payload='full'): "
        f"max|d best mask| {d_best:.3e} (bound {BEST_TOL:.3e}), "
        f"max|d iou score| {d_iou:.3e}")
    check(d_best <= BEST_TOL, f"2048 best vs full mask diff {d_best}")
    check(d_iou <= 1e-5, f"2048 stream IoU scores differ by {d_iou}")

    hr = results["_highres"] = {"best_vs_full": d_best, "iou_vs_full": d_iou}
    hr["stream_img_s_b1"] = stream_img_s(pred, imgs * 2, batch=1,
                                         payload="best", upload="bucket")
    log(f"  remove_background_stream 2048^2 end to end: "
        f"{hr['stream_img_s_b1']:.3f} img/s (8 images, batch 1, 'best', bucket)")
    canvas = pred._preprocess(image)[0][None]
    forward_profile(pred, canvas, "2048_b1", hr)
    hr["peak_gib_b1"] = peak_gib(pred, canvas)
    log(f"  peak memory of a 2048^2 forward: {hr['peak_gib_b1']:.2f} GiB")

    pred32 = BackgroundRemoval.from_model(model32, image_size=2048,
                                          device="cuda", dtype="float32")
    canvases = [pred._preprocess(im)[0][None] for im in imgs[:2]]
    got = [encoder_taps(pred, c, "kernel") for c in canvases]
    ref = [encoder_taps(pred32, c, "exact") for c in canvases]
    hr["tap_rel_err"] = tap_errors(
        "2048^2 bf16 kernel route vs fp32 exact", cfg.tap_layers,
        [torch.cat(t) for t in zip(*got)], [torch.cat(t) for t in zip(*ref)],
        TAP_TOL)
    del pred, pred32, model32, got, ref
    torch.cuda.empty_cache()

    log("  tiny checkpoint (D = 32) through SODPredictor at 2048^2")
    sod = SODPredictor(str(TINY_1024), image_size=2048, device="cuda")
    sod32 = SODPredictor(str(TINY_1024), image_size=2048, device="cuda",
                         dtype="float32")
    check(sod.compute_dtype == torch.bfloat16, "SODPredictor bf16 on CUDA")
    reset_counts()
    res = sod.predict(image)
    counts = launch_counts()
    want = sod.cfg.num_encoder_layers_used
    check(all(v == want for v in counts.values()), f"SODPredictor launches {counts}")
    res32 = sod32.predict(image)
    gt = np.array(Image.open(MASK).convert("L")) > 128
    check(res.soft_mask.shape == image.shape[:2] and res.num_masks == 3,
          "SODPredictor result shape")
    check(bool(np.isfinite(res.soft_mask).all()), "SODPredictor mask not finite")
    canvas = sod._letterbox(image)[0][None]
    hr["tiny_tap_rel_err"] = tap_errors(
        "tiny 2048^2 SODPredictor bf16 vs fp32", sod.cfg.tap_layers,
        encoder_taps(sod.predictor, canvas, "kernel"),
        encoder_taps(sod32.predictor, canvas, "exact"), TAP_TOL)
    hr["tiny_iou_bf16"] = iou(res.soft_mask, gt)
    hr["tiny_iou_fp32"] = iou(res32.soft_mask, gt)
    hr["tiny_binary_agree"] = float((res.binary_mask == res32.binary_mask).mean())
    log(f"  tiny SODPredictor 2048^2: IoU vs fixture mask bf16 "
        f"{hr['tiny_iou_bf16']:.4f}, fp32 {hr['tiny_iou_fp32']:.4f}; binary "
        f"agreement {hr['tiny_binary_agree']:.6f}; launches {counts}")


def serving_phase(results, pred):
    """InferenceServer over the 1024^2 ViT-B predictor, and the 1024^2
    stream's end-to-end rate."""
    import numpy as np
    from PIL import Image

    from s3od_torch.serving import InferenceServer

    image = np.array(Image.open(IMAGE).convert("RGB"))
    imgs = test_images(image)
    log("phase serving: InferenceServer over the 1024^2 ViT-B predictor, "
        "8 concurrent requests")
    server = InferenceServer(pred, max_batch=4, max_wait_ms=50).start()
    try:
        futures = [server.submit_async(imgs[i]) for i in range(8)]
        answers = [f.result(timeout=300) for f in futures]
    finally:
        server.stop()
    d_mask = d_iou = 0.0
    for i, r in enumerate(answers):
        single = pred.remove_background(imgs[i])
        d_mask = max(d_mask, float(np.abs(r.all_masks - single.all_masks).max()))
        d_iou = max(d_iou, float(np.abs(r.all_ious - single.all_ious).max()))
    sv = results["_serving"] = {
        "requests": server.stats["requests"],
        "mean_batch": server.mean_batch_size, "d_mask": d_mask, "d_iou": d_iou}
    log(f"  {sv['requests']} requests, mean batch {sv['mean_batch']:.2f}; vs "
        f"direct calls: max|d soft mask| {d_mask:.3e}, max|d iou| {d_iou:.3e}")
    check(sv["requests"] == 8, "server answered every request")
    check(sv["mean_batch"] > 1.0, "server batched concurrent requests")
    check(d_mask <= BATCH_TOL and d_iou <= BATCH_TOL,
          f"server answers differ from direct calls ({d_mask}, {d_iou})")
    for batch in (1, 16):
        rate = stream_img_s(pred, imgs, batch=batch, payload="best",
                            upload="bucket")
        sv[f"stream_img_s_1024_b{batch}"] = rate
        log(f"  remove_background_stream 1024^2 end to end: {rate:.3f} img/s "
            f"(16 images, batch {batch}, 'best', bucket)")


def encoder_taps(pred, canvases, route):
    """The encoder's tap outputs, in fp32, for (B, S, S, 3) uint8 canvases
    normalized as the predictor normalizes them."""
    import torch

    x = torch.from_numpy(canvases).cuda()
    with torch.inference_mode():
        xx = ((x.float() - pred._mean) * pred._inv_std).to(pred.compute_dtype)
        return [t.float() for t in pred.model.encoder(xx, pred.cfg.tap_layers,
                                                      route)]


def tap_errors(what, tap_layers, got, ref, tol):
    """||got - ref|| / ||ref|| per tap and image: logged, the worst checked
    against `tol` and returned."""
    worst = 0.0
    for t, g, r in zip(tap_layers, got, ref):
        err = ((g - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)).tolist()
        log(f"  tap {t:2d} {what}, ||d|| / ||ref|| per image: "
            + " ".join(f"{e:.2e}" for e in err))
        worst = max(worst, *err)
    check(worst <= tol, f"{what}: tap relative error {worst} > {tol}")
    return worst


def batch_checks(pred, imgs, batch):
    """`remove_background_batch` results against `remove_background` on the
    same images: the masks and IoU scores, and — because seeded weights
    leave the soft masks flat near 0.5 — the encoder taps of the batch-16
    forward against each image's own forward, where a fault in the
    kernels' batch indexing shows in every image but the first."""
    import numpy as np
    import torch

    singles = [pred.remove_background(im) for im in imgs]
    d_bm = max(float(np.abs(r.all_masks - s.all_masks).max())
               for r, s in zip(batch, singles))
    d_bi = max(float(np.abs(r.all_ious - s.all_ious).max())
               for r, s in zip(batch, singles))
    agree = min(float(((r.all_masks > 0.5) == (s.all_masks > 0.5)).mean())
                for r, s in zip(batch, singles))
    log(f"  batch vs single image ({len(imgs)} images): max|d soft mask| "
        f"{d_bm:.3e}, max|d iou score| {d_bi:.3e}, worst thresholded "
        f"agreement {agree:.6f}")
    check(d_bm <= BATCH_TOL and d_bi <= BATCH_TOL,
          f"batch results differ from single-image results ({d_bm}, {d_bi})")
    canvases = np.stack([pred._preprocess(im)[0] for im in imgs])
    got = encoder_taps(pred, canvases, "kernel")
    ref = [torch.cat(t) for t in
           zip(*(encoder_taps(pred, c[None], "kernel") for c in canvases))]
    tap_b = tap_errors(f"batch {len(imgs)} vs single image", pred.cfg.tap_layers,
                       got, ref, BATCH_TOL)
    return d_bm, tap_b


def quality_phase(results):
    import numpy as np
    from PIL import Image

    from s3od_torch import BackgroundRemoval

    log("phase quality: tiny checkpoint trained at 1024^2, bf16 kernels (D=32)")
    image = np.array(Image.open(IMAGE).convert("RGB"))
    gt = np.array(Image.open(MASK).convert("L")) > 128
    pred = BackgroundRemoval(str(TINY_1024), image_size=1024, device="cuda")
    reset_counts()
    res = pred.remove_background(image)
    counts = launch_counts()
    want = pred.cfg.num_encoder_layers_used
    check(all(v == want for v in counts.values()), f"tiny launches {counts}")
    score = iou(res.predicted_mask, gt)
    log(f"  IoU vs fixture mask: {score:.4f} (launches {counts})")
    check(score >= 0.9, f"tiny 1024 IoU {score} < 0.9")
    results["_quality"] = {"iou": score}


# ----------------------------------------------------------------------------
# The decoder's gated kernels: K9a, K9b (S3OD_WINOGRAD) and K10
# (MASK_TAIL_FUSED)
# ----------------------------------------------------------------------------

K9A, K9B, K10 = "K9a_winograd_conv", "K9b_winograd_rcu", "K10_mask_tail"
# ||kernel - plain|| / ||plain|| of each K9a, K9b and K10 call of a gated
# forward, on the call's own inputs: about 2x the largest value this
# script measured on an H100 80GB HBM3 at 700 W (K9b 7.0e-5 at 1024^2 and
# 2048^2; K9a 3.8e-5, K10 2.5e-5). The planted K9b x 1.01 reads 1.0e-2.
DEC_CALL_TOL = 1.5e-4
# ||kernel - plain|| / ||plain|| of K10's out on random inputs (the gated
# calls keep DEC_CALL_TOL): 1.5x the worst measured on an H100 80GB HBM3 at
# 700 W (2.76e-4, NHWC memory). Both round h1, h2 and out to bf16 after
# fp32 sums in different orders, and on these inputs a few outputs in a
# thousand land one bf16 step apart (the parent's kernel read 1.5e-4 to
# 2.0e-4 on other random inputs, bit for bit as a build of the redesign);
# the planted out x 1.01 reads 1.0e-2.
K10_NORM_TOL = 4.2e-4


def decoder_wrappers():
    from s3od_torch.ops.experimental import mask_tail, winograd

    return {K9A: winograd.winograd_conv, K9B: winograd.winograd_rcu,
            K10: mask_tail.mask_tail}


def decoder_counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


@contextlib.contextmanager
def decoder_gates(on: bool):
    """Both gates of the decoder (`S3OD_WINOGRAD` as read into
    `ops/conv._WINOGRAD_ENABLED`, and `models/dpt.MASK_TAIL_FUSED`), set
    and restored."""
    from s3od_torch.models import dpt
    from s3od_torch.ops import conv

    old = conv._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED
    conv._WINOGRAD_ENABLED = dpt.MASK_TAIL_FUSED = on
    try:
        yield
    finally:
        conv._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED = old


@contextlib.contextmanager
def decoder_shadowed(results, worst, fault=None):
    """Every K9a, K9b and K10 call of the decoder held against its plain
    version on the call's own inputs: the worst ||d|| / ||plain|| per
    kernel into `worst`, and (without a fault) `compare`'s max|d| /
    max|plain| check. The callers' references (`ops/conv`'s and
    `models/dpt`'s) are shadowed; the wrappers, and their counts, are not.
    `fault` names a kernel whose output is multiplied by 1.01."""
    import torch

    from s3od_torch.models import dpt
    from s3od_torch.ops import conv
    from s3od_torch.ops.experimental import mask_tail, winograd

    real = (conv.conv3x3_winograd, dpt.rcu_winograd, dpt.mask_tail)

    def held(name, out, ref):
        if name == fault:
            out = out * 1.01
        if fault is None:
            compare(name, [out], [ref], results)
        worst[name] = max(worst.get(name, 0.0), rel_norm(out, ref))
        return out

    def k9a(x, p):
        b = p.get("bias")
        if b is None:
            b = torch.zeros(p["kernel"].shape[-1], dtype=x.dtype, device=x.device)
        return held(K9A, real[0](x, p),
                    winograd.winograd_conv_plain(x, p["kernel"], b))

    def k9b(x, p1, p2):
        return held(K9B, real[1](x, p1, p2), winograd.winograd_rcu_plain(
            x, p1["kernel"], p1["bias"], p2["kernel"], p2["bias"]))

    def k10(*args):
        return held(K10, real[2](*args), mask_tail.mask_tail_plain(*args))

    conv.conv3x3_winograd, dpt.rcu_winograd, dpt.mask_tail = k9a, k9b, k10
    try:
        yield
    finally:
        conv.conv3x3_winograd, dpt.rcu_winograd, dpt.mask_tail = real


def decoder_rule_counts(cfg, size: int, training: bool = False):
    """K9a, K9b and K10 launches of one forward at a square canvas by the
    copied rule, from the decoder's 3x3/s1/p1 convs written out (ViT
    patch 16): serving folds the BNs, so an RCU whose shape both rules
    admit is one K9b launch and its convs are not single convs; training
    keeps the BNs (no K9b) and the unfused tail (no K10). Training also
    returns K9a's dx launches (where the rule admits the gradient's
    shape)."""
    from s3od_torch.ops.experimental.winograd import (rcu_winograd_available,
                                                     winograd_available)

    p = size // cfg.encoder.patch_size
    f, neck, inter = cfg.features, cfg.neck_channels, cfg.mask_inter_features
    rn = [4 * p, 2 * p, p, -(-p // 2)]
    singles = [(rn[i], neck[i], f) for i in range(4)]
    singles += [(8 * p, f, f // 2), (16 * p, 2 * inter, 2 * inter),
                (16 * p, 2 * inter, 3 * inter)]
    rcus = [rn[i] for i in range(4) for _ in range(1 if i == 3 else 2)]
    ok = lambda s, c, k: winograd_available(s, s, c, k)
    if training:
        convs = singles + [(s, f, f) for s in rcus for _ in range(2)]
        return (sum(ok(*sh) for sh in convs),
                sum(ok(s, c, k) and ok(s, k, c) for s, c, k in convs))
    chained = [s for s in rcus if ok(s, f, f) and rcu_winograd_available(s, s, f)]
    k9a = sum(ok(*sh) for sh in singles[:5]) + 2 * sum(
        ok(s, f, f) for s in rcus if s not in chained)
    return {K9A: k9a, K9B: len(chained), K10: 1}


def decoder_kernel_checks(results):
    """K9a, K9b and K10 against their plain versions on random inputs at
    the 1024^2 b1 path's largest shapes (NCHW memory seen through NHWC
    views, as the decoder calls them), timed beside the plain version, the
    cuDNN chain computing the same function in bf16 and the bound."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops.experimental import mask_tail as mt
    from s3od_torch.ops.experimental import winograd as wg

    gen = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf)

    def nchw_view(b, c, h, w, scale=1.0):
        return randn(b, c, h, w, scale=scale).permute(0, 2, 3, 1)

    oihw = lambda w: w.permute(3, 2, 0, 1)
    nchw = lambda x: x.permute(0, 3, 1, 2)

    # K9a at each of its 1024^2 b1 shapes and at the training step's dx of
    # layer2_rn (batch 4, 256 -> 512 at 128^2: the two-launch route)
    k9a_phase(results, randn, nchw_view)

    # K9b at refinenet1 of the 1024^2 path (1, 256, 256, 256): the row; and
    # of the 2048^2 path (1, 512, 512, 256). Six device launches a call
    # (U1, U2, each conv's transform and GEMM): the profiler sums them; CUDA events
    # around back-to-back calls beside it, for kernel and chain alike.
    c = 256
    for s9 in (256, 512):
        log(f"phase K9b winograd_rcu (1, {s9}, {s9}, {c}), refinenet1 at "
            f"{4 * s9}^2")
        x = nchw_view(1, c, s9, s9)
        w1, w2 = randn(3, 3, c, c, scale=0.03), randn(3, 3, c, c, scale=0.03)
        b1, b2 = randn(c, scale=0.3), randn(c, scale=0.1)
        args = (x, w1, b1, w2, b2)
        got, ref = wg.winograd_rcu(*args), wg.winograd_rcu_plain(*args)
        compare(K9B, [got], [ref], results)
        nrm = rel_norm(got, ref)
        log(f"  K9b ||d|| / ||plain|| {nrm:.3e} (bound {DEC_CALL_TOL:.1e})")
        check(nrm <= DEC_CALL_TOL, f"K9b at {s9}^2: rel. norm {nrm} > {DEC_CALL_TOL}")
        xc = nchw(x)
        chain = lambda: xc + F.conv2d(F.relu(F.conv2d(
            F.relu(xc), oihw(w1), b1, padding=1)), oihw(w2), b2, padding=1)
        t9 = (s9 // 2) ** 2
        r9 = {"rel_norm": nrm}
        time_pair("k", lambda: wg.winograd_rcu(*args),
                  lambda: wg.winograd_rcu_plain(*args), {"k": r9}, iters=5)
        r9["library_ms"] = device_ms(chain)
        r9["run_ms"] = run_ms(lambda: wg.winograd_rcu(*args))
        r9["library_run_ms"] = run_ms(chain)
        set_bound({"k": r9}, "k", 2 * 2.0 * 16 * t9 * c * c,
                  2 * (2 * s9 * s9 * c + 2 * 9 * c * c + 2 * c),
                  fp32_ops=2 * t9 * 72.0 * c)
        r9["by_kernel"] = [(key[:80], ms) for key, ms, _ in
                           kernel_breakdown(lambda: wg.winograd_rcu(*args), 5)]
        log(f"  K9b {r9['ms']:.4f} ms (events {r9['run_ms']:.4f}), cuDNN chain "
            f"{r9['library_ms']:.4f} (events {r9['library_run_ms']:.4f}), plain "
            f"{r9['plain_ms']:.4f}, bound {r9['bound_ms']:.4f} by {r9['bound_by']}; "
            + ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in r9["by_kernel"]))
        if s9 == 256:
            results[K9B].update(r9)
        else:
            results[K9B]["at_2048"] = r9
        del args, x, got, ref

    k10_phase(results, randn, nchw_view)
    for name in (K9A, K9B, K10):
        r = results[name]
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, cuDNN "
            f"chain {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")


def k10_phase(results, randn, nchw_view):
    """K10 against its plain version on random inputs at the gated paths'
    shapes and layouts: (1, 1024^2) and (16, 1024^2) and (1, 2048^2) on
    NCHW memory seen through an NHWC view (the decoder's), (1, 1024^2) on
    NHWC memory and on (B, C, W, H) memory seen as (B, H, W, C) (H
    innermost: the element-by-element load), each by max error and by
    relative norm within K10_NORM_TOL, a planted out x 1.01 caught; timed
    at 1024^2 b1 by `held_ms` warm and after an L2 flush, the SM and
    memory clocks sampled around each reading, beside the plain version,
    the cuDNN chain and the bound; b16 and 2048^2 warm; with --turns the
    parent's kernel in turns on the same inputs."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops.experimental import mask_tail as mt

    oihw = lambda w: w.permute(3, 2, 0, 1)
    nchw = lambda x: x.permute(0, 3, 1, 2)
    ci, cm, n = 64, 96, 3
    weights = (randn(3, 3, ci, ci, scale=0.05), randn(ci, scale=0.1),
               randn(3, 3, ci, cm, scale=0.05), randn(cm, scale=0.1),
               randn(cm, n, scale=0.1), randn(n, scale=0.1))
    r = results.setdefault(K10, {"max_abs_err": 0.0})
    cases = [("b1 nchw", lambda: nchw_view(1, ci, 1024, 1024, scale=0.5)),
             ("b16 nchw", lambda: nchw_view(16, ci, 1024, 1024, scale=0.5)),
             ("2048 nchw", lambda: nchw_view(1, ci, 2048, 2048, scale=0.5)),
             ("b1 nhwc", lambda: nchw_view(1, ci, 1024, 1024, scale=0.5).contiguous()),
             ("b1 (B, C, W, H) memory",
              lambda: randn(1, ci, 1024, 1024, scale=0.5).permute(0, 3, 2, 1))]
    parent = turns_k10()
    flush = torch.empty(64 * 2**20, device="cuda")
    r["cases"] = {}
    for tag, make in cases:
        x = make()
        targs = (x, *weights)
        log(f"phase K10 mask_tail {tag}: x {tuple(x.shape)} strides {x.stride()}, "
            f"{ci} -> {ci} -> {cm} -> {n}; plan "
            f"{ {k: v for k, v in mt.mask_tail_plan(*x.shape[:3]).items() if k != 'runs'} }")
        got, ref = mt.mask_tail(*targs), mt.mask_tail_plain(*targs)
        compare(K10, [got], [ref], results)
        nrm = rel_norm(got, ref)
        planted = rel_norm(got.float() * 1.01, ref)
        log(f"  K10 ||d|| / ||plain|| {nrm:.3e} (bound {K10_NORM_TOL:.1e}); planted out "
            f"x 1.01 reads {planted:.3e}")
        check(nrm <= K10_NORM_TOL, f"K10 {tag}: rel. norm {nrm} > {K10_NORM_TOL}")
        check(planted > K10_NORM_TOL, f"K10 {tag}: the planted out x 1.01 went unnoticed")
        case = {"rel_norm": nrm, "planted_rel_norm": planted}
        if tag in ("b1 nchw", "b16 nchw", "2048 nchw"):
            kern = lambda: mt.mask_tail(*targs)
            clocks = [smi_clocks()]
            case["held_ms"] = held_ms(kern, iters=20 if tag != "b16 nchw" else 3)
            clocks.append(smi_clocks())
            if tag == "b1 nchw":
                case["cold_ms"] = held_ms(kern, iters=10, flush=flush)
                clocks.append(smi_clocks())
            case["clocks"] = clocks
            if parent is not None:
                pgot = parent(*targs)
                compare(f"{K10} (the parent's)", [pgot], [ref], {})
                fns = {"parent": lambda: parent(*targs), "new": kern}
                iters = 20 if tag != "b16 nchw" else 3
                case["turns_warm"] = turns(fns, lambda f: held_ms(f, iters=iters))
                if tag == "b1 nchw":
                    case["turns_cold"] = turns(fns, lambda f: held_ms(f, iters=10, flush=flush))
                case["turns_clocks"] = smi_clocks()
                del pgot
            log(f"  K10 {tag}: held {case['held_ms']:.4f} ms"
                + (f", after an L2 flush {case['cold_ms']:.4f}" if "cold_ms" in case else "")
                + f"; clocks (SM, memory) {clocks}"
                + (f"; in turns warm {case['turns_warm']}" if "turns_warm" in case else "")
                + (f", cold {case['turns_cold']}" if "turns_cold" in case else ""))
        if tag == "b1 nchw":
            s = 1024
            time_pair(K10, lambda: mt.mask_tail(*targs),
                      lambda: mt.mask_tail_plain(*targs), results, iters=5)
            r["profiler_ms"] = r["ms"]
            r["ms"], r["cold_ms"] = case["held_ms"], case["cold_ms"]
            xc, k1c = nchw(x), weights[4].t()[:, :, None, None]
            w1, b1, w0, b0, _, bk = weights
            chain = lambda: F.conv2d(F.relu(F.conv2d(F.relu(F.conv2d(
                F.relu(xc), oihw(w1), b1, padding=1)), oihw(w0), b0, padding=1)), k1c, bk)
            r["library_ms"] = device_ms(chain)
            r["library_held_ms"] = held_ms(chain, iters=10)
            set_bound(results, K10, 2.0 * s * s * 9 * ci * (ci + cm) + 2.0 * s * s * cm * n,
                      2 * (s * s * ci + 9 * ci * (ci + cm) + cm * n + ci + cm + n
                           + s * s * n), fp32_ops=s * s * (2.0 * ci + 3.0 * cm))
            log(f"  K10: {r['ms']:.4f} ms held ({100 * r['bound_ms'] / r['ms']:.1f}% of the "
                f"bound {r['bound_ms']:.4f} by {r['bound_by']}), cold {r['cold_ms']:.4f}, "
                f"profiler {r['profiler_ms']:.4f}; cuDNN chain {r['library_ms']:.4f} "
                f"(held {r['library_held_ms']:.4f}); plain {r['plain_ms']:.4f}")
        r["cases"][tag] = case
        del x, targs, got, ref
        torch.cuda.empty_cache()
    if parent is not None:
        r["parent_ms"] = statistics.mean(r["cases"]["b1 nchw"]["turns_warm"]["parent"])
        r["turns_ms"] = statistics.mean(r["cases"]["b1 nchw"]["turns_warm"]["new"])
    del flush


# K9a's shapes on the main paths: the three 3x3 convs the copied rule sends
# to it in a 1024^2 b1 forward, and one dx conv of the training step.
K9A_SHAPES = (("layer1_rn", 1, 256, 256, 256), ("layer2_rn", 1, 128, 512, 256),
              ("output_conv1", 1, 512, 256, 128), ("dx of layer2_rn, b4", 4, 128, 256, 512))


def k9a_phase(results, randn, nchw_view):
    """K9a against its plain version at each shape of `K9A_SHAPES` (NCHW
    memory through an NHWC view, as the decoder calls it), by max error
    and by relative norm within DEC_CALL_TOL, its route from the plan; then
    kernel, plain version and cuDNN's conv + bias by CUDA events around
    back-to-back calls, U = G w G^T apart (the kernel's own launch by the
    profiler, and the plain version's torch ops), and the bound; the
    forward's convs also at batch 16 beside cuDNN's. The row of the kernel
    table is layer1_rn; every shape goes under "shapes"."""
    import torch
    import torch.nn.functional as F

    from s3od_torch.ops.experimental import winograd as wg

    oihw = lambda w: w.permute(3, 2, 0, 1)
    shapes = {}
    for label, b, s, c, k in K9A_SHAPES:
        x = nchw_view(b, c, s, s)
        w, bias = randn(3, 3, c, k, scale=0.03), randn(k, scale=0.1)
        plan = wg.conv_plan(b, s, s, c, k, tma=wg.tma_layout(x))
        route = "fused" if plan["route"] == wg.FUSED else "two launches"
        log(f"phase K9a winograd_conv ({b}, {s}, {s}, {c} -> {k}), {label}: {route}, "
            f"scratch {plan['scratch_bytes'] / 2**20:.1f} MiB")
        got, ref = wg.winograd_conv(x, w, bias), wg.winograd_conv_plain(x, w, bias)
        compare(K9A, [got], [ref], results)
        nrm = rel_norm(got, ref)
        log(f"  K9a ||d|| / ||plain|| {nrm:.3e} (bound {DEC_CALL_TOL:.1e})")
        check(nrm <= DEC_CALL_TOL, f"K9a {label}: rel. norm {nrm} > {DEC_CALL_TOL}")
        del got, ref
        xc = x.permute(0, 3, 1, 2)
        kern = lambda: wg.winograd_conv(x, w, bias)
        r = {"route": route, "rel_norm": nrm, "scratch_mib": plan["scratch_bytes"] / 2**20,
             "ms": run_ms(kern, 10),
             "plain_ms": run_ms(lambda: wg.winograd_conv_plain(x, w, bias), 2),
             "library_ms": run_ms(lambda: F.conv2d(xc, oihw(w), bias, padding=1), 10),
             "u_plain_ms": run_ms(lambda: wg._u(w, x.dtype).contiguous(), 10)}
        r["by_kernel"] = [(key[:80], ms) for key, ms, _ in kernel_breakdown(kern, 5)]
        r["u_kernel_ms"] = sum(ms for key, ms in r["by_kernel"] if "weights" in key)
        tiles = b * (s // 2) ** 2
        set_bound({"k": r}, "k", 2.0 * 16 * tiles * c * k,
                  2 * (b * s * s * c + 9 * c * k + k + b * s * s * k),
                  fp32_ops=tiles * (32.0 * c + 40.0 * k))
        log(f"  K9a {r['ms']:.4f} ms (CUDA events; U's kernel {r['u_kernel_ms']:.4f} by the "
            f"profiler, U by torch ops {r['u_plain_ms']:.4f}), cuDNN conv + bias "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}; " + ", ".join(f"{key[:40]} {ms:.4f}" for key, ms in r["by_kernel"]))
        if b == 1:  # the same conv at batch 16, as remove_background_batch runs it
            x16 = nchw_view(B16, c, s, s)
            x16c = x16.permute(0, 3, 1, 2)
            r["b16_ms"] = run_ms(lambda: wg.winograd_conv(x16, w, bias), 3)
            r["b16_library_ms"] = run_ms(lambda: F.conv2d(x16c, oihw(w), bias, padding=1), 3)
            log(f"  at batch 16: K9a {r['b16_ms']:.4f} ms, cuDNN conv + bias "
                f"{r['b16_library_ms']:.4f} (CUDA events)")
            del x16, x16c
        shapes[label] = r
        if label == "layer1_rn":
            results[K9A].update({key: r[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
            results[K9A]["event_ms"] = cuda_ms(kern, 5)
            results[K9A]["plain_event_ms"] = r["plain_ms"]
        del x
        torch.cuda.empty_cache()
    results[K9A]["shapes"] = shapes


def decoder_phase(results, pred, pred32):
    """The gated decoder on the main paths: kernel checks at the 1024^2
    shapes; `remove_background` and `remove_background_batch` (16) at
    1024^2 with both gates on — launches as the rule gives them, every K9a,
    K9b and K10 call against its plain version (a planted K9b fault must
    fail that check), results against fp32 exact mode, device time and
    img/s beside the gates off; one 2048^2 stream and a per-call check at
    2048^2; one ViT-B 1024^2 b4 train step with the Winograd gate on."""
    import numpy as np
    import torch
    from PIL import Image

    decoder_kernel_checks(results)
    wrappers = decoder_wrappers()
    cfg = pred.cfg
    image = np.array(Image.open(IMAGE).convert("RGB"))
    imgs = test_images(image)
    dec = results["_decoder"] = {}
    want = decoder_rule_counts(cfg, 1024)
    log(f"phase decoder gates on, 1024^2 ViT-B: launches by the rule {want}")
    check(want == {K9A: 3, K9B: 4, K10: 1}, f"1024^2 rule counts {want}")
    per_forward = cfg.num_encoder_layers_used
    with decoder_gates(True):
        worst = {}
        reset_counts()
        for fn in wrappers.values():
            fn.launches = 0
        with decoder_shadowed(results, worst):
            res = pred.remove_background(image)
        torch.cuda.synchronize()
        counts, enc = decoder_counts(wrappers), launch_counts()
        log(f"  remove_background launches: {counts}, encoder {enc}")
        check(counts == want, f"gated b1 launches {counts}, want {want}")
        check(all(v == per_forward for v in enc.values()), f"encoder {enc}")
        for name, cnt in counts.items():
            results[name]["launches"] = cnt
        for fn in wrappers.values():
            fn.launches = 0
        with decoder_shadowed(results, worst):
            batch = pred.remove_background_batch(imgs)
        torch.cuda.synchronize()
        counts = decoder_counts(wrappers)
        log(f"  remove_background_batch(16) launches: {counts}")
        check(counts == want, f"gated b16 launches {counts}, want {want}")
        log("  per call, kernel vs plain (||d|| / ||plain||): " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
        check(all(v <= DEC_CALL_TOL for v in worst.values()),
              f"a gated kernel call out of bound {worst}")
        planted = {}
        for name in (K9B, K9A):
            faulty = {}
            with decoder_shadowed(results, faulty, fault=name):
                pred.remove_background(image)
            log(f"  planted {name} x 1.01, per call: {faulty[name]:.3e} "
                f"(bound {DEC_CALL_TOL:.1e})")
            check(faulty[name] > DEC_CALL_TOL, f"the planted {name} fault went unnoticed")
            planted[name] = faulty[name]
        dec.update(per_call=worst, planted_k9b=planted[K9B], planted_k9a=planted[K9A])

        # against float32 exact mode, image by image
        d_iou, agree = 0.0, 1.0
        for r, im in zip([res] + batch, [image] + imgs):
            r32 = pred32.remove_background(im)
            agree = min(agree, float(((r.all_masks > 0.5)
                                      == (r32.all_masks > 0.5)).mean()))
            d_iou = max(d_iou, float(np.abs(r.all_ious - r32.all_ious).max()))
        log(f"  gated bf16 vs fp32 exact (17 images): worst thresholded "
            f"agreement {agree:.6f}, max|d iou score| {d_iou:.3e}")
        check(agree >= 0.99, f"gated bf16/fp32 agreement {agree} < 0.99")
        check(d_iou <= 2e-2, f"gated bf16/fp32 IoU score diff {d_iou} > 2e-2")
        dec.update(agreement=agree, d_iou=d_iou)

    # device time of the forward, gates off and on in turns, and img/s
    c1 = torch.from_numpy(pred._preprocess(image)[0][None]).cuda()
    c16 = torch.from_numpy(np.stack([pred._preprocess(im)[0] for im in imgs])).cuda()
    for tag, canvas, iters in (("b1", c1, 20), ("b16", c16, 5)):
        times = {False: [], True: []}
        for on in (False, True, True, False):
            with decoder_gates(on):
                times[on].append(cuda_ms(lambda: pred._forward_device(canvas, "full"),
                                         iters=iters))
        dec[f"fwd_ms_{tag}_off"] = statistics.mean(times[False])
        dec[f"fwd_ms_{tag}_on"] = statistics.mean(times[True])
        log(f"  forward {tag}: gates off {times[False]} ms, on {times[True]} ms")
    with decoder_gates(True):
        forward_profile(pred, c1.cpu().numpy(), "b1_gated", dec, iters=20)
        forward_profile(pred, c16.cpu().numpy(), "b16_gated", dec)
    for on in (False, True):
        with decoder_gates(on):
            pred.remove_background(image)
            t0 = time.perf_counter()
            for _ in range(10):
                pred.remove_background(image)
            b1 = 10 / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(2):
                pred.remove_background_batch(imgs)
            b16 = 32 / (time.perf_counter() - t0)
        tag = "on" if on else "off"
        dec[f"img_s_b1_{tag}"], dec[f"img_s_b16_{tag}"] = b1, b16
        log(f"  end to end, gates {tag}: batch 1 {b1:.3f} img/s, batch 16 "
            f"{b16:.3f} img/s")
    decoder_highres(results, wrappers, cfg, imgs)
    decoder_train_step(results, wrappers)


def decoder_highres(results, wrappers, cfg, imgs):
    """2048^2 with both gates on: one forward with every gated call held
    against its plain version (the 2048^2 shapes, refinenet1's RCU convs
    on K9a among them), then `remove_background_stream` (batch 1, payload
    "best", bucketed upload) — launches per image as the rule gives them
    and each result against `payload="full"`."""
    import numpy as np
    import torch

    from s3od_torch import BackgroundRemoval
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    want = decoder_rule_counts(cfg, 2048)
    log(f"phase decoder gates on, 2048^2 ViT-B: launches by the rule {want}")
    check(want == {K9A: 7, K9B: 4, K10: 1}, f"2048^2 rule counts {want}")
    model = init_weights_(S3ODSegmentation(cfg), torch.Generator().manual_seed(0))
    pred = BackgroundRemoval.from_model(model, image_size=2048, device="cuda")
    dec = results["_decoder"]
    with decoder_gates(True):
        worst = {}
        for fn in wrappers.values():
            fn.launches = 0
        with decoder_shadowed(results, worst):
            pred.remove_background(imgs[0])
        counts = decoder_counts(wrappers)
        log(f"  one forward: launches {counts}; per call vs plain " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))
        check(counts == want, f"2048^2 launches {counts}, want {want}")
        check(all(v <= DEC_CALL_TOL for v in worst.values()),
              f"a 2048^2 gated call out of bound {worst}")
        for fn in wrappers.values():
            fn.launches = 0
        streamed = list(pred.remove_background_stream(
            imgs[:2], batch=1, payload="best", upload="bucket"))
        torch.cuda.synchronize()
        counts = decoder_counts(wrappers)
        check(counts == {k: 2 * v for k, v in want.items()},
              f"2048^2 stream launches {counts}")
        d_best = d_iou = 0.0
        for im, r in zip(imgs[:2], streamed):
            full = pred.remove_background(im)
            d_best = max(d_best, float(np.abs(r.predicted_mask
                                              - full.predicted_mask).max()))
            d_iou = max(d_iou, float(np.abs(r.all_ious - full.all_ious).max()))
        log(f"  stream of 2: launches {counts}; 'best' vs 'full': max|d best "
            f"mask| {d_best:.3e}, max|d iou| {d_iou:.3e}")
        check(d_best <= BEST_TOL and d_iou <= 1e-5,
              f"2048^2 gated stream vs full ({d_best}, {d_iou})")
        dec.update(per_call_2048=worst, best_vs_full_2048=d_best)
    # device time of the 2048^2 forward, gates off and on in turns
    canvas = pred._preprocess(imgs[0])[0][None]
    c1 = torch.from_numpy(canvas).cuda()
    times = {False: [], True: []}
    for on in (False, True, True, False):
        with decoder_gates(on):
            times[on].append(cuda_ms(lambda: pred._forward_device(c1, "full"), iters=5))
    dec["fwd_ms_2048_off"] = statistics.mean(times[False])
    dec["fwd_ms_2048_on"] = statistics.mean(times[True])
    log(f"  forward 2048^2 b1: gates off {times[False]} ms, on {times[True]} ms")
    with decoder_gates(True):
        forward_profile(pred, canvas, "2048_gated", dec)
    del pred, model
    torch.cuda.empty_cache()


def decoder_train_step(results, wrappers):
    """One `train_step` at ViT-B 1024^2 b4 bf16 with the Winograd gate on:
    the loss finite, K9a's forward and dx launches as the rule gives them;
    then K9a's autograd dx against the vjp of its plain version at the
    step's layer1_rn shape."""
    import torch

    from s3od_torch.ops.experimental import winograd as wg
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    log("phase decoder gate in training: train_step ViT-B 1024^2 b4 bf16")
    model = vit_b_model(2)
    opt = Optimizer(model, 1e-4, steps_per_epoch=100)
    batch = fixture_batch(4, 1024)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    fwd, dx = decoder_rule_counts(model.cfg, 1024, training=True)
    step = lambda i: train_step(model, opt, loss_module, batch, 0, i,
                                compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(i))
    with decoder_gates(True):
        for fn in wrappers.values():
            fn.launches = 0
        loss = float(step(0)["loss"])
        torch.cuda.synchronize()
        counts = decoder_counts(wrappers)
        log(f"  loss {loss:.4f}; launches {counts}; by the rule K9a {fwd} "
            f"forward + {dx} dx")
        check(loss == loss and abs(loss) < 1e6, "gated train step loss")
        check(counts == {K9A: fwd + dx, K9B: 0, K10: 0},
              f"gated train step launches {counts}")
        ms_on = cuda_ms(lambda: step(1), iters=3)
    ms_off = cuda_ms(lambda: step(2), iters=3)
    log(f"  train step: Winograd gate on {ms_on:.2f} ms, off {ms_off:.2f} ms")
    results["_decoder"].update(train_step_ms_on=ms_on, train_step_ms_off=ms_off,
                               train_k9a=fwd + dx)
    del model, opt
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(10)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * scale).to(torch.bfloat16)
    x = r(4, 256, 256, 256).permute(0, 2, 3, 1)
    w, b, g = r(3, 3, 256, 256, scale=0.03), r(256, scale=0.1), r(4, 256, 256, 256)
    xk = x.detach().requires_grad_()
    (dx_k,) = torch.autograd.grad(wg.conv3x3_winograd(xk, {"kernel": w, "bias": b}),
                                  xk, g)
    xp = x.detach().requires_grad_()
    (dx_p,) = torch.autograd.grad(wg.winograd_conv_plain(xp, w, b), xp, g)
    log("  K9a dx (autograd, through K9a) vs the plain version's vjp at "
        "(4, 256, 256, 256):")
    compare(K9A, [dx_k], [dx_p], results)


# ----------------------------------------------------------------------------
# Training (python -m s3od_torch.training.train and its train step)
# ----------------------------------------------------------------------------

# Gradient agreement at ViT-B, 1024^2, batch 2 (grad_agreement_phase).
# GRAD_TOL: ||g - g_ref|| / ||g_ref|| per parameter group and of the
# training loss, bf16 kernel route against fp32 exact mode; 1.5x the
# largest value measured by this script on an H100 80GB HBM3 at 700 W in
# five runs: loss 1.444e-5, encoder 4.128e-2, head 7.87e-3. With K2's, K4's
# and K5's backwards written out in bf16 products (fp32 accumulation) in
# place of fp32 vjps of their plain versions, two runs read loss 1.540e-5
# and 1.636e-5, encoder 4.296e-2 and 4.223e-2, head 8.010e-3 and 7.931e-3
# (same card); the bounds stand.
# K8_GRAD_TOL: a loss on the encoder taps, K8 against its plain version
# as the backward of the same forward; "qkv_k_norm" is |norm ratio - 1| of
# the gradient's key rows of the fused qkv weight (the product with K8's
# dk), all blocks' rows taken together. This backward is deterministic (a
# repeat reads exactly 0); measured encoder 5.969e-3, bounds 1.5x. A
# planted dk x 1.01 reads qkv_k_norm 1.046e-2 and is caught; against fp32
# it reads encoder 4.120e-2, inside GRAD_TOL (the bf16 forward's rounding
# hides it there). The key rows were once held block by block (the
# largest ratio over the blocks, bound 1.5x the 9.267e-4 of one forward):
# that statistic moves with the forward's rounding, not with K8 — with
# one-ulp flips on 0.2% of the plain MLP's outputs it read 1.05e-3 to
# 3.38e-3 over eight seeds (six above its bound), while the rows taken
# together read at most 8.3e-4 there, and the planted fault 1.17e-2 and
# 1.05e-2 (H100 80GB HBM3, 700 W).
GRAD_TOL = {"loss": 2.2e-5, "encoder": 6.2e-2, "head": 1.2e-2}
K8_GRAD_TOL = {"encoder": 9.0e-3, "qkv_k_norm": 1.4e-3}
TRAIN_ROOT = REPO / "build" / "chip_smoke_train"


def write_fixture_dataset(root: Path, n: int = 20) -> Path:
    """images/ + masks/ PNG pairs made from the fixture pair with numpy:
    flips and cyclic shifts."""
    import numpy as np
    from PIL import Image

    image = np.array(Image.open(IMAGE).convert("RGB"))
    mask = np.array(Image.open(MASK).convert("L"))
    h, w = mask.shape
    ds = root / "fixture"
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir(parents=True)
    for i in range(n):
        im, m = image, mask
        if i % 2:
            im, m = im[:, ::-1], m[:, ::-1]
        if i % 4 >= 2:
            im, m = im[::-1], m[::-1]
        shift = ((i * 37) % (h // 4) - h // 8, (i * 53) % (w // 4) - w // 8)
        im, m = np.roll(im, shift, (0, 1)), np.roll(m, shift, (0, 1))
        Image.fromarray(np.ascontiguousarray(im)).save(ds / "images" / f"f{i:02d}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(ds / "masks" / f"f{i:02d}.png")
    return ds


def train_args(root: Path, base: str, *extra):
    """The entry point's arguments: dinob-sized by default, the paper's
    1024^2 canvas at batch 4 (config/dataset/synth.yaml) on the fixture
    dataset with the test-mode transform, bf16 on one card."""
    return ["model=dinob", "backend=1chip", "dataset=synth",
            "dataset.paths=[fixture]", "dataset.transform_mode=test",
            "dataset.val_split=0.2", "dataset.test_datasets=[]",
            "loss=focal_iou", "optimizer=adamw", "scheduler=cosine",
            "train_stage=dev_train", "backend.num_threads=8",
            f"data_dir={root}", f"base_dir={root / base}", *extra]


def only_run(base: Path) -> Path:
    runs = list((base / "checkpoints").iterdir())
    check(len(runs) == 1, f"one run directory under {base}, got {runs}")
    return runs[0]


def train_entry_phase(results):
    """`train()` at ViT-B width, 1024^2, batch 4, bf16: one epoch of 4
    steps and its validation batch, checkpoints, a resume that trains only
    the new epoch, and the export served by BackgroundRemoval; then the
    committed tiny checkpoint fine-tuned through the same entry point
    (D = 32) still segments the fixture."""
    import json as json_
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch import BackgroundRemoval
    from s3od_torch.configs import segmentation_config
    from s3od_torch.training.train import train

    if TRAIN_ROOT.exists():
        shutil.rmtree(TRAIN_ROOT)
    write_fixture_dataset(TRAIN_ROOT)
    blocks = segmentation_config("dinov3_base").num_encoder_layers_used
    steps, val_batches = 16 // 4, 4 // 4
    log(f"phase train: python -m s3od_torch.training.train model=dinob "
        f"1024^2 batch 4 bf16, {steps} steps + {val_batches} val batch")
    tr = results["_train"] = {}
    reset_counts()
    t0 = time.perf_counter()
    metrics = train(train_args(TRAIN_ROOT, "a", "backend.max_epochs=1"))
    torch.cuda.synchronize()
    tr["entry_s"] = time.perf_counter() - t0
    counts, k8 = launch_counts(), k8_launches()
    log(f"  train() {tr['entry_s']:.1f} s; launches {counts}, K8 {k8}; "
        f"train_loss {metrics['train_loss']:.4f} val_loss "
        f"{metrics['val_loss']:.4f}")
    for name, cnt in counts.items():
        want = steps * 2 * blocks + val_batches * blocks
        check(cnt == want, f"train(): {name} launched {cnt}, want {want} "
              f"({steps} steps x {blocks} blocks x 2 with the remat "
              f"recompute + {val_batches} val forward)")
    check(k8 == steps * blocks, f"train(): K8 launched {k8}, want {steps * blocks}")
    results["K8_flash_attention_bwd"]["launches"] = k8
    check(all(np.isfinite(v) for v in metrics.values()), "train metrics finite")
    run = only_run(TRAIN_ROOT / "a")
    index = json_.loads((run / "index.json").read_text())
    check(index["last"]["epoch"] == 0 and (run / "last" / "state.pt").exists(),
          "last checkpoint of epoch 0")
    check(bool(index["best"]) and (run / index["best"][0]["path"]).exists(),
          "a top-k checkpoint")

    reset_counts()
    train(train_args(TRAIN_ROOT, "b", "backend.max_epochs=2",
                     f"checkpoint_path={run / 'last'}"))
    k8 = k8_launches()
    run2 = only_run(TRAIN_ROOT / "b")
    index2 = json_.loads((run2 / "index.json").read_text())
    tree = torch.load(run2 / "last" / "state.pt", map_location="cpu",
                      weights_only=False)
    log(f"  resume with backend.max_epochs=2: K8 launched {k8}, last epoch "
        f"{index2['last']['epoch']}, step {tree['step']}")
    check(k8 == steps * blocks and index2["last"]["epoch"] == 1
          and [e["epoch"] for e in index2["best"]] == [1]
          and tree["step"] == 2 * steps, "resume trains only the new epoch")

    image = np.array(Image.open(IMAGE).convert("RGB"))
    pred = BackgroundRemoval(str(run2 / "s3od_final.npz"), image_size=1024,
                             device="cuda")
    res = pred.remove_background(image)
    check(res.predicted_mask.shape == image.shape[:2]
          and bool(np.isfinite(res.all_masks).all()), "exported ViT-B serves")
    log("  s3od_final.npz (ViT-B) served by BackgroundRemoval on the card")
    del pred, tree

    log("phase train (tiny): fine-tune tests/fixture/tiny_s3od_1024.npz "
        "through the entry point (D = 32), then IoU on the fixture")
    reset_counts()
    train(train_args(TRAIN_ROOT, "tiny", "model=tiny", "backend.max_epochs=1",
                     f"init_checkpoint={TINY_1024}"))
    k8_tiny = k8_launches()
    check(k8_tiny == steps * 4, f"tiny fine-tune: K8 launched {k8_tiny}")
    pred = BackgroundRemoval(str(only_run(TRAIN_ROOT / "tiny") / "s3od_final.npz"),
                             image_size=1024, device="cuda")
    gt = np.array(Image.open(MASK).convert("L")) > 128
    tr["tiny_finetuned_iou"] = iou(pred.remove_background(image).predicted_mask, gt)
    log(f"  fine-tuned tiny checkpoint: IoU vs fixture mask "
        f"{tr['tiny_finetuned_iou']:.4f} (K8 launches at D = 32: {k8_tiny})")
    check(tr["tiny_finetuned_iou"] >= 0.9,
          f"fine-tuned tiny IoU {tr['tiny_finetuned_iou']} < 0.9")
    shutil.rmtree(TRAIN_ROOT)


def vit_b_model(seed: int):
    import torch

    from s3od_torch.configs import segmentation_config
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    model = S3ODSegmentation(segmentation_config("dinov3_base"))
    return init_weights_(model, torch.Generator().manual_seed(seed)).cuda()


def fixture_batch(n: int, size: int):
    """A device batch of n letterboxed fixture variants (uint8 images and
    masks), as the loader and its upload produce it."""
    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch.training.data import letterbox

    image = np.array(Image.open(IMAGE).convert("RGB"))
    mask = np.array(Image.open(MASK).convert("L"))
    ims, ms = [], []
    for i in range(n):
        im, m = (image, mask) if i % 2 == 0 else (image[:, ::-1], mask[:, ::-1])
        a, b = letterbox(np.ascontiguousarray(im), np.ascontiguousarray(m), size)
        ims.append(a)
        ms.append(b)
    return {"images": torch.from_numpy(np.stack(ims)).cuda(),
            "masks": torch.from_numpy(np.stack(ms)).cuda()}


def train_step_phase(results):
    """`train_step` at ViT-B, 1024^2, batch 4, bf16 on one repeated batch:
    launches per step (the backward passes of K2, K4 and K5 too), median
    step time, img/s, peak memory, device time
    by kernel (forward kernels, K8, the rest), and learning (8 steps)."""
    import torch

    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    log("phase train step: ViT-B 1024^2 batch 4 bf16, one repeated batch")
    model = vit_b_model(2)
    opt = Optimizer(model, 1e-4, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    batch = fixture_batch(4, 1024)
    blocks = model.cfg.num_encoder_layers_used
    state = {"step": 0}

    def step():
        out = train_step(model, opt, loss_module, batch, 0, state["step"],
                         generator=torch.Generator().manual_seed(state["step"]),
                         compute_dtype=torch.bfloat16)
        state["step"] += 1
        return out

    losses = []
    for i in range(8):
        if i == 1:
            reset_counts()
        losses.append(float(step()["loss"]))
        if i == 1:
            counts, k8 = launch_counts(), k8_launches()
            passes = {name: fn.launches for name, fn in vjp_passes().items()}
            log(f"  launches in one step: {counts}, K8 {k8}, backward "
                f"passes {passes}")
            for name, cnt in counts.items():
                check(cnt == 2 * blocks, f"step: {name} launched {cnt}, "
                      f"want {2 * blocks} (forward + remat recompute)")
            check(k8 == blocks, f"step: K8 launched {k8}, want {blocks}")
            for name, cnt in passes.items():
                check(cnt == blocks, f"step: {name} launched {cnt}, want {blocks}")
                results[name]["launches"] = cnt
    log("  losses over 8 steps: " + " ".join(f"{v:.4f}" for v in losses))
    check(all(v == v and abs(v) < 1e6 for v in losses), "losses finite")
    check(losses[-1] < losses[0], "the loss falls on a repeated batch")
    tr = results["_train"]
    tr["losses_8_steps"] = losses
    tr["step_ms"] = cuda_ms(step, iters=5)
    tr["img_s"] = 4 / (tr["step_ms"] / 1e3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    tr["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rows = kernel_breakdown(step, iters=1)
    groups = {"K4": ("attn_epilogue",),
              "K1-K3, K5 forward": ("_ln_fwd", "qkv_", "flash_fwd", "flash_ws_fwd",
                                    "mlp_gemm", "mlp_fused"),
              "K8 backward": ("flash_bwd", "bwd_dkv", "bwd_dq", "bwd_delta"),
              "K2, K4, K5 backward passes": ("_rope_bwd", "_ln_bwd", "_gelu_bwd")}
    split = {g: 0.0 for g in groups}
    split["everything else"] = 0.0
    for key, ms, _ in rows:
        g = next((g for g, keys in groups.items()
                  if any(k in key for k in keys)), "everything else")
        split[g] += ms
    busy = sum(split.values())
    tr.update(busy_ms=busy, split_ms=split,
              top=[(k[:60], ms, cnt) for k, ms, cnt in rows[:12]])
    log(f"  step {tr['step_ms']:.2f} ms (CUDA events, median of 5), "
        f"{tr['img_s']:.2f} img/s, peak {tr['peak_gib']:.2f} GiB, device busy "
        f"{busy:.2f} ms; " + ", ".join(f"{g} {v:.2f} ms" for g, v in split.items()))
    for key, ms, count in rows[:16]:
        log(f"    {ms:8.3f} ms x{count:3d}  {key[:100]}")
    del model, opt
    torch.cuda.empty_cache()


def grad_agreement_phase(results):
    """Gradients of the bf16 kernel route at ViT-B, 1024^2, batch 2.
    (1) The training loss against fp32 exact mode: relative norms per
    parameter group (encoder, head) and of the loss (GRAD_TOL). (2) K8
    alone: a loss on the encoder's taps (no decoder, so the backward is
    deterministic) with K8 against K8's plain version as the backward,
    same forward (K8_GRAD_TOL). Then both with a planted K8 fault (dk x
    1.01 and x 1.1), which the second must catch."""
    import torch

    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops import mlp_fused as mf
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import preprocess

    log("phase gradient agreement: ViT-B 1024^2 batch 2, bf16 kernels vs fp32")
    model = vit_b_model(3)
    cfg = model.cfg
    blocks = cfg.num_encoder_layers_used
    c = cfg.encoder.hidden_size
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    batch = preprocess(fixture_batch(2, 1024))
    bn = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    gen = torch.Generator(device="cuda").manual_seed(5)
    tap_w = [torch.randn(2, 4096, c, generator=gen, device="cuda")
             for _ in cfg.tap_layers]

    def group_grads(module):
        return torch.cat([p.grad.flatten().float() for p in
                          module.parameters() if p.grad is not None])

    def model_grads(dtype):
        model.zero_grad()
        out = model(batch["images"].to(dtype), training=True)
        loss, _ = loss_module(out, batch, 0)
        loss.backward()
        model.load_state_dict(bn, strict=False)  # undo the running-stat step
        return {"loss": loss.detach().reshape(1),
                "encoder": group_grads(model.encoder),
                "head": group_grads(model.seg_head)}

    def tap_grads():
        model.zero_grad()
        taps = model.encoder(batch["images"].to(torch.bfloat16),
                             cfg.tap_layers, "kernel", remat=True)
        sum((t.float() * w).sum() for t, w in zip(taps, tap_w)).backward()
        # per block, the norm of the key rows of the fused qkv weight's
        # gradient: the product of the block's input with K8's dk
        return {"encoder": group_grads(model.encoder), "qkv_k": torch.stack([
            blk.attention.qkv.weight.grad[c: 2 * c].float().norm()
            for blk in model.encoder.layer[:blocks]])}

    def rel(got, ref):
        out = {k: float((got[k] - ref[k]).norm() / ref[k].norm())
               for k in ref if k != "qkv_k"}
        if "qkv_k" in ref:  # all blocks' key rows together
            out["qkv_k_norm"] = abs(float(got["qkv_k"].norm()
                                          / ref["qkv_k"].norm()) - 1)
        return out

    def k8_as(fn):
        return standing_in(fa, "flash_attention_bwd", fn)

    def show(tag, err, tol):
        bad = [k for k in tol if err[k] > tol[k]]
        log(f"  {tag}: " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f" -> {'outside' if bad else 'inside'} the bounds {tol}")
        return bad

    def plain_bwd(*args):
        return fa.flash_attention_bwd_plain(*args)

    def block_max(got, ref):  # the key rows' ratio, block by block
        return float((got["qkv_k"] / ref["qkv_k"] - 1).abs().max())

    def flipped_mlp(seed):
        """The plain MLP with one-ulp flips on ~0.2% of its outputs, chosen
        by a hash of each element's value and position: the same inputs
        give the same flips, so remat's recomputation agrees."""
        def fn(*args, return_hidden=False):
            out = mf.mlp_fused_plain(*args)
            bits = out.view(torch.int16)
            idx = torch.arange(out.numel(), device=out.device).view(out.shape)
            h = (bits.to(torch.int64) * 40503 + idx * 2654435761
                 + seed * 97) % 1000003
            step = torch.where(h % 2 == 0, 1, -1).to(torch.int16)
            return torch.where(h % 500 == 0, (bits + step).view(out.dtype), out)
        return fn

    g32 = model_grads(torch.float32)
    err = rel(model_grads(torch.bfloat16), g32)
    t_kernel = tap_grads()
    with k8_as(plain_bwd):
        t_plain = tap_grads()
    err_k8 = rel(t_kernel, t_plain)
    err_repeat = rel(tap_grads(), t_kernel)
    tr = results["_train"]
    tr.update(grad_rel_err=err, grad_rel_err_k8_vs_plain=err_k8,
              grad_k8_repeat=err_repeat)
    # How the key-row statistics move with the forward's rounding alone
    # (K8 unchanged): the plain MLP with seeded one-ulp flips.
    spread = []
    real_mlp = mf.mlp_fused
    try:
        for seed in range(8):
            mf.mlp_fused = flipped_mlp(seed)
            t_k = tap_grads()
            with k8_as(plain_bwd):
                t_p = tap_grads()
            spread.append((block_max(t_k, t_p), rel(t_k, t_p)["qkv_k_norm"]))
    finally:
        mf.mlp_fused = real_mlp
    log(f"  key rows, K8 vs its plain version, block by block (largest): "
        f"{block_max(t_kernel, t_plain):.3e}; over 8 forwards with one-ulp "
        f"flips on 0.2% of the plain MLP's outputs: block by block "
        f"{min(b for b, _ in spread):.3e} to {max(b for b, _ in spread):.3e}, "
        f"all blocks together {min(a for _, a in spread):.3e} to "
        f"{max(a for _, a in spread):.3e}")
    tr["k8_key_rows_under_rounding"] = spread
    check(not show("bf16 kernel route vs fp32 exact (training loss)", err,
                   GRAD_TOL), f"gradient agreement with fp32 {err}")
    check(not show("tap loss: K8 vs its plain version", err_k8, K8_GRAD_TOL),
          f"K8 gradient agreement {err_k8}")
    show("tap loss: K8 vs itself (run-to-run)", err_repeat, K8_GRAD_TOL)
    real = fa.flash_attention_bwd
    planted = {}
    for factor in (1.01, 1.1):
        def faulty(*args, _f=factor):
            dq, dk, dv = real(*args)
            return dq, dk * _f, dv
        with k8_as(faulty):
            e32 = rel(model_grads(torch.bfloat16), g32)
            ek8 = rel(tap_grads(), t_plain)
        show(f"planted dk x {factor}, training loss vs fp32", e32, GRAD_TOL)
        bad = show(f"planted dk x {factor}, tap loss vs plain K8", ek8,
                   K8_GRAD_TOL)
        planted[str(factor)] = {"vs_fp32": e32, "vs_plain_k8": ek8,
                                "caught": bool(bad)}
        check(bool(bad), f"the planted K8 fault dk x {factor} went unnoticed")
    tr["planted"] = planted
    del model, tap_w
    torch.cuda.empty_cache()


def highres_train_phase(results):
    """One `train_step` at 2048^2, batch 1 (config/dataset/dis2048.yaml's
    canvas): K6 forward and K8 at 16448 tokens; loss and gradients
    finite."""
    import torch

    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    log("phase train step at 2048^2, batch 1 (16389 tokens)")
    model = vit_b_model(4)
    opt = Optimizer(model, 1e-5, steps_per_epoch=1)
    batch = fixture_batch(1, 2048)
    reset_counts()
    t0 = time.perf_counter()
    out = train_step(model, opt, LossModule(LOSS_PRESETS["focal_iou"]), batch,
                     0, 0, generator=torch.Generator().manual_seed(0),
                     compute_dtype=torch.bfloat16)
    loss = float(out["loss"])
    dt = time.perf_counter() - t0
    blocks = model.cfg.num_encoder_layers_used
    k8 = k8_launches()
    finite = all(bool(p.grad.isfinite().all()) for p in model.parameters()
                 if p.grad is not None)
    log(f"  loss {loss:.4f}, gradients finite {finite}, K8 launches {k8}, "
        f"{dt:.2f} s with the first-call set-up")
    check(loss == loss and finite, "2048^2 train step not finite")
    check(k8 == blocks, f"2048^2 step: K8 launched {k8}, want {blocks}")
    results["_train"]["step_2048_loss"] = loss
    del model, opt
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# The training path's augmentation, remat policies and demo
# ----------------------------------------------------------------------------

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
DEMO_ROOT = REPO / "build" / "chip_smoke_demo"
# The demo's recipe that trains from scratch (the JAX package's recorded
# one, benchmarks/RESULTS.md's 160px runs: at the script's defaults,
# focal_iou from scratch saturates to empty masks on both packages), with
# the script's own regular augmentation and the letterbox cache, cut to 4
# of its 40 epochs (8 until PR 17's phases needed the time; the warmup is
# 8 epochs either way, and val_dice passed 0.5 from the second epoch in
# PR 16's and PR 17's runs). The smoke holds the gate of `train_demo_e2e.py:214`
# (val_dice and holdout IoU > 0.5) and records the selection gap, which the
# script adds with the ranking term (`:215-219`) and which closes only with
# longer training (PERF.md §6).
DEMO_ARGS = ["--model", "dinos", "--image-size", "160", "--epochs", "4",
             "--lr", "1e-4", "--head-lr-mult", "3", "--loss", "bce_iou_ssim",
             "--rank-weight", "1.0", "--cache"]


def host_geometry(n: int, size: int, mode: str, seed: int):
    """The loader's per-sample geometry for one batch: crop p 0.5, then
    the rotation and (synthetic) distortion draws
    (`PrefetchLoader.draw_geometry`)."""
    from s3od_torch.training.data import PrefetchLoader

    loader = PrefetchLoader([], n, seed=seed, random_resized_crop_p=0.5,
                            geometric_mode=mode)
    return loader.draw_geometry(0, 0, n, size)


def forced_plan(gen, b, h, w, mode, device):
    """An `augment_batch` plan in which every branch of every stage runs:
    sample i takes branch i mod the stage's branch count; every sample is
    rotated and, in synthetic mode, distorted (optical, grid, elastic,
    perspective in turn)."""
    import torch

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


def to_device(tree, device):
    import torch

    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree


def augment_phase(results):
    """The training input pipeline at 1024^2, batch 4 (config/dataset/
    synth.yaml's batch), regular and synthetic: every stage of a plan that
    takes every branch, run on the card and on the CPU from the same input
    and parameters (`AUG_TOL`); the masks unchanged by the photometric
    stages; device ms a batch of `train_pre` (the loader's geometry
    applied, `augment_batch`, the normalization) and of `augment_batch`
    alone (CUDA events, median of 10), and the profiler's top five ops."""
    import numpy as np
    import torch

    from s3od_torch.ops import augment as A
    from s3od_torch.ops.warp import apply_host_geometry
    from s3od_torch.training.train import train_pre

    log("phase augment: the training input pipeline at 1024^2, batch 4")
    r = results["_augment"] = {}
    batch = fixture_batch(4, 1024)
    images, masks = batch["images"], batch["masks"]
    for mode in ("regular", "synthetic"):
        rm = r[mode] = {}
        # every stage on the card vs the CPU, on the same input and draws
        plan = forced_plan(torch.Generator().manual_seed(3), 4, 1024, 1024,
                           mode, images.device)
        cpu_plan = to_device(plan, "cpu")
        x = images.float() / 255.0
        m = masks.float() / 255.0
        worst, rounded = {}, {}
        x, m = A.random_flips(x, m, plan["flips"])
        xg, mg = A.geometric_warp(x, m, plan["geometric"])
        xc, mc = A.geometric_warp(x.cpu(), m.cpu(), cpu_plan["geometric"])
        worst["geometric"] = float((xg.cpu() - xc).abs().max())
        check(torch.equal(mg.cpu(), mc), f"{mode}: warped masks differ")
        stages = A._stages(mode, True)
        for (name, _, _, ops), st, cst in zip(stages, plan["stages"],
                                               cpu_plan["stages"]):
            for i, (op, _) in enumerate(ops):
                idx = [j for j, k in enumerate(st["branch"]) if k == i]
                inp = xg[idx]
                got = op(inp, st["params"][i]).cpu()
                ref = op(inp.cpu(), cst["params"][i])
                d = (got - ref).abs()
                key = f"{name}.{op.__name__}"
                worst[key] = float(d.max())
                rounded[key] = float((d > AUG_TOL).float().mean())
        geo = host_geometry(4, 1024, mode, seed=5)
        hi, hm = apply_host_geometry(images, masks, geo)
        ci, cm = apply_host_geometry(images.cpu(), masks.cpu(), geo)
        worst["host_geometry_levels"] = float(
            (hi.cpu().float() - ci.float()).abs().max())
        check(torch.equal(hm.cpu(), cm), f"{mode}: host-geometry masks differ")
        log(f"  {mode}: card vs CPU per stage, max abs "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        for k, v in worst.items():
            if k == "host_geometry_levels":
                check(v <= 1.0, f"{mode}: host geometry {v} grey levels apart")
            elif k == "geometric":
                check(v <= AUG_WARP_TOL, f"{mode}: {k} card vs CPU {v}")
            elif k == "quality.jpeg_compression":
                check(rounded[k] <= AUG_ROUNDED_SHARE,
                      f"{mode}: {k}: {rounded[k]} of values past {AUG_TOL}")
            else:
                check(v <= AUG_TOL, f"{mode}: {k} card vs CPU {v}")
        rm.update(card_vs_cpu=worst, rounded_share=rounded)

        # masks through the photometric stages alone
        photo = {**plan, "flips": {k: torch.zeros_like(v) if v.dtype == torch.bool
                                   else v for k, v in plan["flips"].items()}}
        photo.pop("geometric")
        _, m_out = A.apply_augment(images, masks.float() / 255.0, photo)
        check(torch.equal(m_out, masks.float() / 255.0),
              f"{mode}: the photometric stages changed the masks")

        # device ms a batch, as training runs it
        state = {"i": 0}

        def pre():
            state["i"] += 1
            return train_pre(batch, host_geometry(4, 1024, mode, state["i"]),
                             mode, torch.Generator().manual_seed(state["i"]))

        def aug_only():
            state["i"] += 1
            return A.augment_batch(images, masks.float() / 255.0, mode,
                                   torch.Generator().manual_seed(state["i"]),
                                   device_geometric=False)

        rm["train_pre_ms"] = cuda_ms(pre, iters=10)
        rm["augment_batch_ms"] = cuda_ms(aug_only, iters=10)
        rows = kernel_breakdown(pre, iters=4)
        rm["busy_ms"] = sum(ms for _, ms, _ in rows)
        rm["top5"] = [(k[:60], ms, c) for k, ms, c in rows[:5]]
        log(f"  {mode}: train_pre {rm['train_pre_ms']:.2f} ms a batch "
            f"(augment_batch alone {rm['augment_batch_ms']:.2f}), device busy "
            f"{rm['busy_ms']:.2f} ms; top five ops:")
        for key, ms, cnt in rows[:5]:
            log(f"    {ms:8.3f} ms x{cnt:3d}  {key[:100]}")
        out = pre()
        check(out["images"].shape == (4, 1024, 1024, 3)
              and bool(out["images"].isfinite().all())
              and out["masks"].shape == (4, 1024, 1024),
              f"{mode}: train_pre output")
    del batch
    torch.cuda.empty_cache()


def remat_phase(results):
    """`train_step` at ViT-B, 1024^2, batch 4, bf16 on a synthetic-mode
    augmented batch under each remat policy, in turns (none, flash,
    dots_flash, dots_flash, flash, none; 1 warm-up + 3 timed steps each):
    step ms (CUDA events, median), peak GiB, and K3 / K8 launches a step
    against the policy table (K3: 22 / 11 / 11, K8: 11)."""
    import torch

    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train import train_pre
    from s3od_torch.training.train_step import train_step

    log("phase remat: ViT-B 1024^2 batch 4 bf16, synthetic augmentation, "
        "policies none / flash / dots_flash in turns")
    model = vit_b_model(6)
    opt = Optimizer(model, 1e-5, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    raw = fixture_batch(4, 1024)
    batch = train_pre(raw, host_geometry(4, 1024, "synthetic", 9), "synthetic",
                      torch.Generator().manual_seed(9))
    blocks = model.cfg.num_encoder_layers_used
    wr = wrappers()
    r = results["_train"]["remat"] = {}
    state = {"step": 0}

    def step(policy):
        out = train_step(model, opt, loss_module, batch, 0, state["step"],
                         generator=torch.Generator().manual_seed(0),
                         compute_dtype=torch.bfloat16, remat_policy=policy,
                         preprocessed=True)
        state["step"] += 1
        return out

    for policy in ("none", "flash", "dots_flash", "dots_flash", "flash", "none"):
        step(policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = float(step(policy)["loss"])
        k3, k8 = wr["K3_flash_attention"].launches, k8_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(policy)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        log(f"  {policy:10s} step {ms:.2f} ms, peak {peak:.2f} GiB, K3 {k3}, "
            f"K8 {k8} a step, loss {loss:.4f}")
        check(k3 == REMAT_K3[policy] * blocks and k8 == blocks,
              f"{policy}: K3 {k3}, K8 {k8} a step, want "
              f"{REMAT_K3[policy] * blocks}, {blocks}")
        check(loss == loss, f"{policy}: loss not finite")
        r.setdefault(policy, []).append(
            {"step_ms": ms, "peak_gib": peak, "k3": k3, "k8": k8})
    del model, opt, batch, raw
    torch.cuda.empty_cache()


def train_options_phase(results):
    """The entry point with what this part of the port added: ViT-B 1024^2
    b4 bf16 with `dataset.transform_mode=synthetic backend.remat_policy=flash
    backend.split_augment=true` (one epoch, launches counted: K3 once a
    block a step under flash), then one short run each with
    `dataset.cache=true` and `train_stage.enable_image_logging=true` at
    the tiny checkpoint's width (D = 32)."""
    import shutil

    import numpy as np

    from s3od_torch.configs import segmentation_config
    from s3od_torch.training.train import train

    if TRAIN_ROOT.exists():
        shutil.rmtree(TRAIN_ROOT)
    write_fixture_dataset(TRAIN_ROOT)
    blocks = segmentation_config("dinov3_base").num_encoder_layers_used
    steps, val_batches = 16 // 4, 4 // 4
    tr = results["_train"]
    log("phase train options: synthetic augmentation + remat flash + "
        "split_augment at ViT-B 1024^2 b4")
    extra = ["dataset.transform_mode=synthetic", "backend.remat_policy=flash",
             "backend.split_augment=true", "backend.max_epochs=1"]
    args = [a for a in train_args(TRAIN_ROOT, "c") if "transform_mode" not in a]
    reset_counts()
    t0 = time.perf_counter()
    metrics = train(args + extra)
    tr["synthetic_flash_s"] = time.perf_counter() - t0
    counts, k8 = launch_counts(), k8_launches()
    log(f"  train() {tr['synthetic_flash_s']:.1f} s; launches {counts}, K8 {k8};"
        f" train_loss {metrics['train_loss']:.4f}")
    for name, cnt in counts.items():
        per_step = 1 if name == "K3_flash_attention" else 2
        want = steps * per_step * blocks + val_batches * blocks
        check(cnt == want, f"synthetic + flash: {name} launched {cnt}, want {want}")
    check(k8 == steps * blocks, f"synthetic + flash: K8 launched {k8}")
    check(all(np.isfinite(v) for v in metrics.values()), "metrics finite")

    tiny = ["model=tiny", f"init_checkpoint={TINY_1024}", "backend.max_epochs=1",
            "dataset.transform_mode=regular"]
    base = [a for a in train_args(TRAIN_ROOT, "d") if "transform_mode" not in a]
    metrics = train(base + tiny + ["dataset.cache=true"])
    cache = TRAIN_ROOT / "fixture" / ".s3od_cache" / "s1024"
    log(f"  dataset.cache=true: {sorted(p.name for p in cache.iterdir())}, "
        f"val_dice {metrics['val_dice']:.4f}")
    check((cache / "images.npy").exists() and (cache / "meta.json").exists(),
          "the letterbox cache was built")
    check(all(np.isfinite(v) for v in metrics.values()), "cache run finite")
    base = [a for a in train_args(TRAIN_ROOT, "e") if "transform_mode" not in a]
    metrics = train(base + tiny + ["train_stage.enable_image_logging=true"])
    logs = list((TRAIN_ROOT / "e" / "logs").iterdir())
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:
        tags = None
        log("  image logging: tensorboard is not installed, so train() runs "
            "without a writer and logs no panels")
    else:
        ea = EventAccumulator(str(logs[0]))
        ea.Reload()
        tags = ea.Tags()["images"]
        log(f"  image logging: {tags}")
        check(1 <= len(tags) <= 8 and tags == [
            f"val_images/epoch_0_img_{i}" for i in range(len(tags))],
            f"image panels {tags}")
    tr["options"] = {"cache": True, "image_tags": tags}
    shutil.rmtree(TRAIN_ROOT)


def demo_step_profile(results):
    """One `train_step` at the demo's size (ViT-S, 160^2, batch 8, the
    demo's loss) in float32 and in bf16: ms between CUDA events, the
    device's busy time and kernel count (profiler), and the host's time to
    enqueue one step with the device idle."""
    import copy

    import torch

    from s3od_torch.configs import segmentation_config
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_
    from s3od_torch.ops.precision import set_exact_float32
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    loss_cfg = copy.deepcopy(LOSS_PRESETS["bce_iou_ssim"])
    loss_cfg["criterions"].append(dict(
        name="rank_ious_loss", target_key="gt_ious", output_key="pred_iou",
        weight=1.0, kind="rank", add_sigmoid=False))
    batch = fixture_batch(8, 160)
    r = results["_demo_step"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.float32:
            set_exact_float32()  # as train() does for precision 32
        model = init_weights_(S3ODSegmentation(segmentation_config(
            "dinov3_small")), torch.Generator().manual_seed(0)).cuda()
        opt = Optimizer(model, 1e-4, steps_per_epoch=67, grad_clip=1.0)
        loss_module = LossModule(loss_cfg)
        state = {"i": 0}

        def step():
            train_step(model, opt, loss_module, batch, 0, state["i"],
                       generator=torch.Generator().manual_seed(0),
                       compute_dtype=dtype, remat_policy="flash")
            state["i"] += 1

        ms = cuda_ms(step, iters=10)
        rows = kernel_breakdown(step, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        busy = sum(t for _, t, _ in rows)
        name = str(dtype).split(".")[-1]
        r[name] = {"step_ms": ms, "busy_ms": busy, "host_enqueue_ms": host_ms,
                   "kernels": sum(c for _, _, c in rows)}
        log(f"  demo-size step ({name}): {ms:.2f} ms between CUDA events, "
            f"device busy {busy:.2f} ms in {r[name]['kernels']} kernels, "
            f"the host enqueues one step in {host_ms:.2f} ms")
        del model, opt
    torch.cuda.empty_cache()


def demo_phase(results):
    """`python -m s3od_torch.training.demo_e2e` in-process at `DEMO_ARGS`:
    the procedural dataset (600 images), ViT-S trained from scratch at
    160^2 (float32, regular augmentation, remat flash, bce_iou_ssim with
    the IoU-ranking term), the export reloaded by BackgroundRemoval and
    scored; val_dice > 0.5 and holdout IoU > 0.5 must hold (the script's
    gate; the selection gap it adds with the ranking term is recorded).
    Cut from the script's defaults: ViT-S at 160^2 (not ViT-B at 224^2),
    4 epochs (not 16), the recipe above, the letterbox cache."""
    import shutil

    from s3od_torch.training import demo_e2e

    import torch

    # float32 training turns TF32 off process-wide; the later phases keep
    # the flags they had
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    demo_step_profile(results)
    if DEMO_ROOT.exists():
        shutil.rmtree(DEMO_ROOT)
    log(f"phase demo: demo_e2e {' '.join(DEMO_ARGS)}")
    t0 = time.perf_counter()
    summary = demo_e2e.run(demo_e2e.parse_args(
        ["--root", str(DEMO_ROOT), *DEMO_ARGS]))
    secs = time.perf_counter() - t0
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags
    log(f"  demo {secs:.1f} s: val_dice {summary['val_dice']:.4f}, holdout "
        f"IoU {summary['holdout_iou']:.4f} (oracle {summary['holdout_best_iou']:.4f}, "
        f"selection gap {summary['selection_gap']:.4f}; the full gate "
        f"{'passed' if summary['ok'] else 'not passed'})")
    results["_demo"] = {"s": secs, "args": DEMO_ARGS,
                        "full_gate": summary["ok"],
                        **{k: summary[k] for k in ("val_dice", "train_loss",
                                                   "holdout_iou",
                                                   "holdout_best_iou",
                                                   "selection_gap", "eval")}}
    check(summary["val_dice"] > 0.5 and summary["holdout_iou"] > 0.5,
          f"demo gate: val_dice {summary['val_dice']}, holdout IoU "
          f"{summary['holdout_iou']}")
    shutil.rmtree(DEMO_ROOT)


AOT_ROOT = REPO / "build" / "chip_smoke_aot"
TOOLS_ROOT = REPO / "build" / "chip_smoke_tools"
AOT_STEP = 1 / 255 + 1e-6  # payload "best": one uint8 step of the mask
MINE_TOL = 2e-2   # bf16 vs fp32 mining score (an S-measure product in [0, 1])


def host_ms(fn, reps: int = 5, calls: int = 3) -> float:
    """Host time to enqueue one call of `fn`: the wall time of `calls`
    calls back to back after a synchronise, over `calls` (median of
    `reps`), timed until they return, before the card finishes (were the
    launch queue to fill, the time would approach the card's). A call
    made alone after a synchronise read ~1.5x the back-to-back rate on
    the H100 hosts, so the calls run in a row."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def cold_start(code: str) -> dict:
    """Run `code` in a fresh `python` process; it prints one JSON object
    as its last line. Adds the wall seconds from spawn to exit."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"cold start failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["wall_s"] = wall
    return res


COLD_CODE = """
import json, time
t0 = time.perf_counter()
import numpy as np, torch
from PIL import Image
from s3od_torch import BackgroundRemoval
t1 = time.perf_counter()
pred = {load}
t2 = time.perf_counter()
r = pred.remove_background(np.array(Image.open({image!r}).convert("RGB")))
torch.cuda.synchronize()
t3 = time.perf_counter()
print(json.dumps({{"import_s": t1 - t0, "load_s": t2 - t1,
                   "first_answer_s": t3 - t2, "to_answer_s": t3 - t0,
                   "iou0": float(r.all_ious[0])}}))
"""


def bundle_bytes(path: Path) -> dict:
    graphs = sum(p.stat().st_size for p in path.glob("*.pt2"))
    return {"graphs": graphs, "weights": (path / "weights.npz").stat().st_size}


def aot_vs_eager(slot, aot, eager, imgs, payload, counts_want):
    """The bundle predictor's answers against the eager predictor's on the
    same images (batch 1 and the batch of all of `imgs`), the launches of
    K1-K5 per forward through the graphs, and the largest differences."""
    import numpy as np
    import torch

    tol = 1e-5 if payload == "full" else AOT_STEP
    d_mask = d_iou = 0.0
    reset_counts()
    got = aot.remove_background(imgs[0], payload=payload)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(all(v == counts_want for v in counts.values()),
          f"bundle b1 {payload}: launches {counts}, want {counts_want} each")
    ref = eager.remove_background(imgs[0], payload=payload)
    pairs = [(got, ref)]
    if len(imgs) > 1:
        reset_counts()
        got_b = aot.remove_background_batch(imgs, payload=payload)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(all(v == counts_want for v in counts.values()),
              f"bundle b{len(imgs)} {payload}: launches {counts}")
        pairs += list(zip(got_b, eager.remove_background_batch(imgs, payload=payload)))
    for g, r in pairs:
        d_mask = max(d_mask, float(np.abs(g.all_masks - r.all_masks).max()))
        d_iou = max(d_iou, float(np.abs(g.all_ious - r.all_ious).max()))
    slot[f"d_mask_{payload}"] = max(slot.get(f"d_mask_{payload}", 0.0), d_mask)
    slot[f"d_iou_{payload}"] = max(slot.get(f"d_iou_{payload}", 0.0), d_iou)
    check(d_mask <= tol and d_iou <= 1e-5,
          f"bundle vs eager ({payload}, {len(pairs)} answers): max|d mask| "
          f"{d_mask}, max|d iou| {d_iou}")
    return counts


def route_rates(aot, eager, canvases, iters):
    """img/s of the device forward on uint8 canvases through the bundle and
    eagerly, by CUDA events around `iters` back-to-back forwards (the host
    is in it where it is the slower), in turns: eager, bundle, bundle,
    eager; and each route's host time per forward."""
    import torch

    x = torch.from_numpy(canvases).cuda()
    b = x.shape[0]
    fns = {"eager": lambda: eager._forward_device(x, "full"),
           "bundle": lambda: aot._forward_device(x, "full")}
    ms = {k: [] for k in fns}
    for name in ("eager", "bundle", "bundle", "eager"):
        ms[name].append(run_ms(fns[name], iters))
    out = {f"{k}_img_s": b / (min(v) / 1e3) for k, v in ms.items()}
    out.update({f"{k}_fwd_ms": min(v) for k, v in ms.items()})
    out.update({f"{k}_host_ms": host_ms(f) for k, f in fns.items()})
    return out


def aot_phase(results):
    """The serving bundle at ViT-B width from seeds, bf16, exported on the
    card: 1024^2 b1/b16 x full/best, 2048^2 b1 best (K6 through a graph),
    1024^2 b1 full with both decoder gates on (K9a, K9b, K10); each bundle
    verified, its predictor held against the eager predictor with launch
    counts, the weights held once, img/s and host time per forward on
    both routes, and cold starts in fresh processes."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch import BackgroundRemoval
    from s3od_torch.aot import ServingBundle, save_serving_bundle, verify_bundle
    from s3od_torch.convert import convert_state_dict, save_native

    log("phase aot: serving bundles of ViT-B (seeded, bf16) exported on the card")
    if AOT_ROOT.exists():
        shutil.rmtree(AOT_ROOT)
    AOT_ROOT.mkdir(parents=True)
    model = vit_b_model(0)
    per_forward = model.cfg.num_encoder_layers_used
    a = results["_aot"] = {"export_s": {}, "verify": {}}
    specs = {"b1024": dict(image_size=1024, batches=(1, B16)),
             "b2048": dict(image_size=2048, batches=(1,), payloads=("best",)),
             "gated": dict(image_size=1024, batches=(1,), payloads=("full",))}
    preds = {}
    for name, kw in specs.items():
        with decoder_gates(name == "gated"):
            out = save_serving_bundle(AOT_ROOT / name, model, **kw)
        meta = json.loads((out / "meta.json").read_text())
        a["export_s"].update({f"{name}/{k}": v for k, v in meta["export_s"].items()})
        a[f"bytes_{name}"] = bundle_bytes(out)
        preds[name] = pred = BackgroundRemoval.from_serving_bundle(out)
        a["verify"][name] = verify_bundle(ServingBundle(pred.model, meta, pred._aot), n=1)
        log(f"  bundle {name}: export s {meta['export_s']}, bytes "
            f"{a[f'bytes_{name}']}, verify_bundle max|d| {a['verify'][name]:.3e}")
    graphs = sum(a[f"bytes_{n}"]["graphs"] for n in specs)
    a["graphs_share"] = graphs / a["bytes_b1024"]["weights"]
    log(f"  all six graphs: {graphs} bytes, {100 * a['graphs_share']:.3f}% of "
        f"weights.npz ({a['bytes_b1024']['weights']} bytes)")
    check(a["graphs_share"] < 0.05, "the graphs must not hold the weights")

    image = np.array(Image.open(IMAGE).convert("RGB"))
    imgs = test_images(image)
    eager = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=1024)
    aot = preds.pop("b1024")
    check(sorted(aot._aot) == [(1, "best"), (1, "full"), (B16, "best"), (B16, "full")],
          f"bundle graphs {sorted(aot._aot)}")
    for payload in ("full", "best"):
        aot_vs_eager(a, aot, eager, imgs, payload, per_forward)
    reset_counts()
    aot.remove_background_batch(imgs[:3])  # no b3 graph: the eager route
    check(launch_counts()["K1_layer_norm"] == per_forward, "b3 eager fallback")
    c1 = np.stack([aot._preprocess(imgs[0])[0]])
    c16 = np.stack([aot._preprocess(im)[0] for im in imgs])
    for tag, c, iters in (("b1", c1, 20), ("b16", c16, 5)):
        rates = route_rates(aot, eager, c, iters)
        a[f"rates_{tag}"] = rates
        log(f"  1024^2 {tag}: bundle {rates['bundle_img_s']:.3f} img/s "
            f"({rates['bundle_fwd_ms']:.3f} ms, host {rates['bundle_host_ms']:.3f} ms"
            f" a forward), eager {rates['eager_img_s']:.3f} img/s "
            f"({rates['eager_fwd_ms']:.3f} ms, host {rates['eager_host_ms']:.3f} ms)")
    del aot, eager

    eager = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=2048)
    aot = preds.pop("b2048")
    counts = aot_vs_eager(a, aot, eager, imgs[:1], "best", per_forward)
    log(f"  2048^2 b1 best through the graph: launches {counts} (K6 is "
        f"the K3 wrapper's count), max|d mask| {a['d_mask_best']:.3e}")
    del aot, eager

    with decoder_gates(True):
        eager = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=1024)
        aot = preds.pop("gated")
        wraps = decoder_wrappers()
        gated = {}
        for tag, pred in (("eager", eager), ("bundle", aot)):
            for fn in wraps.values():
                fn.launches = 0
            reset_counts()
            res = pred.remove_background(imgs[0])
            torch.cuda.synchronize()
            gated[tag] = {**decoder_counts(wraps), **launch_counts()}
            gated[f"{tag}_res"] = res
        d = float(np.abs(gated["eager_res"].all_masks
                         - gated["bundle_res"].all_masks).max())
    a["gated"] = {"eager": gated["eager"], "bundle": gated["bundle"], "d_mask": d}
    log(f"  gated 1024^2 b1: launches eager {gated['eager']}, bundle "
        f"{gated['bundle']}, max|d mask| {d:.3e}")
    check(gated["eager"] == gated["bundle"], "gated launches differ")
    check(all(gated["bundle"][k] > 0 for k in wraps), "gated kernels unlaunched")
    check(d <= 1e-5, f"gated bundle vs eager: max|d mask| {d}")
    del aot, eager

    npz = AOT_ROOT / "vit_b.npz"
    save_native(str(npz), *convert_state_dict(model.cpu().state_dict(), model.cfg)[:2])
    a["cold"] = {
        "bundle": cold_start(COLD_CODE.format(
            load=f"BackgroundRemoval.from_serving_bundle({str(AOT_ROOT / 'b1024')!r})",
            image=str(IMAGE))),
        "npz": cold_start(COLD_CODE.format(
            load=f"BackgroundRemoval({str(npz)!r}, image_size=1024)",
            image=str(IMAGE)))}
    for k, v in a["cold"].items():
        log(f"  cold start from the {k}: {v['wall_s']:.2f} s to the first "
            f"answer (import {v['import_s']:.2f}, load {v['load_s']:.2f}, "
            f"first answer {v['first_answer_s']:.2f})")
    check(abs(a["cold"]["bundle"]["iou0"] - a["cold"]["npz"]["iou0"]) <= 1e-5,
          "the two cold starts answer alike")
    shutil.rmtree(AOT_ROOT)


def tools_phase(results):
    """`test_efficiency` at ViT-B 840^2 (b1 and b16, profiler summary),
    `mine_samples` with the tiny 1024^2 checkpoint (bf16 scores against
    fp32), `export_model --verify --aot-output` on it, and the demo's
    HTTP server on the card against a direct call."""
    import io
    import shutil
    import threading
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch import BackgroundRemoval, demo_app, export_model
    from s3od_torch.evaluation import mine_samples, test_efficiency
    from s3od_torch.evaluation.predictor import SODPredictor

    log("phase tools: test_efficiency at ViT-B 840^2, mine_samples, "
        "export_model, the demo server")
    if TOOLS_ROOT.exists():
        shutil.rmtree(TOOLS_ROOT)
    TOOLS_ROOT.mkdir(parents=True)
    t = results["_tools"] = {}
    model = vit_b_model(0)
    cfg, blocks = model.cfg.encoder, model.cfg.num_encoder_layers_used
    sod = SODPredictor(image_size=840, _predictor=BackgroundRemoval.from_model(
        model, image_size=840))
    for batch in (1, B16):
        r = test_efficiency.run_benchmark(
            input_size=840, batch=batch, _predictor=sod,
            output_file=str(TOOLS_ROOT / f"benchmark_results_b{batch}.txt"),
            trace_dir=str(TOOLS_ROOT / f"trace_b{batch}"))
        # K2 + K3 + K4 + K5 a block over 2709 tokens padded to 2752
        n, c, f = 2752, cfg.hidden_size, cfg.intermediate_size
        per_block = 6 * n * c * c + 4 * n * n * c + 2 * n * c * c + 4 * n * c * f
        want = batch * per_block * blocks
        t[f"b{batch}"] = {k: r[k] for k in ("fps", "latency_ms", "params",
                                            "flops", "s3od_flops", "peak_bytes",
                                            "tokens")}
        t[f"b{batch}"]["trace_top"] = r["trace_summary"]["by_category"][:6]
        log(f"  report b{batch}:\n" + r["report"])
        check(r["s3od_flops"] == want,
              f"s3od:: FLOPs {r['s3od_flops']} != the formulas' {want}")
        check(r["tokens"] == 2709, f"tokens at 840^2: {r['tokens']}")
        check(r["params"] > 100e6, f"params {r['params']}")
    log(f"  encoder FLOPs at 840^2 b1: {t['b1']['s3od_flops'] / 1e12:.4f} T over "
        f"2752 padded tokens (24 N C^2 + 4 N^2 C at N = 2709 gives "
        f"{11 * (24 * 2709 * 768**2 + 4 * 2709**2 * 768) / 1e12:.4f} T)")
    del sod, model

    image = np.array(Image.open(IMAGE).convert("RGB"))
    mask = np.array(Image.open(MASK).convert("L"))
    mine_dir = TOOLS_ROOT / "mine"
    for sub in ("images", "masks"):
        (mine_dir / sub).mkdir(parents=True)
    h, w = mask.shape
    variants = {"cat_0": (image, mask), "cat_1": (image[:, ::-1], mask[:, ::-1]),
                "dog_0": (image[h // 8:, : 7 * w // 8], mask[h // 8:, : 7 * w // 8]),
                "dog_1": (image[::-1], mask[::-1])}
    for name, (im, m) in variants.items():
        Image.fromarray(np.ascontiguousarray(im)).save(mine_dir / "images" / f"{name}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(mine_dir / "masks" / f"{name}.png")
    runs = {dt: mine_samples.mine(str(mine_dir), str(TINY_1024), img_size=1024,
                                  output_dir=str(TOOLS_ROOT / f"mine_{dt}"),
                                  dtype=dt)
            for dt in ("bfloat16", "float32")}
    d = max(abs(a - b) for cat in runs["float32"]["category_sample_scores"]
            for a, b in zip(runs["bfloat16"]["category_sample_scores"][cat],
                            runs["float32"]["category_sample_scores"][cat]))
    t["mine"] = {"scores_bf16": runs["bfloat16"]["category_scores"],
                 "scores_fp32": runs["float32"]["category_scores"],
                 "new_samples_bf16": runs["bfloat16"]["new_samples"],
                 "new_samples_fp32": runs["float32"]["new_samples"], "max_d": d}
    log(f"  mine_samples (tiny 1024^2): {t['mine']}")
    check(len(runs["bfloat16"]["category_scores"]) == 2, "two mined categories")
    check(d <= MINE_TOL, f"mining scores bf16 vs fp32 differ by {d}")

    ex = TOOLS_ROOT / "export"
    ex.mkdir()
    t["export_model"] = export_model.main([
        "--checkpoint", str(TINY_1024), "--output", str(ex / "s3od.npz"),
        "--torch-output", str(ex / "s3od.pt"), "--aot-output", str(ex / "bundle"),
        "--aot-batches", "1", "--verify"])
    log(f"  export_model --verify --aot-output (tiny, 1024^2 b1 bf16): "
        f"{t['export_model']}")

    pred = BackgroundRemoval(str(TINY_1024), image_size=1024)
    demo_app._model_cache["tiny"] = pred
    server = demo_app.make_http_server("tiny", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=buf.getvalue(), headers={"Content-Type": "image/png"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            info = json.loads(resp.headers["X-S3OD-Info"])
        t["demo_s"] = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    got = np.asarray(Image.open(io.BytesIO(body)))
    direct = pred.remove_background(image)
    same = bool(np.array_equal(got, np.asarray(direct.rgba_image)))
    t["demo"] = {"equal": same, "info": info}
    log(f"  demo POST /predict on the card: {t['demo_s']:.3f} s, equal to a "
        f"direct call: {same}, info {info}")
    check(same, "the demo's answer differs from a direct call")
    shutil.rmtree(TOOLS_ROOT)


# Bounds of `parallel_phase` (a): ||P - P_plain|| / ||P_plain|| over every
# parameter as one vector after two SGD steps from the same weights and
# batch, and the loss's relative difference. The steps run with torch's
# deterministic algorithms: without them two plain runs differ by 1.0e-2
# on a zero-init bias (its gradient's rounding; measured on one H100). With
# them a second plain run is bit-equal, and so must DDP over one rank be;
# FSDP2 rounds otherwise (1.05e-2 on a zero-init bias, as much as a
# planted x 1.01 on one parameter, so no per-parameter bound holds it):
# 1.5x measured: 8.534e-08 and 2.262e-06 in two runs (PERF.md, section
# 2). SGD, not AdamW: AdamW's first steps move every weight by ~lr
# whatever its gradient.
PAR_TOL = {"ddp": {"params": 0.0, "loss": 0.0},
           "plain2": {"params": 0.0, "loss": 0.0},
           "fsdp": {"params": 1.28e-7, "loss": 3.39e-6}}
PAR_LR = 1e-2
PAR_ROOT = REPO / "build" / "chip_smoke_parallel"


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (cuDNN's included) while the body
    runs."""
    import torch

    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[:2]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])


class ParSGD:
    """p -= lr * g over `params` (DTensors too), the optimizer interface
    `train_step` calls."""

    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, step):
        import torch

        with torch.no_grad():
            for p in self.params:
                if p.grad is not None:
                    p -= self.lr * p.grad


def par_errors(params, ref):
    """(relative norm over all parameters as one vector, the worst
    parameter's own relative norm, its name) of `params` against `ref`
    (both {name: fp32 tensor})."""
    worst, name, num, den = 0.0, None, 0.0, 0.0
    for n, p in ref.items():
        num += float((params[n] - p).double().pow(2).sum())
        den += float(p.double().pow(2).sum())
        e = rel_norm(params[n], p)
        if e > worst:
            worst, name = e, n
    return (num / den) ** 0.5, worst, name


def par_step_run(kind, batch):
    """Two ViT-B 1024^2 b4 bf16 steps from seed-2 weights (deterministic
    algorithms): the plain step, DDP over a one-rank NCCL group, or FSDP2
    through `shard_module` on a one-rank ("data", "fsdp") mesh. Returns
    losses, launches, the parameters after the steps, then step ms, peak
    GiB and the idle share (torch's default algorithms)."""
    import torch

    from s3od_torch.parallel import distributed as pd
    from s3od_torch.parallel.mesh import (full_tensor, make_mesh,
                                          shard_module, unwrap)
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import train_step

    model = vit_b_model(2)
    if kind != "plain":
        pd.ensure_group("cuda")
        model = shard_module(model, make_mesh(fsdp=1, device_type="cuda"),
                             wrap=kind)
    opt = ParSGD(unwrap(model).parameters(), PAR_LR)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    state = {"step": 0}

    def step():
        out = train_step(model, opt, loss_module, batch, 0, state["step"],
                         generator=torch.Generator().manual_seed(state["step"]),
                         compute_dtype=torch.bfloat16)
        state["step"] += 1
        return out

    reset_counts()
    with deterministic():
        losses = [float(step()["loss"]) for _ in range(2)]
    counts = dict(launch_counts(), K8=k8_launches())
    params = {n: full_tensor(p).detach().float().clone()
              for n, p in unwrap(model).named_parameters()}
    out = {"losses": losses, "counts": counts, "params": params,
           "wrapper": type(model).__name__}
    out["step_ms"] = cuda_ms(step, iters=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    busy = sum(ms for _, ms, _ in kernel_breakdown(step, iters=1))
    out["busy_ms"] = busy
    out["idle_share"] = max(0.0, 1.0 - busy / out["step_ms"]) if busy else None
    del model, opt
    pd.destroy()
    torch.cuda.empty_cache()
    return out


def parallel_phase(results):
    """Data parallelism on the card at world size 1, bf16, full width.
    (a) The ViT-B 1024^2 b4 train step in turns: plain, DDP over a one-rank
    NCCL group, FSDP2 through `shard_module` on a one-rank mesh, plain
    again, two steps each from the same seeded weights and batch: K1-K5
    and K8 launches equal to the plain step's, the loss and every
    parameter against the first plain run (PAR_TOL, a planted parameter x
    1.01 caught), step ms, peak GiB and the idle share. (b) The CLI under
    `torch.distributed.run --standalone --nproc_per_node=1` on the fixture
    dataset: it joins from the launcher's environment and writes the
    checkpoint keys of a plain run. (d) `BackgroundRemoval(data_parallel=
    True)` at 1024^2 b16 answers as `data_parallel=False`, and two
    replicas on the one card (`data_parallel=["cuda:0", "cuda:0"]`, the
    chunk of 16 split 8 + 8) answer as one replica at chunk 8."""
    import os
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch import BackgroundRemoval
    from s3od_torch.training.train import train

    r = results["_parallel"] = {}
    batch = fixture_batch(4, 1024)
    log("phase parallel (a): ViT-B 1024^2 b4 bf16 train step, 2 steps each: "
        "plain, DDP (1-rank NCCL), FSDP2 (1-rank mesh), plain")
    runs = {}
    for kind in ("plain", "ddp", "fsdp", "plain2"):
        runs[kind] = par_step_run("plain" if kind == "plain2" else kind,
                                  batch)
    ref = runs["plain"]
    for kind in ("ddp", "fsdp", "plain2"):
        got = runs[kind]
        check(got["counts"] == ref["counts"],
              f"{kind}: launches {got['counts']} != plain {ref['counts']}")
        err, worst, name = par_errors(got["params"], ref["params"])
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], ref["losses"]))
        r[kind] = {"wrapper": got["wrapper"], "param_rel": err,
                   "param_worst": [name, worst], "loss_rel": loss_err,
                   "step_ms": got["step_ms"], "peak_gib": got["peak_gib"],
                   "busy_ms": got["busy_ms"], "idle_share": got["idle_share"]}
        log(f"  {kind} ({got['wrapper']}): launches {got['counts']}; loss "
            f"{got['losses']} (rel {loss_err:.3e}); parameters rel. norm "
            f"{err:.3e}, the worst one {worst:.3e} ({name}); step "
            f"{got['step_ms']:.2f} ms, peak "
            f"{got['peak_gib']:.2f} GiB, busy {got['busy_ms']:.2f} ms, idle "
            f"share {got['idle_share']}")
        tol = PAR_TOL[kind]
        check(err <= tol["params"] and loss_err <= tol["loss"],
              f"{kind}: parameters {err:.3e} / loss {loss_err:.3e} over "
              f"{tol}")
        planted = dict(got["params"])
        key = "encoder.layer.0.attention.qkv.weight"
        planted[key] = planted[key] * 1.01
        r[kind]["planted_rel"] = par_errors(planted, ref["params"])[0]
        log(f"    planted {key} x 1.01: parameters rel. norm "
            f"{r[kind]['planted_rel']:.3e}")
        check(r[kind]["planted_rel"] > tol["params"],
              f"{kind}: a planted parameter x 1.01 passed")
    plain = ref
    r["plain"] = {"step_ms": plain["step_ms"], "peak_gib": plain["peak_gib"],
                  "busy_ms": plain["busy_ms"],
                  "idle_share": plain["idle_share"],
                  "counts": plain["counts"]}
    log(f"  plain: step {plain['step_ms']:.2f} ms, peak "
        f"{plain['peak_gib']:.2f} GiB, busy {plain['busy_ms']:.2f} ms; "
        f"DDP {r['ddp']['step_ms'] / plain['step_ms'] - 1:+.2%}, FSDP2 "
        f"{r['fsdp']['step_ms'] / plain['step_ms'] - 1:+.2%} against it")
    del runs
    torch.cuda.empty_cache()

    log("phase parallel (b): python -m torch.distributed.run --standalone "
        "--nproc_per_node=1 -m s3od_torch.training.train (ViT-B 1024^2 b4, "
        "1 epoch) against the same run in-process")
    if PAR_ROOT.exists():
        shutil.rmtree(PAR_ROOT)
    write_fixture_dataset(PAR_ROOT, n=10)
    args = train_args(PAR_ROOT, "plain", "backend.max_epochs=1",
                      "dataset.val_batch_size=2")
    reset_counts()
    train(args)
    plain_counts = dict(launch_counts(), K8=k8_launches())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "s3od_torch.training.train",
         *train_args(PAR_ROOT, "torchrun", "backend.max_epochs=1",
                     "dataset.val_batch_size=2")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    r["torchrun_s"] = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode:
        log(text[-4000:])
    check(proc.returncode == 0, f"torchrun exit {proc.returncode}")
    check("joined the process group from the launcher's environment: rank 0 "
          "of 1 (nccl)" in text, "the CLI joined through init_distributed's "
          "environment path")
    a = torch.load(only_run(PAR_ROOT / "plain") / "last" / "state.pt",
                   map_location="cpu", weights_only=False)
    b = torch.load(only_run(PAR_ROOT / "torchrun") / "last" / "state.pt",
                   map_location="cpu", weights_only=False)
    same_keys = (list(a["model"]) == list(b["model"])
                 and list(a["optimizer"]["state"]) == list(b["optimizer"]["state"])
                 and all(sorted(a["optimizer"]["state"][i]) ==
                         sorted(b["optimizer"]["state"][i])
                         for i in a["optimizer"]["state"]))
    with np.load(only_run(PAR_ROOT / "plain") / "s3od_final.npz") as za, \
            np.load(only_run(PAR_ROOT / "torchrun") / "s3od_final.npz") as zb:
        same_npz = sorted(za.files) == sorted(zb.files)
    worst = max(rel_norm(b["model"][k], a["model"][k]) for k in a["model"]
                if a["model"][k].is_floating_point()
                and a["model"][k].norm() > 0)
    r["torchrun"] = {"seconds": r["torchrun_s"], "same_keys": same_keys,
                     "same_npz_keys": same_npz, "worst_rel_vs_plain": worst,
                     "plain_counts": plain_counts}
    log(f"  torchrun run {r['torchrun_s']:.1f} s (process start and build "
        f"load included); checkpoint keys equal {same_keys}, export keys "
        f"equal {same_npz}; worst weight rel. norm vs the plain run "
        f"{worst:.3e}; plain run's launches {plain_counts}")
    check(same_keys and same_npz, "the torchrun checkpoint and export keep "
          "a plain run's keys")
    shutil.rmtree(PAR_ROOT)

    log("phase parallel (d): BackgroundRemoval(data_parallel=True) at 1024^2 "
        "b16 against data_parallel=False")
    imgs = test_images(np.array(Image.open(IMAGE).convert("RGB")))
    outs, parts = {}, {}
    for name, dp, chunk in (("plain", False, None), ("true", True, None),
                            ("plain8", False, 8),
                            ("two", ["cuda:0", "cuda:0"], None)):
        pred = BackgroundRemoval.from_model(vit_b_model(6), image_size=1024,
                                            device="cuda", data_parallel=dp)
        seen = []
        for i, (model, _, _) in enumerate(pred._replicas):
            model.register_forward_pre_hook(
                lambda m, a, i=i: seen.append((i, int(a[0].shape[0]))))
        outs[name] = pred.remove_background_batch(imgs, chunk=chunk,
                                                  payload="best")
        parts[name] = seen
        r[f"replicas_{name}"] = len(pred._replicas)
        del pred

    def same(a, b):
        return len(outs[a]) == len(outs[b]) == 16 and all(
            np.array_equal(x.predicted_mask, y.predicted_mask)
            and np.array_equal(x.all_ious, y.all_ious)
            for x, y in zip(outs[a], outs[b]))

    r["data_parallel_equal"] = same("plain", "true")
    r["two_replicas_equal"] = same("plain8", "two")
    r["two_replicas_parts"] = parts["two"]
    log(f"  {len(imgs)} images; data_parallel=True: replicas "
        f"{r['replicas_true']}, answers equal {r['data_parallel_equal']}; two "
        f"replicas on one card: forwards (replica, batch) {parts['two']}, "
        f"answers equal to one replica at chunk 8 {r['two_replicas_equal']}")
    check(r["data_parallel_equal"],
          "data_parallel=True answers as data_parallel=False")
    check(parts["two"] == [(0, 8), (1, 8)] and r["two_replicas_equal"],
          "two replicas split the chunk 8 + 8 and answer as one at chunk 8")
    torch.cuda.empty_cache()


def factory_step_run(pipe, inputs, reps=3):
    """A plain and a concept MMDiT step at 1024^2: (velocity of each, K7
    launches of each, median device ms of each, peak GiB)."""
    import torch

    from s3od_torch.ops import flash_attention as fa

    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, kw in (("plain", dict(inputs, concepts=None,
                                    pooled_concepts=None)),
                     ("concept", inputs)):
        with torch.no_grad():  # FSDP2's gathers need version counters
            fa.flash_attention_online.launches = 0
            res = pipe.model(**kw)
            launches = fa.flash_attention_online.launches
            ms = cuda_ms(lambda: pipe.model(**kw), iters=reps)
        out[name] = {"velocity": res["output"].float().clone(),
                     "launches": launches, "ms": ms}
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def parallel_factory_phase(results, pipe):
    """(c) The factory's MMDiT at FLUX.1-dev's full width (the
    `factory_phase` model, bf16): one plain and one concept step at 1024^2
    unsharded, then the same module sharded in place by FSDP2 over a
    one-rank mesh (`shard_module(wrap="fsdp")`, as `from_config(fsdp=1)`
    shards it): K7 57 and 76 launches a step, the velocity within
    K7_STEP_TOL, step ms and peak GiB."""
    import torch

    from s3od_torch.datagen.diffusion import (calculate_shift, make_img_ids,
                                              shifted_sigmas)
    from s3od_torch.parallel import distributed as pd
    from s3od_torch.parallel.mesh import make_mesh, shard_module

    r = results["_parallel"].setdefault("factory", {})
    log("phase parallel (c): FLUX.1-dev MMDiT 1024^2 plain + concept steps, "
        "unsharded, then sharded in place by FSDP2 over a 1-rank mesh")
    cfg, dev = pipe.cfg, pipe.device
    g = torch.Generator(device=dev).manual_seed(21)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ph = pw = 64
    sig = shifted_sigmas(28, calculate_shift(ph * pw))[25]
    inputs = dict(latents=randn(1, ph * pw, cfg.in_channels),
                  txt=randn(1, 512, cfg.text_dim),
                  pooled=randn(1, cfg.pooled_dim),
                  timestep=torch.full((1,), float(sig), device=dev),
                  img_ids=torch.from_numpy(make_img_ids(ph, pw)).to(dev),
                  txt_ids=torch.zeros(512, 3, device=dev),
                  guidance=torch.full((1,), 3.5, device=dev),
                  concepts=randn(1, 2, cfg.text_dim),
                  pooled_concepts=randn(1, cfg.pooled_dim),
                  concept_layers=pipe.concept_layers,
                  compute_dtype=torch.bfloat16)
    base = factory_step_run(pipe, inputs)
    pd.ensure_group("cuda")
    shard_module(pipe.model, make_mesh(fsdp=1, device_type="cuda"),
                 wrap="fsdp")
    sharded = factory_step_run(pipe, inputs)
    pd.destroy()
    for name in ("plain", "concept"):
        err = rel_norm(sharded[name]["velocity"], base[name]["velocity"])
        want = 57 if name == "plain" else 76
        r[name] = {"unsharded_ms": base[name]["ms"],
                   "sharded_ms": sharded[name]["ms"],
                   "launches": [base[name]["launches"],
                                sharded[name]["launches"]],
                   "velocity_rel": err}
        log(f"  {name} step: unsharded {base[name]['ms']:.2f} ms, sharded "
            f"{sharded[name]['ms']:.2f} ms ({sharded[name]['ms'] - base[name]['ms']:+.2f}); "
            f"K7 launches {r[name]['launches']} (want {want}); velocity rel. "
            f"norm {err:.3e} (<= {K7_STEP_TOL['velocity']:.1e})")
        check(r[name]["launches"] == [want, want],
              f"{name} step: K7 launches {r[name]['launches']}, want {want}")
        check(err <= K7_STEP_TOL["velocity"],
              f"{name} step: sharded velocity {err:.3e}")
    r["peak_gib"] = [base["peak_gib"], sharded["peak_gib"]]
    log(f"  peak GiB unsharded {base['peak_gib']:.2f}, sharded "
        f"{sharded['peak_gib']:.2f}")


# ----------------------------------------------------------------------------
# The last modules: teacher training, int8 residency, the converters and
# the filter chain
# ----------------------------------------------------------------------------

TEACHER_ROOT = REPO / "build" / "chip_smoke_teacher"
TEACHER_STEPS = 8
# The teacher's step: ViT-L (24 blocks, taps 4, 11, 17, 23: 23 run, none
# rematerialised), so each of K1-K5 and K8 runs once a block a step.
TEACHER_BLOCKS = 23
# The int8 MMDiT against the bf16 one it was quantized from: the JAX
# test's bound on the velocity (`tests/test_quant.py:101`).
INT8_VELOCITY_TOL = 5e-2


def teacher_samples():
    """Three image/mask pairs from the fixture pair, one per bucket: the
    photo (480 x 640 -> 896 x 1152), the photo turned (-> 1152 x 896) and
    its square centre (-> 1024^2). The names put the turned one in the
    validation split (`dataset.val_split=0.34`, seed 42), so the CLI trains
    on a non-square and the 1024^2 bucket."""
    import numpy as np
    from PIL import Image

    image = np.array(Image.open(IMAGE).convert("RGB"))
    mask = np.array(Image.open(MASK).convert("L"))
    c0 = (image.shape[1] - image.shape[0]) // 2
    sq = slice(c0, c0 + image.shape[0])
    return [("p_land", image, mask),
            ("q_tall", np.rot90(image), np.rot90(mask)),
            ("r_square", image[:, sq], mask[:, sq])]


def shadow_calls(kernel, plain, worst, n_out):
    """`kernel`, and beside each of its calls `plain` on the same inputs:
    the worst relative norm of each of the first `n_out` outputs over the
    calls in `worst[i]`, the smallest norm of a reference output in
    `worst["min_ref"]` (a zero cotangent would make the comparison
    vacuous), and each call's (q shape, n_valid) in `worst["calls"]`."""
    def call(*args):
        got = kernel(*args)
        ref = plain(*args)
        for i in range(n_out):
            worst[i] = max(worst.get(i, 0.0), rel_norm(got[i], ref[i]))
            worst["min_ref"] = min(worst.get("min_ref", float("inf")),
                                   float(ref[i].float().norm()))
        worst.setdefault("calls", []).append(
            (tuple(args[0].shape), int(args[-1])))
        return got
    return call


def teacher_phase(results, pipe):
    """Teacher training at `model/flux_teacher.yaml`'s width (ViT-L, 256
    features, FLUX dim 768, concept maps), bf16, on features the port's
    `feature_extraction.py` makes with the factory's models for three
    fixture-made images: (a) the CLI `config_name=train_teacher` for one
    epoch (two steps, the 1024^2 and a non-square bucket), its
    checkpoint and export back through `convert.load_teacher` and
    `SODTeacherPredictor` serving the export; (b) one step on the 896 x
    1152 sample with every K3 and K8 call held against its plain version
    (FLASH_NORM_TOL by relative norm), planted K3 o x 1.01 and K8 dk x
    1.01 caught at that shape; (c) 8 steps on one fixed 1024^2 sample at
    the recipe's learning rates (the loss must fall), launches a step,
    step ms, peak GiB and the idle share."""
    import numpy as np
    import torch
    from PIL import Image

    from s3od_torch.configs import segmentation_config
    from s3od_torch.convert import (load_teacher, save_native,
                                    teacher_tree_from_state_dict)
    from s3od_torch.datagen.feature_extraction import (FeatureStorage,
                                                       FluxFeatureExtractor)
    from s3od_torch.evaluation.teacher_predictor import SODTeacherPredictor
    from s3od_torch.models.flux_teacher import FluxTeacherConfig, init_flux_teacher
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.training.checkpoint import restore_external
    from s3od_torch.training.data import FluxFeatureDataset, collate_dicts
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train import train, upload
    from s3od_torch.training.train_step import teacher_forward, train_step

    r = results["_teacher"] = {}
    log("phase teacher: ViT-L FluxDPT (flux_dim 768, concept maps) bf16 on "
        "features extracted by the factory's MMDiT + VAE")
    subprocess.run(["rm", "-rf", str(TEACHER_ROOT)], check=True)
    ds = TEACHER_ROOT / "DUTS-TR"
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir(parents=True)
    storage = FeatureStorage(str(TEACHER_ROOT / "flux_features"))
    extractor = FluxFeatureExtractor(pipe, pipe.vae)
    t0 = time.perf_counter()
    for stem, im, m in teacher_samples():
        Image.fromarray(np.ascontiguousarray(im)).save(ds / "images" / f"{stem}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(ds / "masks" / f"{stem}.png")
        feats, cmaps = extractor.extract(np.ascontiguousarray(im),
                                         "a photograph", "object")
        storage.save(f"DUTS-TR_{stem}", feats, cmaps)  # the prefix fallback
    r["extract_s"] = time.perf_counter() - t0
    log(f"  features for 3 images in {r['extract_s']:.2f} s "
        f"(layer_0 {feats[0].shape}, maps {cmaps['category'].shape})")

    # (a) the CLI
    base = TEACHER_ROOT / "out"
    args = ["config_name=train_teacher", "backend=1chip",
            "dataset.paths=[DUTS-TR]", "dataset.val_split=0.34",
            "dataset.test_datasets=[]", "backend.max_epochs=1",
            "backend.num_threads=4", f"data_dir={TEACHER_ROOT}",
            f"base_dir={base}",
            f"flux_features_dir={TEACHER_ROOT / 'flux_features'}"]
    t0 = time.perf_counter()
    metrics = train(args)
    r["cli_s"] = time.perf_counter() - t0
    log(f"  CLI: one epoch in {r['cli_s']:.1f} s: loss "
        f"{metrics['train_loss']:.4f} val_loss {metrics['val_loss']:.4f}")
    check(all(np.isfinite(metrics[k]) for k in ("train_loss", "val_loss")),
          "teacher CLI: finite losses")
    run = only_run(base)
    exported = load_teacher(str(run / "s3od_final.npz"))
    check(exported.cfg.base.encoder.hidden_size == 1024
          and exported.cfg.flux_dim == 768, "teacher export: ViT-L, 768")
    sd = restore_external(str(run / "last"))[0]["model"]
    keys_equal = set(sd) == set(exported.state_dict())
    p, s = teacher_tree_from_state_dict(sd)
    save_native(str(TEACHER_ROOT / "ckpt.npz"), p, s)
    back = load_teacher(str(TEACHER_ROOT / "ckpt.npz"))
    same = all(torch.equal(v, back.state_dict()[k])
               for k, v in exported.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    log(f"  checkpoint keys = export keys {keys_equal}; checkpoint through "
        f"load_teacher equals the export {same}")
    check(keys_equal and same, "teacher checkpoint and export disagree")
    del exported, back, sd, p, s
    photo = np.array(Image.open(IMAGE).convert("RGB"))
    tpred = SODTeacherPredictor(str(run / "s3od_final.npz"), pipeline=pipe,
                                vae=pipe.vae)
    res = tpred.predict(photo, "a photograph", "object")
    log(f"  SODTeacherPredictor on the trained export: mask "
        f"{res.soft_mask.shape}, ious {np.round(res.all_ious, 4)}")
    check(res.soft_mask.shape == photo.shape[:2]
          and np.isfinite(res.soft_mask).all(), "teacher predictor: mask")
    del tpred
    torch.cuda.empty_cache()

    # (b) the non-square bucket on fresh weights, every K3 and K8 call
    # against its plain version; (c) the steps on one fixed 1024^2 sample
    ds_all = FluxFeatureDataset(str(ds), 1024, "train", 0.0,
                                flux_features_dir=str(TEACHER_ROOT / "flux_features"))
    by_stem = {Path(f).stem: i for i, f in enumerate(ds_all.files)}
    dev = torch.device("cuda")

    def batch_of(stem):
        return upload(collate_dicts([ds_all.load(by_stem[stem])]), dev)

    tcfg = FluxTeacherConfig(base=segmentation_config("dinov3_large"))
    model = init_flux_teacher(tcfg, torch.Generator().manual_seed(15)).cuda()
    # the recipe's AdamW (optimizer/adamw.yaml: 1e-5, the head at 10x)
    opt = Optimizer(model, 1e-5, head_lr_mult=10.0, steps_per_epoch=100)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    state = {"step": 0}

    def step(batch):
        out = train_step(model, opt, loss_module, batch, 0, state["step"],
                         generator=torch.Generator().manual_seed(state["step"]),
                         compute_dtype=torch.bfloat16, forward=teacher_forward)
        state["step"] += 1
        return out

    land = batch_of("p_land")
    check(tuple(land["images"].shape[1:3]) == (896, 1152),
          f"non-square bucket {tuple(land['images'].shape)}")
    k3_worst, k8_worst = {}, {}
    with standing_in(fa, "flash_attention", shadow_calls(
            fa.flash_attention, fa.flash_attention_plain, k3_worst, 1)), \
            standing_in(fa, "flash_attention_bwd", shadow_calls(
                fa.flash_attention_bwd, fa.flash_attention_bwd_plain,
                k8_worst, 3)):
        loss = float(step(land)["loss"])
    shapes = sorted(set(k3_worst.pop("calls")))
    k8_calls = k8_worst.pop("calls")
    k8_min_ref = k8_worst.pop("min_ref")
    k3_worst.pop("min_ref")
    log(f"  896 x 1152 step (loss {loss:.4f}): K3 calls {len(shapes)} shape(s) "
        f"{shapes} (q shape, n_valid), {len(k8_calls)} K8 calls; worst rel. "
        f"norm K3 o {k3_worst[0]:.3e}, K8 dq {k8_worst[0]:.3e} dk "
        f"{k8_worst[1]:.3e} dv {k8_worst[2]:.3e} (<= {FLASH_NORM_TOL}); the "
        f"smallest K8 reference norm {k8_min_ref:.3e}")
    r["non_square"] = {"k3_calls": shapes, "k3_o": k3_worst[0],
                       "k8": [k8_worst[i] for i in range(3)],
                       "k8_min_ref_norm": k8_min_ref}
    check(shapes == [((16, 4096, 64), 4037)],
          f"K3 at the 56 x 72 grid: {shapes}")
    check(len(k8_calls) == TEACHER_BLOCKS and k8_min_ref > 0,
          "K8 calls in the non-square step, with nonzero gradients")
    check(k3_worst[0] <= FLASH_NORM_TOL and max(k8_worst.values())
          <= FLASH_NORM_TOL, "teacher shapes: K3 / K8 against plain")

    square = batch_of("r_square")
    losses = []
    for i in range(TEACHER_STEPS):
        if i == 1:
            reset_counts()
        losses.append(float(step(square)["loss"]))
        if i == 1:
            counts, k8 = launch_counts(), k8_launches()
            log(f"  launches in one step: {counts}, K8 {k8}")
            r["launches_per_step"] = dict(counts, K8=k8)
            for name, cnt in counts.items():
                check(cnt == TEACHER_BLOCKS, f"teacher step: {name} launched "
                      f"{cnt}, want {TEACHER_BLOCKS}")
            check(k8 == TEACHER_BLOCKS, f"teacher step: K8 launched {k8}")
    log("  losses over 8 steps: " + " ".join(f"{v:.4f}" for v in losses))
    check(all(np.isfinite(losses)), "teacher losses finite")
    check(losses[-1] < losses[0], "the teacher's loss falls on a fixed sample")
    r["losses_8_steps"] = losses
    r["step_ms"] = cuda_ms(lambda: step(square), iters=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    step(square)
    torch.cuda.synchronize()
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["resident_before_step_gib"] = base_gib
    rows = kernel_breakdown(lambda: step(square), iters=1)
    busy = sum(ms for _, ms, _ in rows)
    r.update(busy_ms=busy, idle_share=1 - busy / r["step_ms"],
             top=[(k[:60], ms, c) for k, ms, c in rows[:8]])
    log(f"  step {r['step_ms']:.2f} ms (CUDA events, median of 5), peak "
        f"{r['peak_gib']:.2f} GiB ({base_gib:.2f} GiB allocated before the "
        f"step: the factory's MMDiT, T5, CLIP and VAE, the teacher and its "
        f"AdamW state), device busy {busy:.2f} ms, idle "
        f"{100 * r['idle_share']:.1f}%")
    for key, ms, count in rows[:8]:
        log(f"    {ms:8.3f} ms x{count:3d}  {key[:100]}")

    # the planted faults at the same shape
    q, k, v = (torch.randn(16, 4096, 64, device=dev, dtype=torch.bfloat16)
               * s_ for s_ in (0.125, 1.0, 1.0))
    got = fa.flash_attention(q, k, v, 4037)
    ref = fa.flash_attention_plain(q, k, v, 4037)
    compare("K3_flash_attention", got, ref, results, lse=1,
            norm_tol=FLASH_NORM_TOL)
    planted_o("K3_flash_attention", got, ref)
    g = torch.randn_like(q)
    g[:, 4037:] = 0
    grads = fa.flash_attention_bwd(q, k, v, *got, g, 4037)
    grads_ref = fa.flash_attention_bwd_plain(q, k, v, *got, g, 4037)
    compare("K8_flash_attention_bwd", grads, grads_ref, results,
            norm_tol=FLASH_NORM_TOL)
    try:
        compare("K8 (planted dk x 1.01)", [grads[0], grads[1] * 1.01, grads[2]],
                grads_ref, {}, norm_tol=FLASH_NORM_TOL)
        caught = False
    except RuntimeError as err:
        log(f"  planted dk x 1.01 caught: {err}")
        caught = True
    check(caught, "K8 at the teacher's shape: the planted dk x 1.01 went "
          "unnoticed")
    del model, opt, square, land
    subprocess.run(["rm", "-rf", str(TEACHER_ROOT)], check=True)
    torch.cuda.empty_cache()


def int8_phase(results, pipe):
    """Int8 weight residency on the full-depth FLUX.1-dev MMDiT: (a)
    `init_mmdit(int8_weights=True)`: resident GiB, one plain and one
    concept step at 1024^2 (K7 57 and 76), ms and peak beside the bf16
    model's; (b) `quantize_mmdit` of the factory's bf16 model: its
    concept step's velocity against the bf16 step's (INT8_VELOCITY_TOL)."""
    import types

    import torch

    from s3od_torch.models.mmdit import QuantLinear, init_mmdit, quantize_mmdit

    r = results["_int8"] = {}
    log("phase int8: the FLUX.1-dev MMDiT with int8-resident linears, 1024^2")
    cfg = pipe.cfg
    per_step = cfg.num_dual_blocks + cfg.num_single_blocks
    inp = step_inputs(pipe, 1024, 1024)
    bf16 = factory_step_run(pipe, inp)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    m8 = init_mmdit(cfg, torch.Generator(device="cuda").manual_seed(21),
                    dtype=torch.bfloat16, int8_weights=True)
    torch.cuda.synchronize()
    resident = (torch.cuda.memory_allocated() - before) / 2**30
    n_q = sum(isinstance(m, QuantLinear) for m in m8.modules())
    resident_bf16 = sum(t.numel() * t.element_size() for t in
                        pipe.model.parameters()) / 2**30
    int8 = factory_step_run(types.SimpleNamespace(model=m8), inp)
    log(f"  init_mmdit(int8_weights=True): {n_q} int8 linears, resident "
        f"{resident:.2f} GiB (bf16 model {resident_bf16:.2f} GiB); steps: "
        f"plain {int8['plain']['ms']:.2f} ms (bf16 {bf16['plain']['ms']:.2f}), "
        f"concept {int8['concept']['ms']:.2f} ms (bf16 "
        f"{bf16['concept']['ms']:.2f}); K7 {int8['plain']['launches']} / "
        f"{int8['concept']['launches']}; peak {int8['peak_gib']:.2f} GiB "
        f"(bf16 run {bf16['peak_gib']:.2f}, both with the factory's models "
        f"resident)")
    check(int8["plain"]["launches"] == per_step
          and int8["concept"]["launches"] == per_step + cfg.num_dual_blocks,
          f"int8 step: K7 launches {int8['plain']['launches']} / "
          f"{int8['concept']['launches']}")
    check(torch.isfinite(int8["concept"]["velocity"]).all(), "int8: finite")
    r.update(int8_linears=n_q, resident_gib=resident,
             resident_bf16_gib=resident_bf16,
             step_ms={k: int8[k]["ms"] for k in ("plain", "concept")},
             step_ms_bf16={k: bf16[k]["ms"] for k in ("plain", "concept")},
             peak_gib=int8["peak_gib"], peak_gib_bf16=bf16["peak_gib"],
             k7=(int8["plain"]["launches"], int8["concept"]["launches"]))
    del m8, int8
    torch.cuda.empty_cache()
    mq = quantize_mmdit(pipe.model)
    quant = factory_step_run(types.SimpleNamespace(model=mq), inp)
    err = rel_norm(quant["concept"]["velocity"], bf16["concept"]["velocity"])
    err_p = rel_norm(quant["plain"]["velocity"], bf16["plain"]["velocity"])
    log(f"  quantize_mmdit(factory model): velocity rel. norm vs bf16: "
        f"concept {err:.3e}, plain {err_p:.3e} (<= {INT8_VELOCITY_TOL}); "
        f"steps {quant['plain']['ms']:.2f} / {quant['concept']['ms']:.2f} ms")
    r.update(velocity_rel_norm={"plain": err_p, "concept": err},
             quantized_step_ms={k: quant[k]["ms"] for k in ("plain", "concept")})
    check(max(err, err_p) <= INT8_VELOCITY_TOL, "int8 velocity vs bf16")
    del mq, quant, bf16
    torch.cuda.empty_cache()


CONVERT_ROOT = REPO / "build" / "chip_smoke_convert"


def module_tree(module):
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
                       if isinstance(n, dict) and n and all(
                           k.isdigit() for k in n)
                       else {k: lists(v) for k, v in n.items()}
                       if isinstance(n, dict) else n)
    return lists(tree)


def diffusers_transformer_sd(tree):
    """An MMDiT tree (`module_tree`, torch leaves) -> the diffusers
    `FluxTransformer2DModel` state dict on the host:
    `convert_flux_transformer` read backwards (q, k, v split out of the
    fused qkv, `norm_out` back to [scale, shift])."""
    import torch

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
    for src, dst in (("time_in", "timestep_embedder"),
                     ("guidance_in", "guidance_embedder"),
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
        norms(f"{a}.attn", b["txt_attn"]["qk_norm"], "norm_added_q",
              "norm_added_k")
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


def diffusers_vae_sd(enc, dec, dtype):
    """The VAE's (enc, dec) trees -> the diffusers `AutoencoderKL` state
    dict in `dtype`: `convert_diffusers_vae` read backwards."""
    import numpy as np
    import torch

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
            for sample, sub in (("downsample", "downsamplers"),
                                ("upsample", "upsamplers")):
                if sample in stage:
                    conv(f"{side}.{blocks}.{i}.{sub}.0.conv", stage[sample])
        gn(f"{side}.conv_norm_out", tree["norm_out"])
        conv(f"{side}.conv_out", tree["conv_out"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
            for k, v in sd.items()}


def hf_text_dirs(root: Path, t5, clip):
    """Seeded T5 and CLIP text encoders written as `save_pretrained`
    directories (config.json + model.safetensors in the encoders' dtype):
    the transformers key layout `convert_t5_encoder` / `convert_clip_text`
    read."""
    import json as json_

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
              "vocab_size": c.vocab_size, "d_model": c.d_model,
              "d_kv": c.d_kv, "d_ff": c.d_ff, "num_layers": c.num_layers,
              "num_heads": c.num_heads,
              "relative_attention_num_buckets":
                  c.relative_attention_num_buckets,
              "relative_attention_max_distance":
                  c.relative_attention_max_distance,
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
    clip_cfg = {"model_type": "clip_text_model",
                "architectures": ["CLIPTextModel"],
                "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
                "intermediate_size": c.intermediate_size,
                "num_hidden_layers": c.num_layers,
                "num_attention_heads": c.num_heads,
                "max_position_embeddings": c.max_position_embeddings,
                "layer_norm_eps": c.layer_norm_eps, "hidden_act": "quick_gelu",
                "eos_token_id": c.vocab_size - 1,
                "bos_token_id": c.vocab_size - 2, "attention_dropout": 0.0}
    import numpy as np
    import torch

    for name, sd_, cfg_, mod in (("t5", sd, t5_cfg, t5),
                                 ("clip", csd, clip_cfg, clip)):
        d = root / name
        d.mkdir(parents=True)
        (d / "config.json").write_text(json_.dumps(cfg_))
        dt = next(mod.parameters()).dtype
        save_file({k: torch.from_numpy(np.ascontiguousarray(v)).to(dt)
                   for k, v in sd_.items()}, str(d / "model.safetensors"))
    return root / "t5", root / "clip"


def converters_phase(results, pipe):
    """The converters on seeded weights in the source layouts, each output
    loaded back and run on the card against its source, bit for bit:
    (a) the MMDiT at full width cut to 2 dual + 4 single blocks (the full
    depth is 47.6 GB in fp32 on the host) and the FLUX VAE at full size,
    written as diffusers `.safetensors` (bf16), through
    `python -m s3od_torch.datagen.convert_flux`; (b) T5-XXL and CLIP-L at
    full width and 2 layers as `save_pretrained` directories through
    `python -m s3od_torch.datagen.convert_text_encoders --verify` (against
    transformers, when the host has it). The two CLIs run side by side."""
    import dataclasses
    import os

    import torch
    from safetensors.torch import save_file

    from s3od_torch.convert import (load_clip_text, load_mmdit, load_t5,
                                    load_vae_modules, state_dict_to_tree)
    from s3od_torch.models.mmdit import MMDiT
    from s3od_torch.models.text_encoders import (CLIPTextConfig, T5Config,
                                                 init_clip_text, init_t5)

    r = results["_converters"] = {}
    log("phase converters: diffusers FLUX (2 + 4 blocks, full width) + VAE, "
        "T5-XXL and CLIP-L (2 layers, full width) -> .npz -> the card")
    subprocess.run(["rm", "-rf", str(CONVERT_ROOT)], check=True)
    CONVERT_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    cut = dataclasses.replace(pipe.cfg, num_dual_blocks=2, num_single_blocks=4,
                              feature_taps=(0, 1, 2, 3))
    m16 = MMDiT(cut, device="meta", dtype=torch.bfloat16).to_empty(device="cuda")
    src = pipe.model.state_dict()
    with torch.no_grad():
        for name, p in m16.state_dict().items():
            p.copy_(src[name])
    save_file(diffusers_transformer_sd(module_tree(m16)),
              str(CONVERT_ROOT / "transformer.safetensors"))
    vae = pipe.vae
    vdt = next(vae.dec.parameters()).dtype
    save_file(diffusers_vae_sd(state_dict_to_tree(vae.enc.state_dict()),
                               state_dict_to_tree(vae.dec.state_dict()), vdt),
              str(CONVERT_ROOT / "vae.safetensors"))
    r["write_flux_s"] = time.perf_counter() - t0
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    # bf16 weights (as the checkpoints ship), run in float32
    t5 = init_t5(dataclasses.replace(T5Config(), num_layers=2), gen(31),
                 dtype=torch.bfloat16)
    clip = init_clip_text(dataclasses.replace(CLIPTextConfig(), num_layers=2),
                          gen(32), dtype=torch.bfloat16)
    t5_dir, clip_dir = hf_text_dirs(CONVERT_ROOT / "hf", t5, clip)
    r["write_s"] = time.perf_counter() - t0
    out = CONVERT_ROOT / "npz"
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in (
        [sys.executable, "-m", "s3od_torch.datagen.convert_flux",
         "--transformer", str(CONVERT_ROOT / "transformer.safetensors"),
         "--vae", str(CONVERT_ROOT / "vae.safetensors"),
         "--out_transformer", str(out / "flux_mmdit.npz"),
         "--out_vae", str(out / "flux_vae.npz")],
        [sys.executable, "-m", "s3od_torch.datagen.convert_text_encoders",
         "--t5", str(t5_dir), "--clip", str(clip_dir), "--out-dir", str(out),
         "--verify"])]
    out.mkdir()
    texts = []
    for p in procs:
        text, _ = p.communicate(timeout=300)
        texts.append(text)
        log("  " + text.strip().replace("\n", "\n  ")[-1500:])
        check(p.returncode == 0, f"converter CLI exit {p.returncode}")
    r["convert_s"] = time.perf_counter() - t0
    r["bytes"] = {str(f.relative_to(CONVERT_ROOT)): f.stat().st_size
                  for f in sorted(CONVERT_ROOT.rglob("*")) if f.is_file()}
    r["verify"] = [line for t in texts for line in t.splitlines()
                   if "verify" in line]

    t0 = time.perf_counter()
    inp = dict(step_inputs(pipe, 1024, 1024), concept_layers=None)
    conv = load_mmdit(str(out / "flux_mmdit.npz"), cut, device="cuda",
                      dtype=torch.bfloat16)
    r["load_mmdit_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        a, b = m16(**inp), conv(**inp)
    same_mmdit = (torch.equal(a["output"], b["output"])
                  and all(torch.equal(x, y) for x, y in zip(a["features"],
                                                             b["features"]))
                  and torch.equal(a["concept_maps"], b["concept_maps"]))
    del m16, conv, a, b
    enc, dec, _ = load_vae_modules(str(out / "flux_vae.npz"))
    enc, dec = (m.to("cuda", vdt) for m in (enc, dec))
    g = gen(33)  # the inputs in the VAE's compute dtype, as `VAE` runs it
    lat = torch.randn(1, 64, 64, 16, generator=g, device="cuda").to(vae.dtype)
    img = (torch.rand(1, 512, 512, 3, generator=g, device="cuda") * 2
           - 1).to(vae.dtype)
    with torch.inference_mode():
        same_vae = (torch.equal(dec(lat), vae.dec(lat))
                    and torch.equal(enc(img), vae.enc(img)))
    del enc, dec
    ids = torch.randint(0, 32000, (1, 64), generator=g, device="cuda")
    cids = torch.randint(0, 49407, (1, 77), generator=g, device="cuda")
    cids[0, 20] = 49407
    # in bf16, as `TorchTextEncoders` casts and runs them
    bf = torch.bfloat16
    t5c, clipc = (load_t5(str(out / "t5_encoder.npz")).to("cuda", bf),
                  load_clip_text(str(out / "clip_text.npz")).to("cuda", bf))
    with torch.inference_mode():
        same_t5 = torch.equal(t5c(ids, compute_dtype=bf),
                              t5(ids, compute_dtype=bf))
        same_clip = all(torch.equal(x, y) for x, y in zip(
            clipc(cids, compute_dtype=bf), clip(cids, compute_dtype=bf)))
    r["check_s"] = time.perf_counter() - t0
    r["bit_equal"] = {"mmdit_2_4": same_mmdit, "vae": same_vae,
                      "t5_2_layers": same_t5, "clip_2_layers": same_clip}
    log(f"  written in {r['write_s']:.1f} s (the MMDiT and VAE "
        f"{r['write_flux_s']:.1f}), converted in {r['convert_s']:.1f} s (two "
        f"CLIs side by side), checked in {r['check_s']:.1f} s (load_mmdit "
        f"{r['load_mmdit_s']:.1f}); bytes {r['bytes']}")
    log(f"  converted vs source, bit-equal: {r['bit_equal']}")
    check(all(r["bit_equal"].values()), f"converters: {r['bit_equal']}")
    del t5, clip, t5c, clipc
    subprocess.run(["rm", "-rf", str(CONVERT_ROOT)], check=True)
    torch.cuda.empty_cache()


FILTER_ROOT = REPO / "build" / "chip_smoke_filter"
FILTER_SAMPLES = 16  # a class


def write_filter_set(root: Path):
    """Two classes of FILTER_SAMPLES image/mask pairs from the fixture pair
    (flips and cyclic shifts; every fourth mask inverted, every fifth
    fragmented into squares): what `generate_train_images` writes,
    organised by class."""
    import numpy as np
    from PIL import Image

    image = np.array(Image.open(IMAGE).convert("RGB"))
    mask = np.array(Image.open(MASK).convert("L"))
    h, w = mask.shape
    frag = np.zeros_like(mask)
    for y in range(8, h - 8, 40):
        for x in range(8, w - 8, 40):
            frag[y: y + 12, x: x + 12] = 255
    for c, cls in enumerate(("tabby_cat", "golden_retriever")):
        (root / cls / "images").mkdir(parents=True)
        (root / cls / "masks").mkdir(parents=True)
        for i in range(FILTER_SAMPLES):
            im, m = image, mask
            if (i + c) % 2:
                im, m = im[:, ::-1], m[:, ::-1]
            shift = ((i * 7) % 16, (i * 11) % 16)  # small: the tiny
            # checkpoint still finds the object
            im, m = np.roll(im, shift, (0, 1)), np.roll(m, shift, (0, 1))
            if i % 4 == 3:
                m = 255 - m
            if i % 5 == 4:
                m = frag
            Image.fromarray(np.ascontiguousarray(im)).save(
                root / cls / "images" / f"{i:04d}.jpg", quality=95)
            Image.fromarray(np.ascontiguousarray(m)).save(
                root / cls / "masks" / f"{i:04d}.png")


def filtering_phase(results):
    """`run_filtering` over a class-organised set from fixture variants:
    (a) the chain flip_consistency -> semantic_quality -> mask_artifacts on
    the seeded ViT-B at 840^2, batch 8 (a forward of 16 images): the K1-K5
    launches per chunk, and the filter's samples/s warm beside its device
    forward; (b) the same chain on the tiny
    fixture checkpoint (128 canvas, bf16 kernels, D = 32) against a CPU
    run in float32: the same verdicts, sample by sample."""
    import numpy as np
    import torch
    import yaml

    from s3od_torch.convert import convert_state_dict, save_native
    from s3od_torch.datagen import filtering, run_filtering
    from s3od_torch.datagen.filters import HorizontalFlipConsistencyFilter

    r = results["_filtering"] = {}
    log("phase filtering: run_filtering flip_consistency -> semantic_quality "
        "-> mask_artifacts (the VLM filters on their heuristics)")
    subprocess.run(["rm", "-rf", str(FILTER_ROOT)], check=True)
    write_filter_set(FILTER_ROOT / "set")
    vit_b = FILTER_ROOT / "vit_b.npz"
    params, state, _ = convert_state_dict(
        {k: v.cpu() for k, v in vit_b_model(4).state_dict().items()})
    save_native(str(vit_b), params, state)
    n = 2 * FILTER_SAMPLES

    def run(tag, model, size, device, batch=8):
        cfg = {"input_dir": str(FILTER_ROOT / "set"),
               "output_dir": str(FILTER_ROOT / tag / "out"),
               "failed_dir": str(FILTER_ROOT / tag / "failed"),
               "filters": [{"type": "flip_consistency", "model_path": str(model),
                            "image_size": size, "batch_size": batch,
                            "device": device},
                           {"type": "semantic_quality",
                            "model_id": str(FILTER_ROOT / "no_vlm"),
                            "device": device},
                           {"type": "mask_artifacts",
                            "model_id": str(FILTER_ROOT / "no_vlm"),
                            "device": device}]}
        path = FILTER_ROOT / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        seen = []
        real = filtering.BaseFilter.record

        def record(self, res, _seen=seen):
            _seen.extend((self.name, x.passed, x.reason) for x in res)
            return real(self, res)

        filtering.BaseFilter.record = record
        try:
            t0 = time.perf_counter()
            stats = run_filtering.main(["--config", str(path)])
            wall = time.perf_counter() - t0
        finally:
            filtering.BaseFilter.record = real
        return stats, seen, wall

    # (a) the seeded ViT-B at 840^2 through the CLI (its predictor loads
    # inside the run), then the filter alone, loaded and warm: host clock
    # per chunk beside the device forward of its 16 canvases
    reset_counts()
    stats, _, wall = run("vit_b", vit_b, 840, "cuda")
    counts = launch_counts()
    chunks = -(-n // 8)
    for name, cnt in counts.items():
        check(cnt == 11 * chunks, f"filter: {name} launched {cnt}, want "
              f"{11 * chunks} (11 a forward)")
    samples = filtering.DatasetLoader(str(FILTER_ROOT / "set")).load_samples()
    flt = HorizontalFlipConsistencyFilter(str(vit_b), image_size=840)
    flt.filter_batch(samples[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, n, 8):
        flt.filter_batch(samples[i: i + 8])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    pred = flt.predictor
    canv = np.stack([pred._letterbox(s.load_image())[0] for s in samples[:16]])
    fwd_ms = cuda_ms(lambda: pred.predictor.forward_canvases(canv), iters=5)
    log(f"  ViT-B 840^2, batch 8: run_filtering {n} samples in {wall:.2f} s "
        f"(the predictor's load included), {chunks} forwards of 16 images, "
        f"launches {counts}; stats {stats}; the filter warm: "
        f"{n / warm:.2f} samples/s ({1e3 * warm / chunks:.1f} ms a chunk), "
        f"of which the 16-image forward and read-back {fwd_ms:.2f} ms")
    r.update(samples=n, cli_s=wall, samples_per_s_warm=n / warm,
             chunk_ms=1e3 * warm / chunks, forward_16_ms=fwd_ms,
             launches_per_chunk={k: v / chunks for k, v in counts.items()},
             vit_b_stats=stats)
    del flt, pred

    # (b) the tiny checkpoint, card against CPU
    tiny = REPO / "tests" / "fixture" / "tiny_s3od.npz"
    s_card, v_card, _ = run("tiny_card", tiny, 128, "cuda")
    s_cpu, v_cpu, _ = run("tiny_cpu", tiny, 128, "cpu")
    same = v_card == v_cpu and s_card == s_cpu
    log(f"  tiny checkpoint, 128 canvas: card (bf16) {s_card}; CPU (float32) "
        f"verdicts equal: {same}")
    r.update(tiny_card=s_card, tiny_cpu=s_cpu, verdicts_equal=same)
    check(same, "filter verdicts: card against CPU")
    check(s_card["kept"] > 0 and s_card["rejected"], "the chain kept some "
          "samples and rejected some")
    subprocess.run(["rm", "-rf", str(FILTER_ROOT)], check=True)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import torch

    global TURNS
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=Path, default=None,
                    help="directory holding the parent commit's attn_epilogue.cu, "
                         "flash_attention_bwd.cu, mask_tail.cu, hopper.cuh, mma.cuh "
                         "and exp_layernorm.py, to time against")
    opts = ap.parse_args(argv)
    TURNS = opts.turns

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from s3od_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"kernel library built/loaded in {time.perf_counter() - t0:.1f} s "
        f"(hash {_build.source_hash()})")

    results: dict = {}
    seconds: dict = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t0
        log(f"  [{fn.__name__}: {seconds[fn.__name__]:.1f} s]")
        return out

    timed(kernel_phases, results)
    pred, pred32 = timed(slice_phase, results)
    timed(quality_phase, results)
    timed(highres_phase, results)
    timed(serving_phase, results, pred)
    timed(decoder_phase, results, pred, pred32)
    del pred, pred32
    torch.cuda.empty_cache()
    timed(aot_phase, results)
    timed(tools_phase, results)
    timed(filtering_phase, results)
    torch.cuda.empty_cache()
    timed(train_entry_phase, results)
    timed(train_step_phase, results)
    timed(grad_agreement_phase, results)
    timed(highres_train_phase, results)
    timed(augment_phase, results)
    timed(remat_phase, results)
    timed(train_options_phase, results)
    timed(demo_phase, results)
    torch.cuda.empty_cache()
    timed(parallel_phase, results)
    timed(k7_phase, results)
    timed(experiments_phase, results)
    torch.cuda.empty_cache()
    pipe = timed(factory_phase, results)
    timed(teacher_phase, results, pipe)
    timed(int8_phase, results, pipe)
    timed(converters_phase, results, pipe)
    timed(lora_phase, results, pipe)
    timed(parallel_factory_phase, results, pipe)
    del pipe
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "s3od_tpu"))
    log(f"modules of jax or s3od_tpu loaded: {loaded}")
    check(not loaded, "the port's paths must load neither jax nor s3od_tpu")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(json.dumps({"slice": results["_slice"], "quality": results["_quality"],
                    "highres": results["_highres"],
                    "serving": results["_serving"],
                    "decoder": results["_decoder"],
                    "aot": results["_aot"],
                    "tools": results["_tools"],
                    "phase_s": seconds,
                    "train": results["_train"],
                    "augment": results["_augment"],
                    "demo": results["_demo"],
                    "factory": results["_factory"],
                    "teacher": results["_teacher"],
                    "int8": results["_int8"],
                    "converters": results["_converters"],
                    "filtering": results["_filtering"],
                    "lora": results["_lora"],
                    "parallel": results["_parallel"],
                    "experiments": results["_experiments"],
                    "kernel_extra": {k: {x: y for x, y in v.items()
                                         if x not in ("launches",)}
                                     for k, v in results.items()
                                     if not k.startswith("_")}}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
