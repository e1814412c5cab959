#!/usr/bin/env python3
"""Smoke run of the s3od_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from `s3od_torch/csrc` (and the Triton kernel),
then:
  1. checks each kernel (K1-K4) against its plain PyTorch version in bf16
     at the main path's shapes (DINOv3-ViT-B/16 at 1024^2: 4101 tokens
     padded to 4160, C = 768, 12 heads of 64; batch 1 and batch 16),
     including the flash kernel's +-40 edge and adversarial
     +-1000-scale inputs, and times both at batch 1 (device time from a
     profiler trace of 20 calls; CUDA events around single calls, median
     of 25, which include the host launch);
  2. drives the main path — `BackgroundRemoval.remove_background` and
     `remove_background_batch` (16 images) — at full ViT-B width with
     seeded random weights in bf16, checks that every kernel launched 11
     times per forward and that each batch result matches the single-image
     call on the same image (results and encoder taps), reports img/s at batch 1 and 16 and the device
     time of the forward by kernel, and compares against the port's
     float32 exact mode on the card: encoder taps per image at batch 4,
     and the masks and IoU scores;
  3. checks quality: the committed tiny checkpoint trained at 1024^2
     reaches IoU >= 0.9 on the fixture through the kernels (D = 32).

Any failed check raises, so the run exits non-zero, as does a run that
loaded jax. Without a CUDA device, or outside the repository, it exits
non-zero before printing a result. The last two lines are the kernel
summary and the device result as JSON.
"""

from __future__ import annotations

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
}
REL_TOL = 1e-2   # max|kernel - plain| / max|plain| per output, bf16
LSE_TOL = 1e-3   # max|kernel - plain| of the fp32 lse
TAP_TOL = 1.5e-2  # ||bf16 kernel-route tap - fp32 exact tap|| / ||fp32 tap||
BATCH_TOL = 1e-2  # batch vs single image: max|d| of masks and IoU scores,
                  # ||d|| / ||single|| of the encoder taps
B16 = 16          # remove_background_batch's chunk: the batch-16 shapes


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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the summed time of every kernel the call
    launches (profiler trace of `iters` calls). Unlike CUDA events around
    a call, it leaves out the host's launch overhead, which can exceed a
    small kernel's run time."""
    total = sum(ms for _, ms, _ in kernel_breakdown(fn, iters))
    check(total > 0, "profiler recorded no device time")
    return total


def kernel_breakdown(fn, iters: int):
    """[(kernel name, device ms per call, launches per call)], largest
    first, from a torch.profiler trace of `iters` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3 / iters,
             round(e.count / iters))
            for e in prof.key_averages()
            if not e.key.startswith("Activity Buffer")]  # profiler bookkeeping
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def time_pair(name, kernel_fn, plain_fn, results):
    """Kernel and plain version: device time (reported) and host-inclusive
    CUDA-event time (logged), measured in turns on the same inputs."""
    r = results[name]
    r["ms"] = device_ms(kernel_fn)
    r["plain_ms"] = device_ms(plain_fn)
    r["event_ms"] = cuda_ms(kernel_fn)
    r["plain_event_ms"] = cuda_ms(plain_fn)


def compare(name, got, ref, results, lse=None):
    """Relative max error per output; lse (index into the tuples) is
    checked in absolute terms. Returns the largest absolute error."""
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
            log(f"  {name} out{i}: max|d| {err:.3e} rel {rel:.3e}")
            check(rel <= REL_TOL, f"{name} out{i} rel {rel} > {REL_TOL}")
    results.setdefault(name, {"max_abs_err": 0.0})
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], worst)
    return worst


def kernel_phases(results):
    import torch

    from s3od_torch import _build
    from s3od_torch.models.dinov3 import _full_tables
    from s3od_torch.ops import attn_epilogue as ae
    from s3od_torch.ops import flash_attention as fa
    from s3od_torch.ops import layernorm as ln
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
            ln.layer_norm_plain(x, w, b, 1e-5), results)
    check((_build.build_dir() / "triton").is_dir(),
          "Triton's cache must land in the build directory")
    x16 = randn(B16 * n, c, scale=2.0, shift=0.5)
    log(f"  at the batch-16 shape ({B16 * n} x {c})")
    compare("K1_layer_norm", ln.layer_norm(x16, w, b, 1e-5),
            ln.layer_norm_plain(x16, w, b, 1e-5), results)
    time_pair("K1_layer_norm", lambda: ln.layer_norm(x, w, b, 1e-5),
              lambda: ln.layer_norm_plain(x, w, b, 1e-5), results)

    # K2
    log("phase K2 qkv_project_rope (1 x 4160 x 768 -> 3 x (1, 12, 4160, 64))")
    x = randn(1, n, c)
    wq, bq = randn(3 * c, c, scale=0.02), randn(3 * c, scale=0.1)
    bq[c: 2 * c] = 0  # no key bias
    cos, sin = _full_tables(64, 64, d, 100.0, 5, n, dev)
    args = (x, wq, bq, cos, sin, h, d**-0.5)
    compare("K2_qkv_project_rope", qp.qkv_project_rope(*args),
            qp.qkv_project_rope_plain(*args), results)
    args16 = (randn(B16, n, c),) + args[1:]
    log(f"  at the batch-16 shape ({B16} x {n} x {c})")
    compare("K2_qkv_project_rope", qp.qkv_project_rope(*args16),
            qp.qkv_project_rope_plain(*args16), results)
    time_pair("K2_qkv_project_rope", lambda: qp.qkv_project_rope(*args),
              lambda: qp.qkv_project_rope_plain(*args), results)

    # K3
    log("phase K3 flash_attention (12 x 4160 x 64, n_valid 4101)")
    q = randn(h, n, d, scale=0.5 * d**-0.5)
    k, v = randn(h, n, d, scale=0.5), randn(h, n, d)
    compare("K3_flash_attention", fa.flash_attention(q, k, v, n_valid),
            fa.flash_attention_plain(q, k, v, n_valid), results, lse=1)
    # row maxima pushed near the +40 edge of the window
    smax = float((q.float() @ k.float().transpose(1, 2))[:, :, :n_valid].max())
    q_edge = (q.float() * (35.0 / smax)).to(bf)
    log(f"  edge case: max logit {smax:.2f} -> ~35")
    compare("K3_flash_attention", fa.flash_attention(q_edge, k, v, n_valid),
            fa.flash_attention_plain(q_edge, k, v, n_valid), results, lse=1)
    # adversarial magnitudes (logits ~ +-8000): finite everywhere
    q_hot = randn(h, n, d, scale=1000.0)
    o_hot, lse_hot = fa.flash_attention(q_hot, k, v, n_valid)
    check(bool(o_hot.isfinite().all() and lse_hot.isfinite().all()),
          "K3 adversarial (hot) output not finite")
    k_pos = (k.float().abs() + 1.0).to(bf)
    o_cold, lse_cold = fa.flash_attention((-q_hot.float().abs()).to(bf), k_pos,
                                          v, n_valid)
    check(bool(o_cold.isfinite().all() and lse_cold.isfinite().all()),
          "K3 adversarial (cold) output not finite")
    log("  adversarial +-1000-scale inputs: finite")
    q16, k16, v16 = (randn(B16 * h, n, d, scale=s)
                     for s in (0.5 * d**-0.5, 0.5, 1.0))
    log(f"  at the batch-16 shape ({B16 * h} x {n} x {d})")
    plain16 = [fa.flash_attention_plain(q16[i: i + h], k16[i: i + h],
                                        v16[i: i + h], n_valid)
               for i in range(0, B16 * h, h)]  # per image: bounded memory
    compare("K3_flash_attention", fa.flash_attention(q16, k16, v16, n_valid),
            [torch.cat(t) for t in zip(*plain16)], results, lse=1)
    del q16, k16, v16, plain16
    time_pair("K3_flash_attention", lambda: fa.flash_attention(q, k, v, n_valid),
              lambda: fa.flash_attention_plain(q, k, v, n_valid), results)

    # K4
    log("phase K4 attn_epilogue (12 x 4160 x 64 -> 2 x (1, 4160, 768))")
    a = randn(h, n, d, scale=0.5)
    wo, bo = randn(c, c, scale=0.02), randn(c, scale=0.1)
    x = randn(1, n, c)
    ls, lw, lb = randn(c, scale=0.5, shift=1.0), randn(c, scale=0.5, shift=1.0), \
        randn(c, scale=0.2)
    args = (a, wo, bo, x, ls, lw, lb, 1e-5)
    compare("K4_attn_epilogue", ae.attn_epilogue(*args),
            ae.attn_epilogue_plain(*args), results)
    args16 = (randn(B16 * h, n, d, scale=0.5), wo, bo, randn(B16, n, c)) + args[4:]
    log(f"  at the batch-16 shape ({B16 * h} x {n} x {d} -> {B16} x {n} x {c})")
    compare("K4_attn_epilogue", ae.attn_epilogue(*args16),
            ae.attn_epilogue_plain(*args16), results)
    time_pair("K4_attn_epilogue", lambda: ae.attn_epilogue(*args),
              lambda: ae.attn_epilogue_plain(*args), results)
    for name, r in results.items():
        log(f"  {name}: device time kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms; with host launch (CUDA events) kernel "
            f"{r['event_ms']:.4f} ms, plain {r['plain_event_ms']:.4f} ms")


def launch_counts():
    from s3od_torch.ops import attn_epilogue, flash_attention, layernorm, qkv_project

    return {
        "K1_layer_norm": layernorm.layer_norm.launches,
        "K2_qkv_project_rope": qkv_project.qkv_project_rope.launches,
        "K3_flash_attention": flash_attention.flash_attention.launches,
        "K4_attn_epilogue": attn_epilogue.attn_epilogue.launches,
    }


def reset_counts():
    from s3od_torch.ops import attn_epilogue, flash_attention, layernorm, qkv_project

    for fn in (layernorm.layer_norm, qkv_project.qkv_project_rope,
               flash_attention.flash_attention, attn_epilogue.attn_epilogue):
        fn.launches = 0


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
    # device time of the forward alone (normalize -> sigmoid, on canvases)
    canvas = pred._preprocess(image)[0]
    c16 = np.stack([pred._preprocess(im)[0] for im in imgs])
    x1 = torch.from_numpy(canvas[None]).cuda()
    x16 = torch.from_numpy(c16).cuda()

    def fwd(x):
        with torch.inference_mode():
            xx = ((x.float() - pred._mean) * pred._inv_std).to(pred.compute_dtype)
            out = pred.model(xx)
            torch.sigmoid(out["pred_masks"])

    f1 = cuda_ms(lambda: fwd(x1), iters=20)
    f16 = cuda_ms(lambda: fwd(x16), iters=5)
    torch.cuda.reset_peak_memory_stats()
    fwd(x16)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  throughput end to end: batch 1 {b1:.3f} img/s, batch 16 {b16:.3f} img/s")
    log(f"  device forward: batch 1 {f1:.3f} ms, batch 16 {f16:.3f} ms "
        f"({f16 / 16:.3f} ms/img); peak memory at batch 16 {peak:.2f} GiB")
    results["_slice"] = {"img_s_b1": b1, "img_s_b16": b16, "fwd_ms_b1": f1,
                         "fwd_ms_b16": f16}
    for tag, x, span in (("b1", x1, f1), ("b16", x16, f16)):
        rows = kernel_breakdown(lambda: fwd(x), iters=3)
        busy = sum(ms for _, ms, _ in rows)
        log(f"  forward {tag} by kernel (device ms per forward; busy {busy:.3f} "
            f"of {span:.3f} ms between events):")
        for key, ms, count in rows[:12]:
            log(f"    {ms:8.3f} ms x{count:3d}  {key[:100]}")
        results["_slice"][f"busy_ms_{tag}"] = busy

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


def main() -> int:
    import torch

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
    kernel_phases(results)
    slice_phase(results)
    quality_phase(results)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "s3od_tpu")
    log(f"jax loaded: {'jax' in sys.modules}; modules of s3od_tpu loaded "
        f"through s3od_torch: {loaded}")
    check("jax" not in sys.modules, "the port's path must not load jax")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    log(json.dumps({"slice": results["_slice"], "quality": results["_quality"]}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
