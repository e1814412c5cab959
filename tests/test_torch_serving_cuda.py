"""On the card: the serving paths end to end on seeded DINOv3-ViT-B/16 +
DPT weights in bf16 and on the committed tiny checkpoints. The 1024^2
path (K1-K5 once a block a forward, batch 1 and 16) against itself
image by image and against the port's float32 exact mode; the tiny
checkpoint's IoU on the fixture; the 2048^2 stream; InferenceServer; the
decoder's gated kernels (K9a, K9b, K10) on the 1024^2 and 2048^2 paths,
every call held to its plain version; the serving bundles; the tools
(`test_efficiency`, `mine_samples`, `export_model`, the demo server) and
the filter chain. The file imports no JAX: run it on the card with

    python3 chip_smoke.py -k serving
"""

import contextlib
import copy
import io
import json
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from _cuda import (B16, DEC_CALL_TOL, REPO, TINY, TINY_1024, cuda,  # noqa: F401
                   decoder_counts, decoder_gates, decoder_rule_counts,
                   fixture_pair, fixture_variants, iou, launch_counts,
                   rel_norm, reset_counts, seeded_model)

pytestmark = pytest.mark.cuda

TAP_TOL = 1.5e-2  # ||bf16 kernel-route tap - fp32 exact tap|| / ||fp32 tap||
BEST_TOL = 1 / 510 + 2.0**-9 + 1e-6  # payload "best" vs "full": the uint8
# step plus one bf16 rounding of a sigmoid in [0.5, 1)
BATCH_TOL = 1e-2  # batch vs single image: max|d| of masks and IoU scores,
# ||d|| / ||single|| of the encoder taps
AOT_STEP = 1 / 255 + 1e-6  # payload "best": one uint8 step of the mask
# bf16 against fp32 mining score, an S-measure product in [0, 1]: an
# agreement bound between the two precisions (a score x 1.01 moves at
# most 1e-2 and would pass; the scores' own faults show in the CPU tests)
MINE_TOL = 2e-2


@pytest.fixture(scope="module")
def predictors(cuda):
    """The 1024^2 ViT-B predictor in bf16 (the kernel route) and the same
    weights in float32 exact mode."""
    from s3od_torch import BackgroundRemoval

    model = seeded_model(0, device="cpu")
    pred32 = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=1024,
                                          device="cuda", dtype="float32")
    pred = BackgroundRemoval.from_model(model, image_size=1024, device="cuda")
    yield pred, pred32
    del pred, pred32
    torch.cuda.empty_cache()


def encoder_taps(pred, canvases, route):
    """The encoder's tap outputs, in fp32, for (B, S, S, 3) uint8 canvases
    normalized as the predictor normalizes them."""
    x = torch.from_numpy(canvases).cuda()
    with torch.inference_mode():
        xx = ((x.float() - pred._mean) * pred._inv_std).to(pred.compute_dtype)
        return [t.float() for t in pred.model.encoder(xx, pred.cfg.tap_layers,
                                                      route)]


def tap_errors(got, ref, tol):
    """||got - ref|| / ||ref|| per tap and image, the worst within `tol`."""
    for g, r in zip(got, ref):
        err = (g - r).flatten(1).norm(dim=1) / r.flatten(1).norm(dim=1)
        assert float(err.max()) <= tol, err.tolist()


def test_slice_on_cuda(cuda, predictors):
    """`remove_background` and `remove_background_batch` (16 images of
    varied aspect) at 1024^2: K1-K5 once a block a forward, results of the
    right shape and finite; the batch against each image alone (masks,
    IoU scores and, since seeded weights leave the soft masks flat near
    0.5, the encoder taps, where a fault in the kernels' batch indexing
    shows in every image but the first); against float32 exact mode (the
    taps, thresholded masks, IoU scores; no bf16 kernel launched there)."""
    pred, pred32 = predictors
    image, _ = fixture_pair()
    per_forward = pred.cfg.num_encoder_layers_used
    assert pred.compute_dtype == torch.bfloat16
    reset_counts()
    res = pred.remove_background(image)
    assert launch_counts() == dict.fromkeys(launch_counts(), per_forward)
    assert res.predicted_mask.shape == image.shape[:2]
    assert res.all_masks.shape[0] == 3 and res.all_ious.shape == (3,)
    assert np.isfinite(res.all_masks).all() and np.isfinite(res.all_ious).all()
    assert res.rgba_image.mode == "RGBA"
    np.testing.assert_array_equal(res.predicted_mask,
                                  res.all_masks[int(res.all_ious.argmax())])

    imgs = fixture_variants(image)
    reset_counts()
    batch = pred.remove_background_batch(imgs)
    assert launch_counts() == dict.fromkeys(launch_counts(), per_forward)
    assert len(batch) == 16
    singles = [pred.remove_background(im) for im in imgs]
    for im, r, s in zip(imgs, batch, singles):
        assert r.predicted_mask.shape == im.shape[:2]
        assert np.abs(r.all_masks - s.all_masks).max() <= BATCH_TOL
        assert np.abs(r.all_ious - s.all_ious).max() <= BATCH_TOL
    c16 = np.stack([pred._preprocess(im)[0] for im in imgs])
    tap_errors(encoder_taps(pred, c16, "kernel"),
               [torch.cat(t) for t in zip(*(encoder_taps(pred, c[None], "kernel")
                                            for c in c16))], BATCH_TOL)

    tap_errors(encoder_taps(pred, c16[:4], "kernel"),
               encoder_taps(pred32, c16[:4], "exact"), TAP_TOL)
    reset_counts()
    res32 = pred32.remove_background(image)
    assert not any(launch_counts().values())
    agree = float(((res.all_masks > 0.5) == (res32.all_masks > 0.5)).mean())
    assert agree >= 0.99
    assert np.abs(res.all_ious - res32.all_ious).max() <= 2e-2


def test_quality_on_cuda(cuda):
    """The tiny checkpoint trained at 1024^2 (D = 32: the `mma.sync`
    kernels) still segments the fixture in bf16: IoU >= 0.9."""
    from s3od_torch import BackgroundRemoval

    image, mask = fixture_pair()
    pred = BackgroundRemoval(str(TINY_1024), image_size=1024, device="cuda")
    reset_counts()
    res = pred.remove_background(image)
    want = pred.cfg.num_encoder_layers_used
    assert launch_counts() == dict.fromkeys(launch_counts(), want)
    assert iou(res.predicted_mask, mask > 128) >= 0.9


def test_highres_on_cuda(cuda):
    """The 2048^2 path (16389 tokens, K6): `remove_background_stream`
    (batch 1, payload "best", bucketed upload) with K1-K5 once a block an
    image, each answer against `payload="full"`, the taps against float32
    exact mode; the tiny checkpoint through SODPredictor at 2048^2."""
    from s3od_torch import BackgroundRemoval
    from s3od_torch.evaluation.predictor import SODPredictor

    image, _ = fixture_pair()
    model = seeded_model(0, device="cpu")
    model32 = copy.deepcopy(model)
    pred = BackgroundRemoval.from_model(model, image_size=2048, device="cuda")
    per_image = pred.cfg.num_encoder_layers_used
    imgs = fixture_variants(image)[:4]
    reset_counts()
    streamed = list(pred.remove_background_stream(imgs, batch=1, payload="best",
                                                  upload="bucket"))
    assert len(streamed) == len(imgs)
    assert launch_counts() == dict.fromkeys(launch_counts(), per_image * len(imgs))
    for im, res in zip(imgs, streamed):
        full = pred.remove_background(im)
        assert res.all_masks.shape == (1,) + im.shape[:2]
        assert np.isfinite(res.predicted_mask).all()
        assert np.abs(res.predicted_mask - full.predicted_mask).max() <= BEST_TOL
        assert np.abs(res.all_ious - full.all_ious).max() <= 1e-5
    pred32 = BackgroundRemoval.from_model(model32, image_size=2048, device="cuda",
                                          dtype="float32")
    canvases = [pred._preprocess(im)[0][None] for im in imgs[:2]]
    tap_errors([torch.cat(t) for t in zip(*(encoder_taps(pred, c, "kernel")
                                            for c in canvases))],
               [torch.cat(t) for t in zip(*(encoder_taps(pred32, c, "exact")
                                            for c in canvases))], TAP_TOL)
    del pred, pred32, model32
    torch.cuda.empty_cache()

    sod = SODPredictor(str(TINY_1024), image_size=2048, device="cuda")
    sod32 = SODPredictor(str(TINY_1024), image_size=2048, device="cuda",
                         dtype="float32")
    assert sod.compute_dtype == torch.bfloat16
    reset_counts()
    res = sod.predict(image)
    want = sod.cfg.num_encoder_layers_used
    assert launch_counts() == dict.fromkeys(launch_counts(), want)
    assert res.soft_mask.shape == image.shape[:2] and res.num_masks == 3
    assert np.isfinite(res.soft_mask).all()
    canvas = sod._letterbox(image)[0][None]
    tap_errors(encoder_taps(sod.predictor, canvas, "kernel"),
               encoder_taps(sod32.predictor, canvas, "exact"), TAP_TOL)


def test_serving_on_cuda(cuda, predictors):
    """InferenceServer over the 1024^2 predictor, 8 concurrent requests:
    every one answered, in batches, as a direct call answers; the stream
    at batch 1 and 16 answers every image."""
    from s3od_torch.serving import InferenceServer

    pred, _ = predictors
    imgs = fixture_variants(fixture_pair()[0])
    server = InferenceServer(pred, max_batch=4, max_wait_ms=50).start()
    try:
        answers = [f.result(timeout=300) for f in
                   [server.submit_async(imgs[i]) for i in range(8)]]
    finally:
        server.stop()
    assert server.stats["requests"] == 8
    assert server.mean_batch_size > 1.0
    for i, r in enumerate(answers):
        single = pred.remove_background(imgs[i])
        assert np.abs(r.all_masks - single.all_masks).max() <= BATCH_TOL
        assert np.abs(r.all_ious - single.all_ious).max() <= BATCH_TOL
    for batch in (1, 16):
        out = list(pred.remove_background_stream(imgs, batch=batch, payload="best",
                                                 upload="bucket"))
        assert len(out) == len(imgs)


@contextlib.contextmanager
def decoder_shadowed(worst, fault=None):
    """Every K9a, K9b and K10 call of the decoder against its plain version
    on the call's own inputs: the worst ||d|| / ||plain|| per kernel into
    `worst`. The callers' references (`ops/conv`'s and `models/dpt`'s)
    are shadowed; the wrappers, and their counts, are not. `fault` names
    a kernel whose output is multiplied by 1.01."""
    from s3od_torch.models import dpt
    from s3od_torch.ops import conv
    from s3od_torch.ops.experimental import mask_tail, winograd

    real = (conv.conv3x3_winograd, dpt.rcu_winograd, dpt.mask_tail)

    def held(name, out, ref):
        if name == fault:
            out = out * 1.01
        worst[name] = max(worst.get(name, 0.0), rel_norm(out, ref))
        return out

    def k9a(x, p):
        b = p.get("bias")
        if b is None:
            b = torch.zeros(p["kernel"].shape[-1], dtype=x.dtype, device=x.device)
        return held("K9a", real[0](x, p), winograd.winograd_conv_plain(x, p["kernel"], b))

    def k9b(x, p1, p2):
        return held("K9b", real[1](x, p1, p2), winograd.winograd_rcu_plain(
            x, p1["kernel"], p1["bias"], p2["kernel"], p2["bias"]))

    def k10(*args):
        return held("K10", real[2](*args), mask_tail.mask_tail_plain(*args))

    conv.conv3x3_winograd, dpt.rcu_winograd, dpt.mask_tail = k9a, k9b, k10
    try:
        yield
    finally:
        conv.conv3x3_winograd, dpt.rcu_winograd, dpt.mask_tail = real


def test_decoder_gates_on_cuda(cuda, predictors):
    """Both decoder gates on at 1024^2 (`S3OD_WINOGRAD`'s K9a and K9b,
    `MASK_TAIL_FUSED`'s K10): `remove_background` and
    `remove_background_batch` (16) launch them as the copied rule gives it
    (3 / 4 / 1) beside K1-K5 once a block; every gated call within
    DEC_CALL_TOL of its plain version, where a planted K9b x 1.01 and K9a
    x 1.01 fail; the answers against float32 exact mode."""
    pred, pred32 = predictors
    image, _ = fixture_pair()
    imgs = fixture_variants(image)
    want = decoder_rule_counts(pred.cfg, 1024)
    assert want == {"K9a": 3, "K9b": 4, "K10": 1}
    with decoder_gates(True):
        worst = {}
        reset_counts()
        with decoder_shadowed(worst):
            res = pred.remove_background(image)
        assert decoder_counts() == want
        enc = pred.cfg.num_encoder_layers_used
        assert launch_counts() == dict.fromkeys(launch_counts(), enc)
        reset_counts()
        with decoder_shadowed(worst):
            batch = pred.remove_background_batch(imgs)
        assert decoder_counts() == want
        assert max(worst.values()) <= DEC_CALL_TOL, worst
        for name in ("K9b", "K9a"):
            faulty = {}
            with decoder_shadowed(faulty, fault=name):
                pred.remove_background(image)
            assert faulty[name] > DEC_CALL_TOL, name
        for r, im in zip([res] + batch, [image] + imgs):
            r32 = pred32.remove_background(im)
            assert ((r.all_masks > 0.5) == (r32.all_masks > 0.5)).mean() >= 0.99
            assert np.abs(r.all_ious - r32.all_ious).max() <= 2e-2


def test_decoder_gates_at_2048_on_cuda(cuda):
    """Both gates on at 2048^2: one forward with every gated call held to
    its plain version (refinenet1's RCU convs on K9a among them, 7 / 4 / 1
    launches by the rule), then `remove_background_stream` (batch 1,
    "best", bucketed upload): launches per image by the rule, each answer
    against `payload="full"`."""
    from s3od_torch import BackgroundRemoval

    model = seeded_model(0, device="cpu")
    pred = BackgroundRemoval.from_model(model, image_size=2048, device="cuda")
    want = decoder_rule_counts(pred.cfg, 2048)
    assert want == {"K9a": 7, "K9b": 4, "K10": 1}
    imgs = fixture_variants(fixture_pair()[0])[:2]
    with decoder_gates(True):
        worst = {}
        reset_counts()
        with decoder_shadowed(worst):
            pred.remove_background(imgs[0])
        assert decoder_counts() == want
        assert max(worst.values()) <= DEC_CALL_TOL, worst
        reset_counts()
        streamed = list(pred.remove_background_stream(
            imgs, batch=1, payload="best", upload="bucket"))
        assert decoder_counts() == {k: 2 * v for k, v in want.items()}
        for im, r in zip(imgs, streamed):
            full = pred.remove_background(im)
            assert np.abs(r.predicted_mask - full.predicted_mask).max() <= BEST_TOL
            assert np.abs(r.all_ious - full.all_ious).max() <= 1e-5


def _aot_vs_eager(aot, eager, imgs, payload, per_forward):
    """The bundle predictor's answers against the eager predictor's on the
    same images (batch 1 and the batch of all of `imgs`), K1-K5 once a
    block a forward through the graphs."""
    tol = 1e-5 if payload == "full" else AOT_STEP
    reset_counts()
    got = aot.remove_background(imgs[0], payload=payload)
    assert launch_counts() == dict.fromkeys(launch_counts(), per_forward)
    pairs = [(got, eager.remove_background(imgs[0], payload=payload))]
    if len(imgs) > 1:
        reset_counts()
        got = aot.remove_background_batch(imgs, payload=payload)
        assert launch_counts() == dict.fromkeys(launch_counts(), per_forward)
        pairs += list(zip(got, eager.remove_background_batch(imgs, payload=payload)))
    for g, r in pairs:
        assert np.abs(g.all_masks - r.all_masks).max() <= tol
        assert np.abs(g.all_ious - r.all_ious).max() <= 1e-5


COLD_CODE = """
import json
import numpy as np
from PIL import Image
from s3od_torch import BackgroundRemoval
r = {load}.remove_background(np.array(Image.open({image!r}).convert("RGB")))
print(json.dumps(float(r.all_ious[0])))
"""


def test_aot_on_cuda(cuda, tmp_path):
    """The serving bundle of ViT-B (seeded, bf16), exported on the card:
    1024^2 b1/b16 x full/best, 2048^2 b1 best (K6 through a graph), 1024^2
    b1 full with both decoder gates on; each bundle verified, the weights
    held once (the graphs under 5% of them), its predictor against the
    eager one with launch counts (and the eager route where no graph
    fits), and a fresh process served from the bundle answering as one
    served from the `.npz`."""
    from s3od_torch import BackgroundRemoval
    from s3od_torch.aot import ServingBundle, save_serving_bundle, verify_bundle
    from s3od_torch.convert import convert_state_dict, save_native

    model = seeded_model(0)
    per_forward = model.cfg.num_encoder_layers_used
    specs = {"b1024": dict(image_size=1024, batches=(1, B16)),
             "b2048": dict(image_size=2048, batches=(1,), payloads=("best",)),
             "gated": dict(image_size=1024, batches=(1,), payloads=("full",))}
    preds, graphs = {}, 0
    for name, kw in specs.items():
        with decoder_gates(name == "gated"):
            out = save_serving_bundle(tmp_path / name, model, **kw)
        meta = json.loads((out / "meta.json").read_text())
        graphs += sum(p.stat().st_size for p in out.glob("*.pt2"))
        preds[name] = pred = BackgroundRemoval.from_serving_bundle(out)
        verify_bundle(ServingBundle(pred.model, meta, pred._aot), n=1)
    assert graphs < 0.05 * (tmp_path / "b1024" / "weights.npz").stat().st_size

    imgs = fixture_variants(fixture_pair()[0])
    eager = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=1024)
    aot = preds.pop("b1024")
    assert sorted(aot._aot) == [(1, "best"), (1, "full"), (B16, "best"), (B16, "full")]
    for payload in ("full", "best"):
        _aot_vs_eager(aot, eager, imgs, payload, per_forward)
    reset_counts()
    aot.remove_background_batch(imgs[:3])  # no b3 graph: the eager route
    assert launch_counts()["K1"] == per_forward
    del aot, eager

    eager = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=2048)
    _aot_vs_eager(preds.pop("b2048"), eager, imgs[:1], "best", per_forward)
    del eager

    with decoder_gates(True):
        eager = BackgroundRemoval.from_model(copy.deepcopy(model), image_size=1024)
        gated = {}
        for tag, pred in (("eager", eager), ("bundle", preds.pop("gated"))):
            reset_counts()
            res = pred.remove_background(imgs[0])
            gated[tag] = ({**decoder_counts(), **launch_counts()}, res.all_masks)
    assert gated["eager"][0] == gated["bundle"][0]
    assert all(gated["bundle"][0][k] > 0 for k in ("K9a", "K9b", "K10"))
    assert np.abs(gated["eager"][1] - gated["bundle"][1]).max() <= 1e-5
    del eager

    npz = tmp_path / "vit_b.npz"
    save_native(str(npz), *convert_state_dict(model.cpu().state_dict(), model.cfg)[:2])
    answers = []
    for load in (f"BackgroundRemoval.from_serving_bundle({str(tmp_path / 'b1024')!r})",
                 f"BackgroundRemoval({str(npz)!r}, image_size=1024)"):
        out = subprocess.run(
            [sys.executable, "-c", COLD_CODE.format(load=load, image=str(REPO / "tests"
                                                                       / "fixture"
                                                                       / "image.jpg"))],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        answers.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert abs(answers[0] - answers[1]) <= 1e-5


def test_tools_on_cuda(cuda, tmp_path):
    """`test_efficiency` at ViT-B 840^2 (b1 and b16): the `s3od::` FLOPs
    equal the ops' formulas over 2709 tokens padded to 2752 and the mask
    heads' 1x1s (`s3od::mask_logits`) on the 832^2 canvas; `mine_samples`
    with the tiny 1024^2 checkpoint, bf16 scores against fp32 (MINE_TOL);
    `export_model --verify --aot-output` on it; the demo's HTTP server on
    the card answering as a direct call."""
    from s3od_torch import BackgroundRemoval, demo_app, export_model
    from s3od_torch.evaluation import mine_samples, test_efficiency
    from s3od_torch.evaluation.predictor import SODPredictor

    model = seeded_model(0)
    cfg, blocks = model.cfg.encoder, model.cfg.num_encoder_layers_used
    sod = SODPredictor(image_size=840, _predictor=BackgroundRemoval.from_model(
        model, image_size=840))
    n, c, f = 2752, cfg.hidden_size, cfg.intermediate_size
    per_block = 6 * n * c * c + 4 * n * n * c + 2 * n * c * c + 4 * n * c * f
    tail = 2 * model.cfg.num_outputs * model.cfg.mask_inter_features * 832**2
    for batch in (1, B16):
        r = test_efficiency.run_benchmark(
            input_size=840, batch=batch, _predictor=sod,
            output_file=str(tmp_path / f"benchmark_results_b{batch}.txt"),
            trace_dir=str(tmp_path / f"trace_b{batch}"))
        assert r["s3od_flops"] == batch * (per_block * blocks + tail)
        assert r["tokens"] == 2709 and r["params"] > 100e6
    del sod, model

    image, mask = fixture_pair()
    mine_dir = tmp_path / "mine"
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
                                  output_dir=str(tmp_path / f"mine_{dt}"), dtype=dt)
            for dt in ("bfloat16", "float32")}
    assert len(runs["bfloat16"]["category_scores"]) == 2
    for cat, scores in runs["float32"]["category_sample_scores"].items():
        for a, b in zip(runs["bfloat16"]["category_sample_scores"][cat], scores):
            assert abs(a - b) <= MINE_TOL, (cat, a, b)

    ex = tmp_path / "export"
    ex.mkdir()
    export_model.main([
        "--checkpoint", str(TINY_1024), "--output", str(ex / "s3od.npz"),
        "--torch-output", str(ex / "s3od.pt"), "--aot-output", str(ex / "bundle"),
        "--aot-batches", "1", "--verify"])

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
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            json.loads(resp.headers["X-S3OD-Info"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    got = np.asarray(Image.open(io.BytesIO(body)))
    assert np.array_equal(got, np.asarray(pred.remove_background(image).rgba_image))


FILTER_SAMPLES = 16  # a class


def _write_filter_set(root):
    """Two classes of FILTER_SAMPLES image/mask pairs from the fixture pair
    (flips and small cyclic shifts, so the tiny checkpoint still finds the
    object; every fourth mask inverted, every fifth fragmented into
    squares): what `generate_train_images` writes, organised by class."""
    image, mask = fixture_pair()
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
            shift = ((i * 7) % 16, (i * 11) % 16)
            im, m = np.roll(im, shift, (0, 1)), np.roll(m, shift, (0, 1))
            if i % 4 == 3:
                m = 255 - m
            if i % 5 == 4:
                m = frag
            Image.fromarray(np.ascontiguousarray(im)).save(
                root / cls / "images" / f"{i:04d}.jpg", quality=95)
            Image.fromarray(np.ascontiguousarray(m)).save(
                root / cls / "masks" / f"{i:04d}.png")


def test_filtering_on_cuda(cuda, tmp_path):
    """`run_filtering` with the chain flip_consistency -> semantic_quality
    -> mask_artifacts (the VLM filters on their heuristics) over a
    class-organised set: on the seeded ViT-B at 840^2, batch 8, K1-K5 once
    a block a forward of 16 images (an image and its flip); on the tiny
    checkpoint (128 canvas, bf16 kernels, D = 32) the card's verdicts
    equal a float32 CPU run's, sample by sample, keeping some and
    rejecting some."""
    import yaml

    from s3od_torch.convert import convert_state_dict, save_native
    from s3od_torch.datagen import filtering, run_filtering

    _write_filter_set(tmp_path / "set")
    vit_b = tmp_path / "vit_b.npz"
    params, state, _ = convert_state_dict(
        {k: v.cpu() for k, v in seeded_model(4).state_dict().items()})
    save_native(str(vit_b), params, state)

    def run(tag, model, size, device):
        vlm = str(tmp_path / "no_vlm")
        cfg = {"input_dir": str(tmp_path / "set"),
               "output_dir": str(tmp_path / tag / "out"),
               "failed_dir": str(tmp_path / tag / "failed"),
               "filters": [{"type": "flip_consistency", "model_path": str(model),
                            "image_size": size, "batch_size": 8, "device": device},
                           {"type": "semantic_quality", "model_id": vlm,
                            "device": device},
                           {"type": "mask_artifacts", "model_id": vlm,
                            "device": device}]}
        path = tmp_path / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        seen = []
        real = filtering.BaseFilter.record

        def record(self, res):
            seen.extend((self.name, x.passed, x.reason) for x in res)
            return real(self, res)

        filtering.BaseFilter.record = record
        try:
            stats = run_filtering.main(["--config", str(path)])
        finally:
            filtering.BaseFilter.record = real
        return stats, seen

    reset_counts()
    run("vit_b", vit_b, 840, "cuda")
    chunks = -(-2 * FILTER_SAMPLES // 8)
    assert launch_counts() == dict.fromkeys(launch_counts(), 11 * chunks)
    s_card, v_card = run("tiny_card", TINY, 128, "cuda")
    s_cpu, v_cpu = run("tiny_cpu", TINY, 128, "cpu")
    assert v_card == v_cpu and s_card == s_cpu
    assert s_card["kept"] > 0 and s_card["rejected"]
