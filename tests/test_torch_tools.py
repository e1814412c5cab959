"""s3od_torch's evaluation and deployment tools on the CPU, against the JAX
package on the same inputs: `export_model` (its `.npz` and `.pt` read by
the JAX loaders to the same tree, a bundle written and verified),
`mine_samples` (scores and allocation against JAX's `mine`, float32, and
the results JSON read back by the generator), the visualizer, the demo's
HTTP server (equal to a direct call, alpha within one grey level of the
JAX demo's), `test_efficiency` (report fields, the parameter count equal
to JAX's on the same prepared tree) and the trace summary."""

import io
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from s3od_torch import BackgroundRemoval

FIXTURE = Path(__file__).parent / "fixture"
TINY = FIXTURE / "tiny_s3od.npz"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {} if tree is None else {prefix: np.asarray(tree)}


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.fixture(scope="module")
def image():
    return np.array(Image.open(FIXTURE / "image.jpg").convert("RGB"))


@pytest.fixture(scope="module")
def gt():
    return np.array(Image.open(FIXTURE / "mask.png").convert("L")) / 255.0


# ----------------------------------------------------------------------------
# export_model
# ----------------------------------------------------------------------------


def test_export_model_formats_read_by_jax(tmp_path):
    from s3od_torch import export_model
    from s3od_tpu.convert import (load_native, load_native_segmentation,
                                  load_torch_checkpoint)

    npz, pt, aot = tmp_path / "m.npz", tmp_path / "m.pt", tmp_path / "bundle"
    report = export_model.main([
        "--checkpoint", str(TINY), "--output", str(npz), "--torch-output",
        str(pt), "--aot-output", str(aot), "--aot-image-size", "64",
        "--aot-batches", "1", "--aot-dtype", "float32", "--verify",
        "--device", "cpu"])
    assert report["npz_diff"] < 1e-5 and report["pt_diff"] < 1e-4
    assert report["bundle_diff"] <= 1e-5
    ref_params, ref_state = load_native(str(TINY))
    params, state = load_native(str(npz))
    _assert_same_tree(params, ref_params)
    _assert_same_tree(state, ref_state)
    jax_cfg = load_native_segmentation(str(TINY))[2]  # width 64: no family
    pt_params, pt_state, _ = load_torch_checkpoint(str(pt), jax_cfg)
    _assert_same_tree(pt_params, ref_params)
    _assert_same_tree(pt_state, ref_state)
    assert json.loads((aot / "meta.json").read_text())["payloads"] == {
        "full": [1], "best": [1]}


def test_export_model_reads_a_training_checkpoint_dir(tmp_path):
    """A training checkpoint directory of the port (`state.pt`) exports to
    the tree its model was loaded from."""
    from s3od_torch.convert import load_checkpoint
    from s3od_torch.export_model import load_any
    from s3od_torch.models.segmentation import S3ODSegmentation
    from s3od_tpu.convert import load_native

    sd, cfg = load_checkpoint(TINY)
    model = S3ODSegmentation(cfg)
    model.load_state_dict(sd, strict=True)
    (tmp_path / "last").mkdir()
    torch.save({"model": model.state_dict(), "step": 3, "epoch": 0},
               tmp_path / "last" / "state.pt")
    params, state, got_cfg = load_any(str(tmp_path / "last"))
    ref_params, ref_state = load_native(str(TINY))
    assert got_cfg == cfg
    _assert_same_tree(params, ref_params)
    _assert_same_tree(state, ref_state)


# ----------------------------------------------------------------------------
# mine_samples
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mining_dir(tmp_path_factory, image, gt):
    """Two categories of two images each (the fixture, flipped, cropped),
    with their masks, in the images/ + masks/ layout `mine` reads."""
    root = tmp_path_factory.mktemp("mine")
    (root / "images").mkdir()
    (root / "masks").mkdir()
    mask = (gt * 255).astype(np.uint8)
    h, w = mask.shape
    variants = {
        "cat_0": (image, mask),
        "cat_1": (image[:, ::-1], mask[:, ::-1]),
        "dog_0": (image[h // 8:, : 7 * w // 8], mask[h // 8:, : 7 * w // 8]),
        "dog_1": (image[::-1], mask[::-1]),
    }
    for name, (im, m) in variants.items():
        Image.fromarray(np.ascontiguousarray(im)).save(root / "images" / f"{name}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(root / "masks" / f"{name}.png")
    return root


def test_mine_samples_matches_jax(mining_dir, tmp_path):
    from s3od_torch.datagen.generate_train_images import load_class_weights
    from s3od_torch.evaluation.mine_samples import mine
    from s3od_tpu.evaluation.mine_samples import mine as jax_mine

    got = mine(str(mining_dir), str(TINY), img_size=128,
               output_dir=str(tmp_path / "port"), device="cpu",
               dtype="float32")
    ref = jax_mine(str(mining_dir), str(TINY), img_size=128,
                   output_dir=str(tmp_path / "jax"))
    assert got["category_scores"].keys() == ref["category_scores"].keys() == {
        "cat", "dog"}
    for cat in ref["category_scores"]:
        np.testing.assert_allclose(got["category_sample_scores"][cat],
                                   ref["category_sample_scores"][cat], atol=1e-4)
    assert got["new_samples"] == ref["new_samples"]
    assert got["stable_categories"] == ref["stable_categories"]
    assert got["unstable_categories"] == ref["unstable_categories"]
    # the results JSON drives the port's generator
    assert load_class_weights(got["path"], 0) == got["new_samples"]


def test_mine_runs_one_batch_of_two_per_image(mining_dir, tmp_path):
    from s3od_torch.evaluation.mine_samples import mine
    from s3od_torch.evaluation.predictor import SODPredictor

    pred = SODPredictor(str(TINY), image_size=128, device="cpu")
    batches = []
    forward = pred.predictor.forward_canvases
    pred.predictor.forward_canvases = (
        lambda c, *a, **k: batches.append(len(c)) or forward(c, *a, **k))
    mine(str(mining_dir), None, output_dir=str(tmp_path), _predictor=pred)
    assert batches == [2, 2, 2, 2]


@pytest.mark.parametrize("scores", [
    {"a": 0.99, "b": 0.9, "c": 0.5},
    {"x": 0.8, "y": 0.95, "z": 0.81, "w": 0.0},
])
def test_allocation_and_stability_match_jax(scores):
    from s3od_torch.evaluation import mine_samples as port
    from s3od_tpu.evaluation import mine_samples as jax_ms

    for args in ((), (5, 80, 0.9, 0.7)):
        assert port.calculate_new_samples(scores, *args) == \
            jax_ms.calculate_new_samples(scores, *args)
    assert port.analyze_stability(scores, 2) == jax_ms.analyze_stability(scores, 2)


# ----------------------------------------------------------------------------
# Visualizer and demo
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("n_masks", [1, 3, 5])
def test_visualizer_matches_jax(n_masks, image):
    from s3od_torch.predictor import RemovalResult
    from s3od_torch.visualizer import visualize_all_masks, visualize_removal
    from s3od_tpu import visualizer as jax_vis
    from s3od_tpu.predictor import RemovalResult as JaxRemovalResult

    rng = np.random.default_rng(n_masks)
    masks = rng.random((n_masks,) + image.shape[:2]).astype(np.float32)
    ious = rng.random(n_masks).astype(np.float32)
    rgba = Image.fromarray(np.dstack([image, (masks[0] * 255).astype(np.uint8)]))
    fields = dict(predicted_mask=masks[0], all_masks=masks, all_ious=ious,
                  rgba_image=rgba)
    got, ref = RemovalResult(**fields), JaxRemovalResult(**fields)
    for bg in ((0, 255, 0), (255, 255, 255)):
        np.testing.assert_array_equal(
            np.asarray(visualize_removal(image, got, bg)),
            np.asarray(jax_vis.visualize_removal(image, ref, bg)))
    np.testing.assert_array_equal(
        np.asarray(visualize_all_masks(Image.fromarray(image), got)),
        np.asarray(jax_vis.visualize_all_masks(Image.fromarray(image), ref)))


def test_demo_helpers_match_jax(image):
    import demo.app as jax_app
    from s3od_torch import demo_app

    rng = np.random.default_rng(0)
    masks = rng.random((3, 40, 60)).astype(np.float32)
    for i in range(3):
        for j in range(3):
            assert demo_app.compute_mask_iou(masks[i], masks[j]) == \
                jax_app.compute_mask_iou(masks[i], masks[j])
    for m in (masks, np.stack([masks[0]] * 3)):
        assert demo_app.is_ambiguous(m) == jax_app.is_ambiguous(m)
    np.testing.assert_array_equal(
        np.asarray(demo_app.create_masks_grid(masks, (40, 60))),
        np.asarray(jax_app.create_masks_grid(masks, (40, 60))))


def _serve(app, key, pred):
    app._model_cache[key] = pred
    server = app.make_http_server(key, 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body, ctype="application/octet-stream"):
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "image/png"
        info = json.loads(resp.headers["X-S3OD-Info"])
        return np.asarray(Image.open(io.BytesIO(resp.read()))), info


def test_demo_http_matches_direct_call_and_jax_demo(image):
    import demo.app as jax_app
    from s3od_torch import demo_app
    from s3od_tpu.predictor import BackgroundRemoval as JaxBackgroundRemoval

    pred = BackgroundRemoval(str(TINY), image_size=128, device="cpu")
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    png = buf.getvalue()
    server, url = _serve(demo_app, "tiny-port", pred)
    try:
        got, info = _post(url, png)
        boundary = "s3odboundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="image"; filename="a.png"\r\nContent-Type: image/png'
                f"\r\n\r\n").encode() + png + (
                    f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="method"\r\n\r\nwhite\r\n--{boundary}--\r\n').encode()
        white, _ = _post(url, body, f"multipart/form-data; boundary={boundary}")
        with urllib.request.urlopen(url + "/", timeout=30) as resp:
            assert b"<form" in resp.read()
    finally:
        server.shutdown()
    direct = pred.remove_background(image)
    np.testing.assert_array_equal(got, np.asarray(direct.rgba_image))
    assert info["best"] == int(direct.all_ious.argmax())
    np.testing.assert_allclose(info["ious"], direct.all_ious, rtol=1e-6)
    assert white.shape == image.shape

    jax_pred = JaxBackgroundRemoval(model_id=str(TINY), image_size=128,
                                    dtype="float32")
    server, url = _serve(jax_app, "tiny-jax", jax_pred)
    try:
        ref, ref_info = _post(url, png)
    finally:
        server.shutdown()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    assert np.abs(got[..., 3].astype(int) - ref[..., 3].astype(int)).max() <= 1
    assert info["best"] == ref_info["best"]
    assert info["ambiguous"] == ref_info["ambiguous"]


# ----------------------------------------------------------------------------
# Efficiency report and trace summary
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_efficiency_report_and_parameter_count(dtype, tmp_path):
    """The report's fields, the FLOPs of the s3od:: ops on the kernel
    route, and the parameter count equal to JAX's `count_parameters` on
    the same prepared (BN-folded) tree. No assertion reads a timing's
    size: at this width the slope is host noise."""
    import jax.numpy as jnp

    from s3od_torch.evaluation.predictor import SODPredictor
    from s3od_torch.evaluation.test_efficiency import run_benchmark
    from s3od_tpu.convert import load_native_segmentation
    from s3od_tpu.evaluation.test_efficiency import count_parameters
    from s3od_tpu.predictor import prepare_serving_params

    pred = SODPredictor(str(TINY), image_size=64, device="cpu", dtype=dtype)
    out = tmp_path / "benchmark_results.txt"
    res = run_benchmark(input_size=64, iterations=2, batch=2,
                        output_file=str(out), trace_dir=str(tmp_path / "tr"),
                        _predictor=pred)
    report = out.read_text()
    for token in ("device: cpu", "params:", "latency:", "throughput:",
                  "input: 2x64x64x3", "flops/step:", "tokens: 21",
                  "memory: not measured"):
        assert token in report, report
    assert np.isfinite(res["latency_ms"]) and res["fps"] > 0
    assert res["flops"] > 0
    assert (res["s3od_flops"] > 0) == (dtype == "bfloat16")
    assert res["trace_summary"]["source"] == "host"

    params, state, cfg = load_native_segmentation(str(TINY))
    prepared, _, _ = prepare_serving_params(params, state, cfg, jnp.float32,
                                            fold_bn=True)
    assert res["params"] == count_parameters(prepared)


def test_summarize_trace_on_a_cpu_trace(tmp_path, capsys):
    from s3od_torch.profiling import (capture_trace, print_summary, span,
                                      summarize_trace)

    a = torch.randn(96, 96)

    def fn():
        with span("s3od.test.outer"):
            b = a @ a
            with span("s3od.test.inner"):
                return torch.relu(b)

    path = capture_trace(fn, str(tmp_path), iters=3)
    assert path.endswith(".json.gz") and Path(path).exists()
    summary = summarize_trace(path, iters=3, top_k=5)
    assert summary["source"] == "host"
    cats = {name: cnt for name, _, cnt in summary["by_category"]}
    # outermost operators only: the matmul's inner mm is not counted again
    assert cats.get("matmul") == 1 and cats.get("relu") == 1
    assert "mm" not in cats
    assert summary["total_ms"] > 0 and len(summary["top_ops"]) <= 5
    # by span: the operators started inside each span, per iteration
    spans = {name: (ms, cnt) for name, ms, cnt in summary["by_span"]}
    assert spans.keys() == {"s3od.test.outer", "s3od.test.inner"}
    assert spans["s3od.test.outer"][1] == 2 and spans["s3od.test.inner"][1] == 1
    assert 0 < spans["s3od.test.inner"][0] <= spans["s3od.test.outer"][0]
    print_summary(summary)
    out = capsys.readouterr().out
    assert "host total:" in out and "by span:" in out
    assert "s3od.test.inner" in out


def test_summarize_trace_by_span_reads_device_work_by_its_launch(tmp_path):
    """Device work is put down to the span around the runtime or driver
    call that launched it (joined by correlation id), on that call's
    thread: not to a span of another thread open at the same time, nor to
    the span open while the kernel itself ran."""
    from s3od_torch.profiling import summarize_trace

    def x(name, cat, ts, dur, tid, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid, "args": args}

    events = [
        x("s3od.kernel.flash_attention_bwd", "user_annotation", 0, 10, 2),
        x("cudaLaunchKernel", "cuda_runtime", 2, 1, 2, correlation=7),
        x("cuLaunchKernelEx", "cuda_driver", 5, 1, 2, correlation=8),
        x("s3od.train.forward", "user_annotation", 0, 100, 1),
        x("cudaMemsetAsync", "cuda_runtime", 20, 1, 1, correlation=9),
        x("s3od.train.optimizer", "user_annotation", 200, 50, 1),
        x("bwd_dkv_kernel", "kernel", 210, 300, 0, correlation=7),
        x("bwd_dq_kernel", "kernel", 510, 200, 0, correlation=8),
        x("Memset (Device)", "gpu_memset", 30, 4, 0, correlation=9),
        x("orphan_kernel", "kernel", 220, 40, 0, correlation=99),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    summary = summarize_trace(str(path), iters=1)
    assert summary["source"] == "device"
    spans = {name: (ms, cnt) for name, ms, cnt in summary["by_span"]}
    assert spans["s3od.kernel.flash_attention_bwd"] == (pytest.approx(0.5), 2)
    assert spans["s3od.train.forward"] == (pytest.approx(0.004), 1)
    assert spans["s3od.train.optimizer"] == (0.0, 0)
    assert [n for n, _, _ in summary["by_span"]][0] == "s3od.kernel.flash_attention_bwd"
