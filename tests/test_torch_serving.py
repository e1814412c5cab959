"""s3od_torch serving surfaces on the CPU with the committed tiny checkpoint:
`remove_background_stream` (batch 1 and batched), the "best" and
"best_small" payloads (against "full" and against the JAX predictor's
payloads), bucketed upload, the thread-safe launch counters, and
`s3od_tpu.serving.InferenceServer` over the torch predictor. Mirrors
tests/test_serving_and_augment.py."""

import threading
from pathlib import Path

import numpy as np
import pytest

from s3od_torch import BackgroundRemoval
from s3od_torch import _build
from s3od_torch.serving import InferenceServer

TINY = Path(__file__).parent / "fixture" / "tiny_s3od.npz"


@pytest.fixture(scope="module")
def pred():
    return BackgroundRemoval(str(TINY), image_size=128, device="cpu")


def _images(circle_image, seed, n_random=4):
    img, _ = circle_image
    rng = np.random.default_rng(seed)
    shapes = [(90, 130), (140, 100), (127, 128), (64, 64), (80, 111)]
    return [img] + [(rng.random(s + (3,)) * 255).astype(np.uint8)
                    for s in shapes[:n_random]]


@pytest.mark.parametrize("batch", [1, 3])
def test_stream_matches_single(pred, circle_image, batch):
    """Ordered stream results equal one-at-a-time calls; batch 3 over 5
    images pads the last group of 2 with a copy and drops its output."""
    images = _images(circle_image, 0)
    streamed = list(pred.remove_background_stream(images, depth=2,
                                                  batch=batch))
    assert len(streamed) == len(images)
    for im, res in zip(images, streamed):
        ref = pred.remove_background(im)
        np.testing.assert_allclose(res.predicted_mask, ref.predicted_mask,
                                   atol=1e-5)
        np.testing.assert_allclose(res.all_ious, ref.all_ious, atol=1e-6)
        assert res.rgba_image.size == ref.rgba_image.size


def test_payload_best_matches_full(pred, circle_image):
    """"best" picks the same mask as "full" on the device and returns it
    within the uint8 step (<= 1/510 before the resize, which cannot grow
    it); single, batch and stream agree."""
    images = _images(circle_image, 2, n_random=2)
    for im in images:
        ref = pred.remove_background(im)
        fast = pred.remove_background(im, payload="best")
        np.testing.assert_allclose(fast.all_ious, ref.all_ious, atol=1e-6)
        assert fast.all_masks.shape == (1,) + im.shape[:2]
        np.testing.assert_allclose(fast.predicted_mask, ref.predicted_mask,
                                   atol=1 / 510 + 1e-6)
        a_ref = np.asarray(ref.rgba_image)[..., 3].astype(np.int16)
        a_fast = np.asarray(fast.rgba_image)[..., 3].astype(np.int16)
        assert np.abs(a_ref - a_fast).max() <= 1
    streamed = list(pred.remove_background_stream(images, depth=2, batch=2,
                                                  payload="best"))
    batched = pred.remove_background_batch(images, chunk=2, payload="best")
    for im, s, b in zip(images, streamed, batched):
        one = pred.remove_background(im, payload="best")
        np.testing.assert_allclose(s.predicted_mask, one.predicted_mask,
                                   atol=1e-6)
        np.testing.assert_allclose(b.predicted_mask, one.predicted_mask,
                                   atol=1e-6)


def test_payload_best_small(pred, circle_image):
    """The 2x2-pooled payload: same selection, the restored mask close to
    the full-resolution one (mean |d| < 1e-2, thresholded agreement >
    0.99), and stream and batch equal to single calls."""
    images = _images(circle_image, 5, n_random=1)
    for im in images:
        ref = pred.remove_background(im, payload="best")
        small = pred.remove_background(im, payload="best_small")
        np.testing.assert_allclose(small.all_ious, ref.all_ious, atol=1e-6)
        assert small.all_masks.shape == ref.all_masks.shape
        d = np.abs(small.predicted_mask - ref.predicted_mask)
        assert d.mean() < 0.01, d.mean()
        agree = np.mean((small.predicted_mask > 0.5)
                        == (ref.predicted_mask > 0.5))
        assert agree > 0.99, agree
    streamed = list(pred.remove_background_stream(
        images, depth=2, batch=2, payload="best_small"))
    batched = pred.remove_background_batch(images, chunk=2,
                                           payload="best_small")
    for im, s, b in zip(images, streamed, batched):
        one = pred.remove_background(im, payload="best_small")
        np.testing.assert_allclose(s.predicted_mask, one.predicted_mask,
                                   atol=1e-6)
        np.testing.assert_allclose(b.predicted_mask, one.predicted_mask,
                                   atol=1e-6)


@pytest.mark.parametrize("payload", ["full", "best", "best_small"])
def test_payloads_match_jax_predictor(pred, circle_image, payload):
    """Each payload against the JAX predictor's on the same checkpoint
    (float32): the uint8 masks may differ by one step where the fp32 soft
    mask sits at a rounding boundary."""
    from s3od_tpu.predictor import BackgroundRemoval as JaxBackgroundRemoval

    jax_pred = JaxBackgroundRemoval(model_id=str(TINY), image_size=128,
                                    dtype="float32")
    for im in _images(circle_image, 7, n_random=1):
        got = pred.remove_background(im, payload=payload)
        ref = jax_pred.remove_background(im, payload=payload)
        assert got.all_masks.shape == ref.all_masks.shape
        tol = 1e-4 if payload == "full" else 1 / 255 + 1e-4
        np.testing.assert_allclose(got.all_masks, ref.all_masks, atol=tol)
        np.testing.assert_allclose(got.all_ious, ref.all_ious, atol=1e-4)


def test_bucket_upload_matches_canvas(pred, circle_image):
    """The bucket buffer placed on the device is the host canvas bit for
    bit for every letterbox geometry, so the two uploads give identical
    results."""
    images = _images(circle_image, 3)
    for im in images:
        canvas, _ = pred._preprocess(im)
        buf, tl, _ = pred._bucket_preprocess(im)
        assert buf.shape[0] * buf.shape[1] <= canvas.shape[0] * canvas.shape[1]
        np.testing.assert_array_equal(pred._place(buf, tl).numpy(), canvas)
    ref = list(pred.remove_background_stream(images, upload="canvas", batch=2))
    got = list(pred.remove_background_stream(images, upload="bucket", batch=2))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.predicted_mask, r.predicted_mask)
        np.testing.assert_array_equal(g.all_ious, r.all_ious)


def test_stream_rejects_unknown_options(pred, circle_image):
    img, _ = circle_image
    for kwargs in ({"payload": "half"}, {"upload": "tiles"}, {"batch": 0}):
        with pytest.raises(ValueError):
            list(pred.remove_background_stream([img], **kwargs))
    with pytest.raises(ValueError):
        pred.remove_background(img, payload="half")


def test_launch_counts_are_exact_across_threads():
    """The stream launches from several threads; counts stay exact (more
    threads than cores, a short switch interval: a lost update of an
    unguarded `+= 1` would show)."""
    import sys

    def wrapper():
        pass

    wrapper.launches = 0

    def bump():
        for _ in range(5000):
            with _build.launch(wrapper):
                pass

    threads = [threading.Thread(target=bump) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 80000


def test_inference_server_over_torch_predictor(pred, circle_image):
    """`s3od_tpu.serving.InferenceServer` is duck-typed on
    `remove_background_batch`: concurrent requests are batched and each
    answer equals a direct call."""
    images = _images(circle_image, 4, n_random=3)
    server = InferenceServer(pred, max_batch=4, max_wait_ms=200).start()
    try:
        futures = [server.submit_async(images[i % len(images)])
                   for i in range(8)]
        results = [f.result(timeout=60) for f in futures]
    finally:
        server.stop()
    for i, r in enumerate(results):
        single = pred.remove_background(images[i % len(images)])
        np.testing.assert_allclose(r.predicted_mask, single.predicted_mask,
                                   atol=1e-5)
    assert server.stats["requests"] == 8
    assert server.mean_batch_size > 1.0
