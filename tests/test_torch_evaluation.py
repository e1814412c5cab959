"""s3od_torch evaluation on the CPU: `SODPredictor` against the JAX
`SODPredictor` (predict and predict_batch, at a patch-multiple canvas and
at one that the encoder crops), and `compute_metrics.evaluate_datasets` /
its CLI against the JAX metrics on a tiny synthetic dataset directory."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from s3od_torch.evaluation import compute_metrics as tcm
from s3od_torch.evaluation.predictor import PredictionResult, SODPredictor

FIXTURE = Path(__file__).parent / "fixture"
TINY = FIXTURE / "tiny_s3od.npz"


def _images():
    image = np.array(Image.open(FIXTURE / "image.jpg").convert("RGB"))
    return [image, image[:, ::-1][40:, :200].copy(),
            np.ascontiguousarray(image[::2, ::3].transpose(1, 0, 2))]


@pytest.mark.parametrize("canvas", [128, 136])
def test_sod_predictor_matches_jax(canvas):
    """136 is not a patch multiple: both crop it to 8 patches (128 px),
    as 840 -> 52 patches on the real canvas."""
    from s3od_tpu.evaluation.predictor import SODPredictor as JaxSODPredictor

    got = SODPredictor(str(TINY), image_size=canvas, device="cpu")
    ref = JaxSODPredictor(str(TINY), image_size=canvas, dtype="float32")
    images = _images()
    one, one_ref = got.predict(images[0]), ref.predict(images[0])
    batch, batch_ref = got.predict_batch(images), ref.predict_batch(images)
    for g, r, im in zip([one] + batch, [one_ref] + batch_ref,
                        images[:1] + images):
        assert isinstance(g, PredictionResult)
        assert g.soft_mask.shape == im.shape[:2]
        assert g.num_masks == r.num_masks == 3
        np.testing.assert_allclose(g.soft_mask, r.soft_mask, atol=1e-4)
        np.testing.assert_allclose(g.all_ious, r.all_ious, atol=1e-4)
        # binary masks: equal but where the soft mask sits at 0.5
        assert (g.all_masks != r.all_masks).mean() < 1e-3
        assert set(np.unique(g.all_masks)) <= {0.0, 1.0}


def _dataset(root: Path) -> Path:
    mask = np.array(Image.open(FIXTURE / "mask.png").convert("L"))
    ds = root / "DS"
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir()
    image = np.array(Image.open(FIXTURE / "image.jpg").convert("RGB"))
    for i, (im, m) in enumerate([(image, mask),
                                 (image[:, ::-1], mask[:, ::-1]),
                                 (image[30:, 20:], mask[30:, 20:])]):
        Image.fromarray(np.ascontiguousarray(im)).save(ds / "images" / f"{i}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(ds / "masks" / f"{i}.png")
    return root


def test_evaluate_datasets_matches_jax_metrics(tmp_path):
    """Every metric within 1e-3 of the JAX pipeline's (the soft masks agree
    to ~1e-5; the threshold sweeps can move by one pixel's weight)."""
    from s3od_tpu.evaluation import compute_metrics as jcm

    root = _dataset(tmp_path)
    kw = dict(input_dir=str(root), datasets=["DS", "MISSING"], image_size=128,
              batch=2, compute_best_metrics=True)
    got = tcm.evaluate_datasets(model_path=str(TINY), device="cpu", **kw)
    ref = jcm.evaluate_datasets(model_path=str(TINY), **kw)
    assert set(got) == set(ref) == {"DS"}
    for part in ("pred_metrics", "best_metrics"):
        g, r = got["DS"][part], ref["DS"][part]
        assert set(g) == set(r) and len(g) >= 6
        for name in r:
            assert abs(g[name] - r[name]) <= 1e-3, (part, name, g[name], r[name])
    assert got["DS"]["pred_metrics"]["Sm"] > 0.8  # the trained checkpoint


def test_compute_metrics_cli_writes_json(tmp_path):
    root = _dataset(tmp_path)
    out = tmp_path / "metrics.json"
    res = tcm.main(["--input_dir", str(root), "--model_path", str(TINY),
                    "--image_size", "128", "--datasets", "DS",
                    "--device", "cpu", "--output_json", str(out)])
    assert out.exists() and "DS" in res and "MAE" in res["DS"]


def test_evaluate_datasets_2048_defaults_to_batch1(tmp_path, monkeypatch):
    """batch=None picks 1 at >= 2048 canvases and 4 below, and the torch
    SODPredictor gets the canvas and the device."""
    seen = {}

    class FakePredictor:
        def __init__(self, path, image_size, device):
            seen.update(image_size=image_size, device=device)

    def fake_process(data_dir, predictor, best, batch, progress=True):
        seen["batch"] = batch
        return {}

    monkeypatch.setattr(tcm, "SODPredictor", FakePredictor)
    monkeypatch.setattr(tcm, "process_dataset", fake_process)
    (tmp_path / "DS" / "images").mkdir(parents=True)
    for size, batch in ((2048, 1), (1024, 4)):
        tcm.evaluate_datasets(model_path="x.npz", input_dir=str(tmp_path),
                              datasets=["DS"], image_size=size, device="cpu")
        assert seen == {"image_size": size, "device": "cpu", "batch": batch}
