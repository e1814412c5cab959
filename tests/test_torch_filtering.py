"""The port's filter chain and metadata CLI (`s3od_torch/datagen/
{filtering,filters,run_filtering,generate_metadata}.py`) against the JAX
package's, on the CPU.

- The three filters through both `run_filtering` CLIs on the same
  class-organised set, the heuristics first so that each filter rejects
  something (the flip filter, run first, rejects all the others would):
  the same pass/fail per sample and filter, reasons, scores (IoUs within
  1e-6: the two predictors' fp32 masks are thresholded, so an IoU moves
  only if a pixel flips), output and failure-panel file names, stats.
- The flip filter on `tests/fixture/tiny_s3od.npz` (float32, 128 canvas)
  alone, with every metadata IoU.
- The artifact heuristic counts 8-connected components: a mask whose two
  parts touch only at a corner is one component, as OpenCV (the JAX
  filter's branch here) counts it.
- `run_filtering`'s `--task_id/--num_tasks` sharding and its resume; the
  offline `generate_metadata` JSON equal to the JAX package's.
The VLM filters run their heuristics: their model ids name no local
directory, so nothing is downloaded.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixture"
NO_VLM = "/nonexistent-vlm"


def _write_class_set(root: Path) -> Path:
    """Two classes of image/mask pairs from the fixture photo: the true
    mask (the tiny model agrees with it), its flip, an inverted mask (the
    flip filter rejects it), a near-empty mask (semantic coverage rejects
    it), a fragmented mask (the artifact heuristic rejects it) and a mask
    of two blobs touching at a corner (one 8-connected component)."""
    img = np.array(Image.open(FIXTURE / "image.jpg").convert("RGB"))
    mask = np.array(Image.open(FIXTURE / "mask.png").convert("L"))
    h, w = mask.shape
    frag = np.zeros_like(mask)
    for y in range(8, h - 8, 40):
        for x in range(8, w - 8, 40):
            frag[y: y + 12, x: x + 12] = 255
    corner = np.zeros_like(mask)
    corner[100:240, 100:240] = 255
    corner[240:380, 240:380] = 255
    near_empty = np.zeros_like(mask)
    near_empty[:4, :4] = 255
    pairs = {
        "cat_a": [("000", img, mask), ("001", img[:, ::-1], mask[:, ::-1]),
                  ("002", img, 255 - mask)],
        "dog_b": [("000", img, near_empty), ("001", img, frag),
                  ("002", img, corner), ("003", img, mask)],
    }
    for cls, items in pairs.items():
        (root / cls / "images").mkdir(parents=True)
        (root / cls / "masks").mkdir(parents=True)
        for sid, im, m in items:
            Image.fromarray(np.ascontiguousarray(im)).save(
                root / cls / "images" / f"{sid}.jpg", quality=95)
            Image.fromarray(np.ascontiguousarray(m)).save(
                root / cls / "masks" / f"{sid}.png")
    return root


def _config(tmp: Path, tag: str, port: bool, **extra) -> Path:
    flip = {"type": "flip_consistency",
            "model_path": str(FIXTURE / "tiny_s3od.npz"),
            "image_size": 128, "batch_size": 3}
    vlm = {"model_id": NO_VLM}
    if port:
        flip.update(device="cpu")
        vlm.update(device="cpu")
    cfg = {"input_dir": str(tmp / "set"),
           "output_dir": str(tmp / tag / "out"),
           "failed_dir": str(tmp / tag / "failed"),
           "filters": [{"type": "semantic_quality", **vlm},
                       {"type": "mask_artifacts", **vlm}, flip], **extra}
    path = tmp / f"{tag}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both CLIs over the same set, with the filters' per-sample results
    recorded through `BaseFilter.record`."""
    from s3od_tpu.datagen import filtering as jf
    from s3od_tpu.datagen import run_filtering as jrun
    from s3od_torch.datagen import filtering as tf
    from s3od_torch.datagen import run_filtering as trun

    tmp = tmp_path_factory.mktemp("chain")
    _write_class_set(tmp / "set")
    out = {}
    for tag, mod, run in (("jax", jf, jrun), ("port", tf, trun)):
        seen = []
        orig = mod.BaseFilter.record

        def record(self, results, _orig=orig, _seen=seen):
            _seen.extend((self.name, r) for r in results)
            return _orig(self, results)

        mod.BaseFilter.record = record
        try:
            stats = run.main(["--config", str(_config(tmp, tag,
                                                      tag == "port"))])
        finally:
            mod.BaseFilter.record = orig
        out[tag] = (stats, seen)
    return tmp, out


def test_chain_matches_jax(chain):
    tmp, out = chain
    (jstats, jseen), (stats, seen) = out["jax"], out["port"]
    assert stats == jstats
    assert stats["kept"] >= 1 and set(stats["rejected"]) == {
        "horizontal_flip_consistency", "semantic_quality", "mask_artifacts"}
    assert [n for n, _ in seen] == [n for n, _ in jseen]
    for (name, r), (_, ref) in zip(seen, jseen):
        assert (r.passed, r.reason) == (ref.passed, ref.reason), name
        if ref.score is None:
            assert r.score is None
        else:
            assert abs(r.score - ref.score) <= 1e-6, name
        if ref.metadata is None:  # the empty-mask verdict
            assert r.metadata == {"heuristic": True}
            continue
        assert set(r.metadata) == set(ref.metadata)
        for k, v in ref.metadata.items():
            if isinstance(v, float):
                assert abs(r.metadata[k] - v) <= 1e-6, (name, k)
            else:
                assert r.metadata[k] == v, (name, k)
    assert _tree(tmp / "port" / "out") == _tree(tmp / "jax" / "out")
    assert _tree(tmp / "port" / "failed") == _tree(tmp / "jax" / "failed")
    kept = json.loads((tmp / "port" / "out" / "filter_stats.json").read_text())
    assert kept["kept"] == stats["kept"]


def test_flip_filter_alone_matches_jax(tmp_path):
    from s3od_tpu.datagen.filters.consistency import (
        HorizontalFlipConsistencyFilter as JFlip,
    )
    from s3od_torch.datagen.filtering import DatasetLoader
    from s3od_torch.datagen.filters import HorizontalFlipConsistencyFilter

    samples = DatasetLoader(str(_write_class_set(tmp_path))).load_samples()
    model = str(FIXTURE / "tiny_s3od.npz")
    got = HorizontalFlipConsistencyFilter(
        model, image_size=128, device="cpu").filter_batch(samples)
    ref = JFlip(model, image_size=128).filter_batch(samples)
    assert [r.passed for r in got] == [r.passed for r in ref]
    assert any(r.passed for r in got) and not all(r.passed for r in got)
    for a, b in zip(got, ref):
        for k, v in b.metadata.items():
            assert abs(a.metadata[k] - v) <= 1e-6, k


def test_flip_filter_defaults_to_the_card():
    from s3od_torch.datagen.filters import HorizontalFlipConsistencyFilter

    f = HorizontalFlipConsistencyFilter(str(FIXTURE / "tiny_s3od.npz"))
    assert f.device == "cuda" and f._predictor is None


def test_corner_contact_is_one_component():
    import cv2

    from s3od_torch.datagen.filters.vlm import components_8

    m = np.zeros((40, 40), np.uint8)
    m[5:15, 5:15] = 1
    m[15:25, 15:25] = 1  # touches the first only at (14, 14)-(15, 15)
    m[30:34, 30:34] = 1
    n, areas = components_8(m)
    n_cv, _, stats, _ = cv2.connectedComponentsWithStats(m)
    assert n == n_cv == 3
    assert areas == sorted(stats[1:, cv2.CC_STAT_AREA], reverse=True)
    assert areas == [200, 16]


def test_run_filtering_shards_and_resumes(tmp_path):
    """Two tasks split the samples contiguously (the last takes the rest)
    and together keep what one task keeps; a rerun finds everything done.
    The JAX CLI gives the same stats per task."""
    from s3od_tpu.datagen import run_filtering as jrun
    from s3od_torch.datagen import run_filtering as trun

    _write_class_set(tmp_path / "set")
    for tag, run, port in (("jax", jrun, False), ("port", trun, True)):
        cfg = _config(tmp_path, tag, port)
        shards = [run.main(["--config", str(cfg), "--task_id", str(t),
                            "--num_tasks", "2"]) for t in (0, 1)]
        assert [s["input"] for s in shards] == [3, 4]
        again = run.main(["--config", str(cfg)])
        assert again["input"] == 7 - sum(s["kept"] for s in shards)
        if tag == "jax":
            ref = (shards, again)
        else:
            assert (shards, again) == ref
    assert _tree(tmp_path / "port" / "out") == _tree(tmp_path / "jax" / "out")


def test_generate_metadata_offline_matches_jax(tmp_path):
    from s3od_tpu.datagen import generate_metadata as jgm
    from s3od_torch.datagen import generate_metadata as tgm

    ds = tmp_path / "in" / "DUTS-TE"
    (ds / "images").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for stem in ("golden_retriever_12", "sun_flower-3", "4711"):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
                        ).save(ds / "images" / f"{stem}.png")
    assert tgm.resolve_datasets("sod") == jgm.resolve_datasets("sod")
    assert tgm.resolve_datasets("a, b") == ["a", "b"]
    for tid, n in ((0, 1), (1, 2)):
        jgm.process_dataset(ds, tmp_path / "jax" / "DUTS-TE",
                            jgm.MetadataGenerator(NO_VLM), tid, n)
        tgm.process_dataset(ds, tmp_path / "port" / "DUTS-TE",
                            tgm.MetadataGenerator(NO_VLM, "cpu"), tid, n)
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port") and len(files) == 4
    for f in files:
        assert (json.loads((tmp_path / "port" / f).read_text())
                == json.loads((tmp_path / "jax" / f).read_text()))
    tags = json.loads((tmp_path / "port" / "DUTS-TE" / "tags.json").read_text())
    assert sorted(t["tag"] for t in tags) == ["golden retriever", "object",
                                              "sun flower"]
    # the CLI over a dataset group, resumed: nothing is duplicated
    shutil.copytree(ds, tmp_path / "in" / "ECSSD")
    args = ["--input_dir", str(tmp_path / "in"), "--output_dir",
            str(tmp_path / "cli"), "--datasets", "DUTS-TE,ECSSD",
            "--model_id", NO_VLM, "--device", "cpu"]
    tgm.main(args)
    tgm.main(args)
    caps = json.loads((tmp_path / "cli" / "ECSSD" / "captions.json").read_text())
    assert len(caps) == 3
