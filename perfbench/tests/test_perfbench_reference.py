"""The plain reference against the port's float32 CPU path at the tiny
model: a whole request through `BackgroundRemoval`, the teacher's
forward, and three training steps. The reference imports nothing of the
program (this test may import both)."""

from __future__ import annotations

import ast

import pytest
import torch

from conftest import ROOT, TINY, TINY_TEACHER, tiny_spec
from perfbench import checks, inputs, program
from perfbench.reference import model as ref
from perfbench.reference import serve as ref_serve


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".", 1)[0]
                assert top not in ("s3od_torch", "s3od_tpu", "jax", "jaxlib", "flax"), (path, n)
                if top == "perfbench":
                    assert n.startswith("perfbench.reference"), (path, n)


@pytest.mark.parametrize("payload", ["full", "best"])
def test_request_matches_the_port(payload, monkeypatch):
    # Without OpenCV the port resizes on the host by its numpy bilinear,
    # the rule the reference writes out (with OpenCV, cv2's fixed-point
    # resize differs from it by a grey level here and there).
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    sd = inputs.state_dict(TINY, 21, "cpu")
    pred = program.predictor(program.build_model(TINY, sd, "cpu"), 128, "float32")
    pool = inputs.image_pool({"pool": 4, "longest_side": [90, 300],
                              "aspects": ["1:1", "4:3", "3:4", "16:9"]}, 21, "cpu")
    for image in pool:
        res = pred.remove_background(image, payload=payload)
        r = ref_serve.request(image, sd, TINY, 128, "cpu")
        n = checks.serving_summary([checks.serving_numbers(res, image, r, payload)])
        # The best payload rounds the mask to uint8 on the device.
        assert n["mask_rel"] < (1e-4 if payload == "full" else 1e-1), n
        assert n["iou_rms"] < 1e-5 and n["pick"] == 0
        assert n["alpha_gap"] <= 1


def test_teacher_matches_the_port():
    sd = inputs.state_dict(TINY_TEACHER, 5, "cpu")
    model = program.build_model(TINY_TEACHER, sd, "cpu").eval()
    x = torch.randn(2, 128, 96, 3)
    feats = [torch.randn(2, 8 * 6, 48) for _ in range(4)]
    cm = {"category": torch.rand(2, 8, 6), "background": torch.rand(2, 8, 6)}
    with torch.no_grad():
        out = model(x, feats, cm)
        masks, iou = ref.teacher(x, feats, cm, sd, TINY_TEACHER)
    assert (out["pred_masks"] - masks).abs().max() < 1e-5
    assert (out["pred_iou"] - iou).abs().max() < 1e-5
    out = model(x, feats, cm, training=True)
    masks, _ = ref.teacher(x, feats, cm, sd, TINY_TEACHER, training=True)
    assert (out["pred_masks"] - masks).abs().max() < 1e-4


@pytest.mark.parametrize("cell", ["vitb-train-1024-b4", "teacher-train-1024-b1"])
def test_training_steps_match_the_port(cell):
    from perfbench.core import BENCH, load_module

    drv = load_module(BENCH / "drivers" / "train.py", "perfbench_driver_train")
    spec = tiny_spec(cell)
    cfg = spec["config"]
    seed = 2**32 + 3
    sd = inputs.state_dict(cfg, seed, "cpu")
    tr = program.trainer(cfg, program.build_model(cfg, sd, "cpu"),
                         spec["workload"]["recipe"], "float32")
    pool = drv.batches_for(spec, seed, "cpu")
    losses, first = [], []
    hook = tr.model.register_forward_hook(
        lambda m, a, out: first.append((out["pred_masks"].detach(), out["pred_iou"].detach())))
    capture = drv.FirstGradients(tr.model)
    for i in range(3):
        losses.append(tr.step(pool[i], i, drv.rope_seed(seed, i))["loss"].item())
        if i == 0:
            hook.remove()
            g1 = {k: float(v.double().norm())
                  for k, v in program.split_qkv(capture.close()).items()}
    after = program.split_qkv({n: p.detach().clone()
                               for n, p in tr.model.named_parameters()})
    ref_run = drv.reference_steps(spec, seed, "cpu", pool)
    upd = {k: float((after[k] - ref_run["initial"][k]).double().norm())
           for k in ref_run["initial"]}
    n, _ = checks.training_numbers(losses, g1, upd, ref_run, first=first[0])
    assert n["loss_rel"] < 1e-5 and n["fwd_rel"] < 1e-4, n
    assert n["grad_rel"] < 1e-3 and n["update_rel"] < 1e-3, n
