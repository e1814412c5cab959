"""Whole runs of the harness on the CPU at the tiny model (float32, so a
sound run agrees with the reference to rounding): `run.py` refuses to run
without a card; a sound run is `correct`; the program broken underneath
(an answer altered where it is made, half of the batch left out, a state
left unchanged) makes it not correct; and the control, the reference in
float8 in the program's place, fails the cell's limits."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, tiny_spec
from perfbench import checks
from perfbench.reference import model as ref_model
from perfbench.run import run_cell

SEED = 2**31 + 77
SERVING = ["vitb-stream-1024-b16", "vitb-latency-2048-b1"]
TRAINING = ["vitb-train-1024-b4", "teacher-train-1024-b1"]


@pytest.fixture(autouse=True)
def numpy_letterbox(monkeypatch):
    # The port's host resize without OpenCV: the rule the reference writes
    # out, so a sound float32 run agrees with it to rounding.
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_run_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", "vitb-stream-1024-b16", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0
    assert not any(l.startswith("{") for l in p.stdout.splitlines())


def run(name, **kw):
    spec = tiny_spec(name, **kw)
    return run_cell(spec, SEED, 1.0, False, "cpu")


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_sound_run_is_correct(name):
    line = run(name, sample=40)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def alter_answer(monkeypatch):
    import s3od_torch.predictor as P

    real = P._postprocess

    def altered(image, pad_info, masks, ious):
        return real(image, pad_info, np.ascontiguousarray(masks[:, ::-1]), ious)

    monkeypatch.setattr(P, "_postprocess", altered)
    real_best = P._postprocess_best

    def altered_best(image, pad_info, mask, ious):
        return real_best(image, pad_info, np.ascontiguousarray(mask[::-1]), ious)

    monkeypatch.setattr(P, "_postprocess_best", altered_best)


@pytest.mark.parametrize("name", SERVING)
def test_trace_run_without_the_hooked_modules_reads_them_absent(name, monkeypatch):
    # A program whose model has no `encoder` or `seg_head` attribute: the
    # traced run still ends and is judged, with no range to read (on the
    # card the two ranged readings are then left out, never 0).
    import torch
    from perfbench import program

    real = program.predictor

    def renamed(model, image_size, dtype):
        pred = real(model, image_size, dtype)
        pred.model = torch.nn.Module()  # serving runs on its replicas
        return pred

    monkeypatch.setattr(program, "predictor", renamed)
    line = run_cell(tiny_spec(name, sample=3), SEED, 1.0, True, "cpu")
    names = set(line["metrics"])
    suffix = ".serve" if "stream" in name else ".latency"
    assert "encoder_device_ms" + suffix not in names
    assert "decoder_device_ms" + suffix not in names
    assert line["correct"], line["checks"]


def half_batch_serving(monkeypatch):
    import s3od_torch.predictor as P

    real = P.serving_forward

    def half(model_fn, x_u8, *a, **k):
        b = x_u8.shape[0]
        keep = x_u8[: max(1, b // 2)]
        masks, ious = real(model_fn, keep, *a, **k)
        rep = lambda t: t.repeat((-(-b // t.shape[0]),) + (1,) * (t.dim() - 1))[:b]
        return rep(masks), rep(ious)

    monkeypatch.setattr(P, "serving_forward", half)


@pytest.mark.parametrize("name", SERVING)
def test_altered_answer_is_not_correct(name, monkeypatch):
    alter_answer(monkeypatch)
    assert not run(name, sample=40)["correct"]


def test_half_batch_serving_is_not_correct(monkeypatch):
    half_batch_serving(monkeypatch)
    assert not run("vitb-stream-1024-b16", sample=40)["correct"]


@pytest.mark.parametrize("name", TRAINING)
def test_unchanged_state_is_not_correct(name, monkeypatch):
    import torch
    from s3od_torch.training import optim

    real = optim.Optimizer.step

    def unchanged(self, step):
        # The update runs (its moments are kept) but the parameters are
        # handed back as they were.
        before = [p.detach().clone() for p in self.model.parameters()]
        real(self, step)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)

    monkeypatch.setattr(optim.Optimizer, "step", unchanged)
    line = run(name)
    assert not line["correct"]
    assert line["checks"]["update_group_med"]["value"] > 0.9  # nothing moved


@pytest.mark.parametrize("name", TRAINING)
def test_head_group_left_unchanged_is_not_correct(name, monkeypatch):
    import torch
    from s3od_torch.training import optim

    real = optim.Optimizer.step

    def frozen_head(self, step):
        # The encoder's group updates; every other parameter (the head
        # group, about a third of the leaves) is handed back unmoved.
        head = self.torch_optimizer.param_groups[1]["params"]
        before = [p.detach().clone() for p in head]
        real(self, step)
        with torch.no_grad():
            for p, b in zip(head, before):
                p.copy_(b)

    monkeypatch.setattr(optim.Optimizer, "step", frozen_head)
    line = run(name)
    assert not line["correct"]
    assert line["checks"]["update_group_med"]["value"] > 0.9


def test_half_batch_training_is_not_correct(monkeypatch):
    from s3od_torch.training import train_step as ts

    real = ts._rows

    def half(tree, a, b):
        ts._rows = real  # the inner calls take whole rows
        try:
            return real(tree, a, a + (b - a) // 2)
        finally:
            ts._rows = half

    monkeypatch.setattr(ts, "_rows", half)
    assert not run("vitb-train-1024-b4")["correct"]


@pytest.mark.parametrize("name", SERVING + TRAINING)
def test_control_fails_the_limits(name):
    from perfbench import calibrate

    spec = tiny_spec(name, sample=4)
    fp8 = ref_model.Numerics(fp8=True)
    if name in SERVING:
        nums = calibrate.serving_control(spec, SEED, "cpu", fp8)
    else:
        nums = calibrate.training_control(spec, SEED, "cpu", fp8)
    assert not checks.judge(nums, spec["workload"]["check"]["limits"]), nums
