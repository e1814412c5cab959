"""The port's spans (`s3od_torch.profiling.span`): nothing opened without a
profiler; under one, the training step's phases in order, the RoPE tables
inside the forward, K2's, K4's and K5's vjp spans outside the remat
replay; and `_build.launch`'s span and launch count.

Spans are read back from the profiler's Chrome trace, as the benchmark
reads them (`user_annotation` events)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from s3od_torch import _build
from s3od_torch.configs import tiny_test_config
from s3od_torch.models.segmentation import S3ODSegmentation
from s3od_torch.training.loss import LOSS_PRESETS, LossModule
from s3od_torch.training.optim import Optimizer
from s3od_torch.training.train_step import train_step

MICRO_PHASES = ("s3od.train.preprocess", "s3od.train.forward",
                "s3od.train.loss", "s3od.train.backward",
                "s3od.train.metrics")


def _tiny_trainer(pos_embed_rescale=2.0):
    cfg = tiny_test_config(num_layers=2)
    cfg = dataclasses.replace(
        cfg, tap_layers=(1, 2, 2, 2),
        encoder=dataclasses.replace(cfg.encoder,
                                    pos_embed_rescale=pos_embed_rescale))
    torch.manual_seed(0)
    model = S3ODSegmentation(cfg)
    opt = Optimizer(model, 1e-4, steps_per_epoch=10)
    return model, opt, LossModule(LOSS_PRESETS["focal_iou"])


def _batch(n=4, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(
                rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)),
            "masks": torch.from_numpy(
                (rng.random((n, size, size)) > 0.6).astype(np.uint8) * 255)}


def _spans(prof, tmp_path, prefix="s3od."):
    """The trace's `prefix` ranges as (name, start, end), in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(prefix)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def test_span_opens_nothing_without_a_profiler(monkeypatch):
    """With no profiler recording, a training step (RoPE rescale, so the
    tables' span is reached too) opens none of the port's ranges: a
    `record_function` of an `s3od.` name would raise."""
    real = torch.autograd.profiler.record_function
    opened = []

    def guard(name, *args, **kwargs):
        if name.startswith("s3od."):
            opened.append(name)
            raise AssertionError(f"span {name} opened without a profiler")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", guard)
    monkeypatch.setattr(torch.profiler, "record_function", guard)
    model, opt, loss = _tiny_trainer()
    out = train_step(model, opt, loss, _batch(), 0, 0,
                     generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out["loss"])
    assert opened == []


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans_under_the_profiler(tmp_path, accum):
    """Two steps under a CPU profiler: one `s3od.train.step` each, holding
    per micro-batch preprocess, forward (with the rescaled step's RoPE
    tables inside), loss, backward and metrics in that order, then one
    optimizer span."""
    model, opt, loss = _tiny_trainer()
    gen = torch.Generator().manual_seed(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for step in range(2):
            train_step(model, opt, loss, _batch(seed=step), 0, step,
                       generator=gen, accum_steps=accum)
    spans = _spans(prof, tmp_path)
    steps = [s for s in spans if s[0] == "s3od.train.step"]
    assert len(steps) == 2
    for name, a, b in steps:
        inside = [s for s in spans if a <= s[1] and s[2] <= b and s[0] != name]
        phases = [s for s in inside if s[0].startswith("s3od.train.")]
        # preprocess runs once, over the whole batch, before the split
        expected = (["s3od.train.preprocess"]
                    + list(MICRO_PHASES[1:]) * accum + ["s3od.train.optimizer"])
        assert [s[0] for s in phases] == expected
        for i in range(1, len(phases)):  # in order, not overlapping
            assert phases[i - 1][2] <= phases[i][1]
        tables = [s for s in inside if s[0] == "s3od.encoder.rope_tables"]
        forwards = [s for s in phases if s[0] == "s3od.train.forward"]
        assert len(tables) == accum
        for (_, ta, tb), (_, fa, fb) in zip(tables, forwards):
            assert fa <= ta and tb <= fb


def test_unscaled_rope_tables_open_no_span(tmp_path):
    """Without RoPE rescale the cached tables serve the forward: no
    `s3od.encoder.rope_tables` span."""
    model, opt, loss = _tiny_trainer(pos_embed_rescale=None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(model, opt, loss, _batch(), 0, 0,
                   generator=torch.Generator())
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("s3od.train.forward") == 1
    assert "s3od.encoder.rope_tables" not in names


def test_launch_scope_counts_and_opens_the_kernel_span(tmp_path):
    """`_build.launch` adds one launch per exit without an exception and
    opens `s3od.kernel.<wrapper name>` under a profiler; a raise inside
    leaves the count as it was."""

    def stand_in():
        pass

    stand_in.launches = 0
    with _build.launch(stand_in):
        torch.ones(4).sum()
    assert stand_in.launches == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _build.launch(stand_in):
            torch.ones(4).mul(2)
        with pytest.raises(RuntimeError, match="launch failed"):
            with _build.launch(stand_in):
                raise RuntimeError("launch failed")
    assert stand_in.launches == 2
    names = [s[0] for s in _spans(prof, tmp_path, "s3od.kernel.")]
    assert names == ["s3od.kernel.stand_in"] * 2


def test_vjp_spans_hold_the_backwards_not_the_remat_replay(tmp_path):
    """The encoder's kernel route (float32 on the CPU, per-block remat)
    under a profiler: each block's K2, K4 and K5 backward opens its
    `s3od.vjp.<op>` span once, and the block's replayed forward (run at
    the first unpack of a saved tensor, in K5's backward) lies outside
    every such span."""
    model, _, _ = _tiny_trainer()
    taps = model.cfg.tap_layers
    blocks = max(taps)
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = model.encoder(images, taps, "kernel", remat=True)
        sum(o.square().sum() for o in outs).backward()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    vjps = [e for e in events if e["name"].startswith("s3od.vjp.")]
    assert sorted({e["name"] for e in vjps}) == [
        "s3od.vjp.attn_epilogue", "s3od.vjp.mlp_fused",
        "s3od.vjp.qkv_project_rope"]
    for name in {e["name"] for e in vjps}:
        assert sum(e["name"] == name for e in vjps) == blocks, name
    forwards = [e for e in events
                if e["name"] in ("_LayerNorm", "_QKVProjectRope",
                                 "_AttnEpilogue", "_MLPFused")]
    # the forward once and its replay once a block
    assert len(forwards) == 2 * 4 * blocks
    for f in forwards:
        for v in vjps:
            assert not (v["ts"] <= f["ts"] < v["ts"] + v["dur"]), (f["name"], v["name"])
