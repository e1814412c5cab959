"""The benchmark's count of the models' work."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, TINY, TINY_TEACHER
from perfbench import flops, inputs
from perfbench.reference import model as ref


def test_vitb_1024_by_hand():
    cfg = json.loads((ROOT / "perfbench/configs/s3od-dinov3-vitb16-dpt.json").read_text())
    n = 1 + 4 + 64 * 64                         # CLS, registers, patches
    c, f = 768, 3072
    block = 2 * n * (4 * c * c + 2 * c * f) + 4 * n * n * c
    encoder = 2 * 4096 * c * 3 * 16 * 16 + 11 * block
    assert flops.encoder_flops(cfg, 1024, 1024) == encoder
    # The decoder's heaviest convs: the mask head at 1024^2 and 512^2.
    total = flops.forward_flops(cfg, 1024, 1024)
    assert 1.5e12 < total < 2.5e12
    assert flops.train_step_flops(cfg, 1024, 1024, 4) == 12 * total


@pytest.mark.parametrize("hw", [(128, 96), (112, 176)])
@pytest.mark.parametrize("teacher", [False, True])
def test_counts_match_the_reference_products(hw, teacher):
    cfg = TINY_TEACHER if teacher else TINY
    sd = inputs.state_dict(cfg, 1, "cpu")
    h, w = hw
    x = torch.randn(1, h, w, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        if teacher:
            ph, pw = h // 16, w // 16
            feats = [torch.randn(1, ph * pw, cfg["flux_dim"]) for _ in range(4)]
            cm = {"category": torch.rand(1, ph, pw), "background": torch.rand(1, ph, pw)}
            ref.teacher(x, feats, cm, sd, cfg)
        else:
            ref.segmentation(x, sd, cfg)
    assert fc.get_total_flops() == flops.forward_flops(cfg, h, w)


def test_attention_least_time():
    # ViT-B 1024^2 b1: 12 heads x 4101 tokens x 64; bound by its products.
    t = flops.attention_fwd_least_s(12, 4101, 64)
    assert t == pytest.approx(4 * 12 * 4101**2 * 64 / 989e12)
    assert flops.attention_bwd_least_s(12, 4101, 64) == pytest.approx(2.5 * t)
