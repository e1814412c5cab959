"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, and the cells of `BENCHMARK.json` cut to a tiny model and tiny
traffic so that a whole run of a driver fits in a test."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 2,
    "intermediate_size": 128, "patch_size": 16, "num_register_tokens": 4,
    "rope_theta": 100.0, "layer_norm_eps": 1e-5, "layerscale_value": 1.0,
    "query_bias": True, "key_bias": False, "value_bias": True,
    "proj_bias": True, "mlp_bias": True, "pos_embed_rescale": 2.0,
    "tap_layers": [1, 2, 3, 4], "neck_channels": [32, 64, 128, 128],
    "features": 32, "num_outputs": 3, "use_bn": True,
    "mask_inter_features": 8, "dtype": "float32",
}
TINY_TEACHER = {**TINY, "flux_dim": 48, "num_concept_channels": 2}

# Each cell's traffic, cut to the tiny model.
TINY_TRAFFIC = {
    "vitb-stream-1024-b16": dict(canvas=128, batch=4, pool=8,
                                 longest_side=[100, 256], warmup_batches=1),
    "vitb-latency-2048-b1": dict(canvas=128, pool=6, longest_side=[128, 300],
                                 warmup=1),
    "teacher-train-1024-b1": dict(buckets=[[128, 128], [96, 160], [160, 96]],
                                  warmup_steps=3),
    "vitb-train-1024-b4": dict(pool=3, batch=2, size=128, warmup_steps=3),
}


def tiny_spec(name: str, dtype: str = "float32", sample: int = 3) -> dict:
    """The cell `name` as `perfbench.core.cell` gives it, with the tiny
    model (in `dtype`) and traffic, its own limits kept."""
    from perfbench import core

    spec = copy.deepcopy(core.cell(name))
    teacher = bool(spec["config"].get("flux_dim"))
    spec["config"] = {**(TINY_TEACHER if teacher else TINY), "dtype": dtype}
    w = spec["workload"]
    w["traffic"].update(TINY_TRAFFIC[name])
    w["trace_seconds"] = 1
    if "sample" in w["check"]:
        w["check"]["sample"] = sample
    return spec


@pytest.fixture
def spec_of():
    return tiny_spec
