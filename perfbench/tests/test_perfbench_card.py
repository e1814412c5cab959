"""On the card only: a short run of every cell, through `run.py` in its
own process, prints a correct result line with the cell's metrics.
Skipped without a CUDA card (decided inside the fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", cell, "--seed", str(2**31 + 901),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert "setup_s" in line["metrics"] and line["device"]["platform"] == "gpu"
