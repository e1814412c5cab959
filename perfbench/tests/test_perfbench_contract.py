"""`BENCHMARK.json` against the benchmark's contract: names, units,
lengths, the files each entry needs, and which cells report which
metrics."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT
from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"])
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads", "bound",
               "layer", "moves"}
    assert set(m) <= allowed


def test_names_unique_and_valid():
    names = ([m["name"] for m in METRICS] + list(CELLS)
             + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reported(m, cell) for m in BENCH["per_layer"])
    assert (ROOT / "perfbench" / "workloads" / f"{cell}.json").exists()


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in CELLS
        assert reported(moved, cell), (m["name"], cell)
    assert callable(core.metric_reader(m["name"]).read)
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")


def test_layers_named_alike_and_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert layer in perf, layer


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert (ROOT / c["file"]).exists() and c["file"].startswith("perfbench/")
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(c["reduced"]) <= 16


def test_run_budget_fits_24_cells():
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_rooflines_and_mfu_moves_same_metric():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
            twin = [x for x in BENCH["per_layer"] if "mfu" in x["name"]
                    and x["moves"] == m["moves"]]
            assert twin, m["name"]
