"""``BENCHMARK.json`` and the files it names: each configuration, mix,
driver, metric reader and limit is found by its name alone, and the names,
units and metric lists keep to the benchmark's rules."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert harness.driver_class(c).__name__ == "Driver"
    assert c.limits and all(v >= 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_names_units_and_keys():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = harness.load_cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_per_layer_cells_report_what_the_metric_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"video runner", "transmission hop and stream engine", "pipeline",
                           "kernels", "device"}


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
