"""A run of the harness in a process of its own: its last line's keys, and
no module of JAX or of the JAX package loaded; and the command refuses a
machine without the cards a cell asks for."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("cell", ["ntsc-comb3.batch64", "ntsc-comb3.video-rf"])
def test_small_run_prints_the_line_and_loads_no_jax(cell, trace):
    cmd = [sys.executable, "-m", "portbench.tests.small", cell] + (["--trace"] if trace else [])
    out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
                         check=True)
    line, mods = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "breakdown" not in line
    assert line["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    c = harness.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    assert mods["forbidden"] == []


def test_command_refuses_without_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ntsc-comb3.batch64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_refuses_to_start_without_tmpdir(monkeypatch):
    monkeypatch.delenv("TMPDIR", raising=False)
    with pytest.raises(RuntimeError, match="TMPDIR"):
        harness.scratch_dir()
