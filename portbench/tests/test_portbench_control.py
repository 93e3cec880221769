"""What decides ``correct`` has to fail where it should: a run with the
control in the program's place (the reference in float32 with TF32
products, one step below the configurations' float32) comes out not
correct, and so does a run with the timed path broken underneath, once for
each fault a cell can have (``portbench/faults.py``).  The harness's look
for a card is skipped (``harness.run`` on the CPU at a small size); on a
card, the control is also run at the cells' own sizes
(``portbench/control.py``)."""

import json

import pytest

from portbench import control, harness
from portbench.tests.small import KEPT, run_ranks, run_small

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
MESH = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1] + list(KEPT)


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_fails_the_limit(cell):
    """The control planted where the program computes, through a whole
    small run of frames of the cell's own height (the widest gap grows with
    the lines compared: SECAM's control reads 1.5e-3 at 16 lines, 0.07 at
    576): its gap lies above the cell's limit."""
    out = run_small(cell, seconds=4.0, fault="control",
                    lines=harness.load_cell(cell).config["lines"])
    gap = out["checks"]["rgb_max_gap"]
    assert not out["result"]["correct"]
    assert gap["value"] is not None and gap["value"] > gap["limit"]


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_sound_small_run_is_correct(cell):
    out = run_small(cell)
    assert out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    out = run_small(cell, fault=fault)
    assert not out["result"]["correct"]
    assert out["result"]["failed"] >= 1


@pytest.mark.parametrize("fault", [None, "no_exchange", "altered"])
@pytest.mark.parametrize("cell", MESH)
def test_mesh_cell_on_four_cpu_ranks(cell, fault):
    out = run_ranks(cell, 4, fault)
    assert out["correct"] == (fault is None), out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_fails_at_the_cells_size_on_the_card(card, cell, seed, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = control.run_control(control.control_cell(harness.load_cell(cell)), seed, 3.0, card)
    assert not out["result"]["correct"], out["checks"]
