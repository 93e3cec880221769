"""The PAL delay-line reference (``portbench/reference/pal.py``) against the
port's ``plain`` backend at a tiny size on the CPU, the control far from
it, and the reference taking nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import ALL_STANDARDS
from portbench.reference import CONTROL, REFERENCE, Reference
from portbench.scene import Scene

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CFG = json.loads((HERE.parent / "configs" / "pal-delayline.json").read_text())
#: the plain backend is float32, the reference float64: measured 2.2e-7 to
#: 3.5e-7 at 16 and 576 lines, the other configurations' bound
AGREE = 5e-6


def _frames(lines=16, seed=2**31 + 3):
    return Scene(lines, CFG["samples"], seed, "cpu").frames(5, 2)


@pytest.mark.parametrize("backend", ["plain", "kernel"])
@pytest.mark.parametrize("f0", [123457, 1_600_000])
def test_reference_agrees_with_the_port_on_the_cpu(f0, backend):
    """Frame 123457, and frame 1.6 million, whose lines lie near 10^9 as the
    window's last calls' do: the carrier's exact modular phase far from
    frame 0.  The kernel backend on the CPU runs the delay-line pass's plain
    composition."""
    rgb = _frames()
    plan = make_plan(ALL_STANDARDS[CFG["standard"]](), CFG["samples"])
    out = make_pipeline(plan, CFG["decoder"], backend, "cpu")[2](rgb, f0)
    ref = Reference(CFG).roundtrip(rgb.to(torch.float64), [f0, f0 + 1])
    assert float((out.to(torch.float64) - ref).abs().max()) <= AGREE


def test_reference_averages_with_the_line_before():
    """Chroma added to line 1 alone reaches lines 0 (its reflection), 1 and
    2 of the decoded picture, and no other line."""
    ref = Reference(CFG)
    rgb = torch.full((1, 3, 6, CFG["samples"]), 0.5, dtype=torch.float64)
    comp = ref.modem.encode(ref.plan, rgb, [0], REFERENCE)
    flat = ref.modem.decode(ref.plan, comp, [0], "delayline", REFERENCE)
    comp[:, 1] += 0.2 * torch.cos(torch.arange(CFG["samples"], dtype=torch.float64) * 2.06)
    moved = (ref.modem.decode(ref.plan, comp, [0], "delayline", REFERENCE) - flat).abs()
    per_line = moved.amax(dim=(0, 1, 3))
    assert per_line[3:].max() < 1e-12 < per_line[:3].min()
    with pytest.raises(NotImplementedError):
        ref.modem.decode(ref.plan, comp, [0], "comb3", REFERENCE)


def test_control_reads_far_from_the_reference():
    """The control (float32 with TF32 products) departs from the float64
    reference by far more than the program does."""
    rgb = _frames()
    ref = Reference(CFG)
    gap = (ref.roundtrip(rgb, [9, 10], CONTROL).to(torch.float64)
           - ref.roundtrip(rgb.to(torch.float64), [9, 10])).abs().max()
    assert float(gap) > 100 * AGREE


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys, torch\n"
        "from portbench.reference import Reference\n"
        "from portbench.scene import Scene\n"
        "cfg = json.load(open('portbench/configs/pal-delayline.json'))\n"
        "x = Scene(8, cfg['samples'], 1, 'cpu').frames(0, 1).double()\n"
        "Reference(cfg).roundtrip(x, [0])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & {"color_modem_tpu_torch", "color_modem_tpu", "jax", "jaxlib"}
