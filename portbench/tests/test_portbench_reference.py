"""The plain reference against the port's ``plain`` backend at a tiny size,
for both configurations and through the RF hop; and the reference takes
nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from color_modem_tpu_torch.frame import rf as rf_mod
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import ALL_STANDARDS
from portbench.reference import CONTROL, Reference
from portbench.scene import Scene

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
NAMES = ("ntsc-comb3", "secam-interp")
HOP = {"kind": "rf", "r": 4, "ntaps": 1025}
#: the plain backend is float32; the reference float64.  Measured ~1.4e-6
#: (SECAM's discriminator) and under 1e-6 elsewhere.
AGREE = 5e-6


def _cfg(name):
    return json.loads((HERE.parent / "configs" / f"{name}.json").read_text())


def _frames(cfg, lines=16, seed=2**31 + 3):
    return Scene(lines, cfg["samples"], seed, "cpu").frames(5, 2)


@pytest.mark.parametrize("hop", [None, HOP], ids=["direct", "rf"])
@pytest.mark.parametrize("name", NAMES)
def test_reference_agrees_with_the_plain_backend(name, hop):
    cfg = _cfg(name)
    rgb = _frames(cfg)
    plan = make_plan(ALL_STANDARDS[cfg["standard"]](), cfg["samples"])
    enc, dec, rt = make_pipeline(plan, cfg["decoder"], "plain", "cpu")
    f0 = 123457
    if hop is None:
        out = rt(rgb, f0)
    else:
        rfp = rf_mod.make_rf_plan(plan)
        out = dec(rf_mod.rf_demodulate(rfp, rf_mod.rf_modulate(rfp, enc(rgb, f0), f0), f0), f0)
    ref = Reference(cfg, hop).roundtrip(rgb.to(torch.float64), [f0, f0 + 1])
    assert float((out.to(torch.float64) - ref).abs().max()) <= AGREE


@pytest.mark.parametrize("name", NAMES)
def test_control_reads_far_from_the_reference(name):
    """The control (float32 with TF32 products) departs from the float64
    reference by far more than the program does."""
    cfg = _cfg(name)
    rgb = _frames(cfg)
    ref = Reference(cfg)
    gap = (ref.roundtrip(rgb, [9, 10], CONTROL).to(torch.float64)
           - ref.roundtrip(rgb.to(torch.float64), [9, 10])).abs().max()
    assert float(gap) > 100 * AGREE


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys, torch\n"
        "from portbench.reference import Reference\n"
        "from portbench.scene import Scene\n"
        f"for n in {NAMES!r}:\n"
        "    cfg = json.load(open(f'portbench/configs/{n}.json'))\n"
        f"    r = Reference(cfg, {HOP!r})\n"
        "    x = Scene(8, cfg['samples'], 1, 'cpu').frames(0, 1).double()\n"
        "    r.roundtrip(x, [0])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & {"color_modem_tpu_torch", "color_modem_tpu", "jax", "jaxlib"}
