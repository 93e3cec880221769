"""Randomised-input robustness sweep of the port, under the sanitizer.

The sweeps of ``tests/test_fuzz.py`` on the port's pipelines (CPU, the
kernel backend's plain versions): random band-limited scenes and hostile
uniform-noise images through every standard's flagship decoders, and
flat extremes, each round trip wrapped in
``utils/debug.py::checked`` (the port's counterpart of the
``jax_debug_nans`` switch the JAX tests run under), so a NaN or an
infinity fails loudly, and each above the JAX sweep's loose floors.  The
floors catch catastrophic breakage, not quality (the round-trip tests
pin that).  Then ``checked`` itself, as ``tests/test_debug.py`` checks
the JAX one: it passes a clean round trip and raises on a NaN put into a
composite.
"""

import numpy as np
import pytest
import torch

from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import ALL_STANDARDS
from color_modem_tpu_torch.standards.decoders import allowed_decoders
from color_modem_tpu_torch.utils.debug import checked
from color_modem_tpu_torch.utils.metrics import psnr
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

L, N = 32, 720
SMOOTH_FLOOR = 24.0   # tests/test_fuzz.py
NOISE_FLOOR = 10.0
FLAT_FLOOR = 20.0
_PLANS = {}


def _roundtrip(name, decoder):
    if name not in _PLANS:
        _PLANS[name] = make_plan(ALL_STANDARDS[name](), N)
    return checked(make_pipeline(_PLANS[name], decoder, device="cpu")[2])


def _flagship_cases():
    for name, factory in ALL_STANDARDS.items():
        decs = allowed_decoders(factory())
        # the first (simplest) and the best non-temporal decoder
        for d in sorted({decs[0], "comb3" if "comb3" in decs else decs[-1]}):
            if d not in ("comb3d", "comb3dA"):
                yield name, d


@pytest.mark.parametrize("seed", [11, 23])
def test_fuzz_smooth_scenes_all_standards(seed):
    rng = np.random.default_rng(seed)
    for name, decoder in _flagship_cases():
        x = torch.tensor(np.stack([smooth_scene(L, N, seed=int(rng.integers(1 << 30)))
                                   for _ in range(2)]), dtype=torch.float32)
        out = _roundtrip(name, decoder)(x, int(rng.integers(64)))
        p = psnr(out, x)
        assert p > SMOOTH_FLOOR, f"{name}/{decoder}: {p:.1f} dB"


def test_fuzz_hostile_noise_images():
    rng = np.random.default_rng(7)
    for name in ("ntsc", "pal", "secam"):
        x = torch.tensor(rng.random((1, 3, L, N)), dtype=torch.float32)
        out = _roundtrip(name, allowed_decoders(ALL_STANDARDS[name]())[0])(x, 0)
        p = psnr(out, x)
        assert p > NOISE_FLOOR, f"{name}: {p:.1f} dB on noise image"


def test_fuzz_extreme_flat_inputs():
    """All black, all white and saturated red: every flagship decoder comes
    back finite and close to the input (flats hold no detail to lose)."""
    flats = {"black": torch.zeros(1, 3, L, N), "white": torch.ones(1, 3, L, N),
             "red": torch.zeros(1, 3, L, N)}
    flats["red"][:, 0] = 1.0
    for name, decoder in _flagship_cases():
        rt = _roundtrip(name, decoder)
        for tag, x in flats.items():
            p = psnr(rt(x, 0)[..., 8:-8], x[..., 8:-8])  # edge ringing allowed
            assert p > FLAT_FLOOR, f"{name}/{decoder}/{tag}: {p:.1f} dB"


def test_checked_passes_clean_pipeline():
    _, _, rt = make_pipeline(make_plan(ALL_STANDARDS["secam"](), N), "notch", device="cpu")
    rgb = torch.tensor(smooth_scene(64, N, seed=7)[None], dtype=torch.float32)
    out = checked(rt)(rgb, 0)
    assert torch.equal(out, rt(rgb, 0))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_checked_raises_on_a_bad_composite(bad):
    """A NaN (or an infinity) put into one composite sample reaches the
    decoded RGB, and ``checked`` names the output that holds it."""
    enc, dec, _ = make_pipeline(make_plan(ALL_STANDARDS["ntsc"](), N), "comb3", device="cpu")
    comp = enc(torch.tensor(smooth_scene(L, N, seed=1)[None], dtype=torch.float32), 0).clone()
    assert torch.isfinite(checked(dec)(comp, 0)).all()
    comp[0, 5, 100] = bad
    with pytest.raises(FloatingPointError, match=r"decode: output holds a NaN"):
        checked(dec)(comp, 0)


def test_checked_walks_nested_outputs():
    def pair(x):
        return x, {"y": [x.double(), x * torch.tensor(float("nan"))]}, "text", 3

    with pytest.raises(FloatingPointError, match=r"output\[1\]\['y'\]\[1\]"):
        checked(pair)(torch.ones(4))
    assert checked(lambda x: (x, x.int()))(torch.ones(4))[1].dtype == torch.int32
