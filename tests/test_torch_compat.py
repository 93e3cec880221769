"""The port's per-line API (``color_modem_tpu_torch/compat/line_api.py``) on
the CPU: the checks of ``tests/test_compat.py`` against the port's batch
pipeline, and every line modem against the JAX package's on the same 24
lines, the first line included.

Bounds: the line protocol against the batch pipeline at
``tests/test_compat.py``'s 2e-5 on interior lines (the first ``skip``
lines, and the last for comb3, follow the documented streaming seam);
against JAX at the kernel-vs-plain bounds: 2e-5 on encode (2e-4 on
SECAM's), 5e-4 on the decoded RGB.
"""

import numpy as np
import pytest
import torch

from color_modem_tpu import compat as jcompat
from color_modem_tpu_torch.compat import (
    ColorAveragingModem,
    DelayLinePalModem,
    ImageModem,
    NiirModem,
    NtscModem,
    PalModem,
    SecamModem,
    Simple3DCombModem,
    SimpleCombModem,
    make_line_modem,
)
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import ALL_STANDARDS
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

L, N = 24, 720
ENC_ATOL, SECAM_ENC_ATOL, DEC_ATOL = 2e-5, 2e-4, 5e-4
CPU = "cpu"


@pytest.fixture(scope="module")
def img():
    return smooth_scene(L, N, seed=3).astype(np.float32)


def _batch(name, decoder, img, frame=0):
    enc, dec, _ = make_pipeline(make_plan(ALL_STANDARDS[name](), N), decoder, device=CPU)
    comp = enc(img[None], frame)
    return comp[0].numpy(), dec(comp, frame)[0].numpy()


CASES = [
    ("ntsc", "notch", lambda: NtscModem(N, CPU), 0),
    ("ntsc", "comb2", lambda: SimpleCombModem(NtscModem(N, CPU)), 1),
    ("ntsc", "comb3", lambda: Simple3DCombModem(NtscModem(N, CPU)), 1),
    ("ntsc", "avg", lambda: ColorAveragingModem(NtscModem(N, CPU)), 1),
    ("pal", "delayline", lambda: DelayLinePalModem(N, CPU), 1),
    ("secam", "notch", lambda: SecamModem(N, CPU), 1),
    ("niir", "notch", lambda: NiirModem(N, CPU), 1),
    # FM/NIIR chroma averaging chains two 1-line streaming states
    # (pairing or normalisation, then averaging): a 2-line seam
    ("secam", "avg", lambda: ColorAveragingModem(SecamModem(N, CPU)), 2),
    ("niir", "avg", lambda: ColorAveragingModem(NiirModem(N, CPU)), 2),
]


@pytest.mark.parametrize("name,decoder,make,skip", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_line_protocol_matches_batch(name, decoder, make, skip, img):
    comp_b, rgb_b = _batch(name, decoder, img)
    im = ImageModem(make())
    np.testing.assert_allclose(im.modulate_image(img), comp_b, atol=2e-5)
    rgb_c = im.demodulate_image(comp_b)
    # interior lines agree; the first `skip` lines (and the last, for
    # comb3) follow the streaming seam instead of the reflection
    hi = L - 1 if decoder == "comb3" else L
    np.testing.assert_allclose(rgb_c[:, skip:hi], rgb_b[:, skip:hi], atol=2e-5)


def test_frame_argument_drives_phase(img):
    modem = NtscModem(N, CPU)
    line0_f0 = modem.modulate(0, 0, img[0, 0], img[1, 0], img[2, 0])
    line0_f1 = modem.modulate(1, 0, img[0, 0], img[1, 0], img[2, 0])
    # 525 lines * 227.5 cycles/line: an odd half cycle, the phase flips
    assert not np.allclose(line0_f0, line0_f1, atol=1e-4)
    comp_b, _ = _batch("ntsc", "notch", img, frame=1)
    np.testing.assert_allclose(line0_f1, comp_b[0], atol=2e-5)


def test_reset_clears_streaming_state():
    modem = SecamModem(N, CPU)
    modem.demodulate(0, 0, np.zeros(N, np.float32) + 0.5)
    assert modem._prev_v is not None  # demodulate did set state
    modem.reset()
    assert modem._prev_v is None


PAIRS = {
    "ntsc": (lambda: NtscModem(N, CPU), lambda: jcompat.NtscModem(N)),
    "pal": (lambda: PalModem(N, CPU), lambda: jcompat.PalModem(N)),
    "secam": (lambda: SecamModem(N, CPU), lambda: jcompat.SecamModem(N)),
    "niir": (lambda: NiirModem(N, CPU), lambda: jcompat.NiirModem(N)),
    "pal-delayline": (lambda: DelayLinePalModem(N, CPU), lambda: jcompat.DelayLinePalModem(N)),
    "ntsc-comb2": (lambda: SimpleCombModem(NtscModem(N, CPU)),
                   lambda: jcompat.SimpleCombModem(jcompat.NtscModem(N))),
    "ntsc-comb3": (lambda: Simple3DCombModem(NtscModem(N, CPU)),
                   lambda: jcompat.Simple3DCombModem(jcompat.NtscModem(N))),
    "secam-avg": (lambda: ColorAveragingModem(SecamModem(N, CPU)),
                  lambda: jcompat.ColorAveragingModem(jcompat.SecamModem(N))),
    "niir-avg": (lambda: ColorAveragingModem(NiirModem(N, CPU)),
                 lambda: jcompat.ColorAveragingModem(jcompat.NiirModem(N))),
    "pal_m": (lambda: make_line_modem("pal_m", N, CPU),
              lambda: jcompat.make_line_modem("pal_m", N)),
}


@pytest.mark.parametrize("key", sorted(PAIRS))
def test_line_modem_matches_jax(key, img):
    """The same 24 lines, the first included, through the port's and the
    JAX package's line modems, at frame 5 (a phase other than 0)."""
    make_t, make_j = PAIRS[key]
    mt, mj = ImageModem(make_t()), ImageModem(make_j())
    assert mt.modem.latency == mj.modem.latency
    comp_t, comp_j = mt.modulate_image(img, frame=5), mj.modulate_image(img, frame=5)
    atol = SECAM_ENC_ATOL if key.startswith("secam") else ENC_ATOL
    np.testing.assert_allclose(comp_t, comp_j, atol=atol)
    # decode the same composite on both sides
    rgb_t, rgb_j = mt.demodulate_image(comp_j, frame=5), mj.demodulate_image(comp_j, frame=5)
    assert rgb_t.shape == rgb_j.shape == (3, L, N)
    np.testing.assert_allclose(rgb_t, rgb_j, atol=DEC_ATOL)


def test_comb3_runs_one_line_late(img):
    """Simple3DCombModem: the output of the call that feeds line n is line
    n - 1 of the batch comb3 decode (latency 1)."""
    comp_b, rgb_b = _batch("ntsc", "comb3", img)
    modem = Simple3DCombModem(NtscModem(N, CPU))
    assert modem.latency == 1
    outs = [np.stack(modem.demodulate(0, l, comp_b[l])) for l in range(4)]
    for l in (2, 3):
        np.testing.assert_allclose(np.clip(outs[l], 0, 1), rgb_b[:, l - 1], atol=2e-5)


def test_modems_default_to_the_card(monkeypatch):
    """Without a device argument a line modem runs on the card, and without
    CUDA it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: NtscModem(N), lambda: SecamModem(N), lambda: DelayLinePalModem(N),
                 lambda: make_line_modem("pal60", N)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
