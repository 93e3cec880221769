"""The port's intercarrier FM sound (``color_modem_tpu_torch/frame/rf.py``)
against the JAX package and the frozen naive chain ``golden/sound.py``, on
the CPU.

Bounds: ``sound_on_rf`` > 100 dB and ``sound_from_rf`` > 65 dB parity
against golden (tests/test_golden_sound.py); against the JAX package on
the same input >= 100 dB for the per-item transmitter and receiver, with
and without a frequency error; the two-tone SNR >= 55 dB with the picture
>= 63 dB, and >= 55 dB over flat and gray pictures (tests/test_rf.py); the
halo takeoff equal to the unsharded chunk's own frames to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import rf as jrf
from color_modem_tpu.golden import sound as gs
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import rf as trf
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr

L, N = 16, 720
CROP = 8192  # the audio low-pass transient


def _parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


def _snr(got, want) -> float:
    got, want = np.asarray(got)[:, CROP:-CROP], np.asarray(want)[:, CROP:-CROP]
    return 10 * np.log10(np.mean(want ** 2) / np.mean((got - want) ** 2))


def _tones(b: int, t: int, fs: float, freqs) -> np.ndarray:
    tt = np.arange(t, dtype=np.float64) / fs
    return np.stack([0.6 * np.sin(2.0 * np.pi * f * tt) + 0.2 * np.sin(2.0 * np.pi * 2.7 * f * tt)
                     for f in freqs[:b]]).astype(np.float32)


@pytest.fixture(scope="module")
def plans():
    jplan = get_plan("ntsc")
    return jrf.make_rf_plan(jplan), trf.make_rf_plan(plan_from_numpy(jplan))


def test_sound_on_rf_matches_golden_and_jax(plans):
    jp, tp = plans
    audio = _tones(2, L * N, tp.plan.fs, (700.0, 1700.0))
    rf0 = np.zeros((2, L, tp.n_rf), np.float32)
    t = trf.sound_on_rf(tp, torch.tensor(rf0), 3, torch.tensor(audio), 1.234)
    assert _parity_db(t, gs.sound_on_rf(jp, rf0, 3, audio, 1.234)) > 100.0
    j = jrf.sound_on_rf(jp, jnp.asarray(rf0), 3, jnp.asarray(audio), 1.234)
    assert _parity_db(t, j) > 100.0
    # phi0 as a 0-d float64 tensor is the same law
    t2 = trf.sound_on_rf(tp, torch.tensor(rf0), 3, torch.tensor(audio),
                         torch.tensor(1.234, dtype=torch.float64))
    assert torch.equal(t, t2)


def test_sound_from_rf_matches_golden_and_jax(plans):
    jp, tp = plans
    audio = _tones(2, L * N, tp.plan.fs, (700.0, 1700.0))
    g_rf = gs.sound_on_rf(jp, np.zeros((2, L, tp.n_rf), np.float32), 3, audio,
                          0.5).astype(np.float32)
    t = trf.sound_from_rf(tp, torch.tensor(g_rf), 3)
    assert t.shape == (2, L * N)
    assert _parity_db(t, gs.sound_from_rf(jp, g_rf, 3)) > 65.0
    assert _parity_db(t, jrf.sound_from_rf(jp, jnp.asarray(g_rf), 3)) > 100.0


@pytest.mark.parametrize("df", [0.0, 3e3], ids=["tuned", "df-3khz"])
def test_per_item_sound_matches_jax(plans, df):
    """rf_modulate(audio=) and rf_demodulate_sound, with a transmitter
    offset tracked by freq_error."""
    jp, tp = plans
    rng = np.random.default_rng(7)
    comp = rng.uniform(-0.2, 1.0, (2, L, N)).astype(np.float32)
    audio = _tones(2, L * N, tp.plan.fs, (900.0, 2100.0))
    t_rf = trf.rf_modulate(tp, torch.tensor(comp), 5, torch.tensor(audio), df=df)
    j_rf = jrf.rf_modulate(jp, jnp.asarray(comp), 5, jnp.asarray(audio), df=df)
    assert _parity_db(t_rf, j_rf) > 100.0
    t = trf.rf_demodulate_sound(tp, t_rf, 5, freq_error=df)
    j = jrf.rf_demodulate_sound(jp, jnp.asarray(t_rf.numpy()), 5, freq_error=df)
    assert _parity_db(t, j) > 100.0


def test_two_tone_snr_and_picture_isolation():
    plan = plan_from_numpy(get_plan("ntsc"))
    enc, _, _ = make_pipeline(plan, "comb3", device="cpu")
    x = torch.tensor(np.stack([smooth_scene(64, N, seed=s) for s in range(2)]),
                     dtype=torch.float32)
    comp = enc(x, 0)
    rfp = trf.make_rf_plan(plan)
    b, lines, n = comp.shape
    t = np.arange(lines * n) / plan.fs
    audio = (0.6 * np.sin(2 * np.pi * 1000 * t) + 0.3 * np.sin(2 * np.pi * 7000 * t))
    audio = np.broadcast_to(audio.astype(np.float32), (b, lines * n)).copy()
    out, aud = trf.rf_roundtrip(rfp, comp, 0, torch.tensor(audio))
    assert _snr(aud, audio) >= 55.0
    assert psnr(out[:, 2:-2], comp[:, 2:-2]) >= 63.0
    assert torch.equal(trf.rf_roundtrip(rfp, comp, 0), trf.rf_demodulate(
        rfp, trf.rf_modulate(rfp, comp, 0), 0))


def test_sound_decodes_without_picture_knowledge(plans):
    _, rfp = plans
    t = np.arange(32 * N) / rfp.plan.fs
    audio = torch.tensor((0.7 * np.sin(2 * np.pi * 2000 * t)).astype(np.float32)[None])
    for level in (0.0, 0.5):
        comp = torch.full((1, 32, N), level)
        aud = trf.rf_demodulate_sound(rfp, trf.rf_modulate(rfp, comp, 0, audio), 0)
        assert _snr(aud, audio) >= 55.0, level


@pytest.mark.parametrize("dead", [(True, False), (False, True), (None, None)],
                         ids=["head-dead", "tail-dead", "interior"])
def test_halo_takeoff_equals_the_unsharded_chunk(plans, dead):
    """Frames 0..3 taken off as one joined chunk, against each half taken
    off from a one-frame halo extension: a dead halo (zeros past the
    global stream end) or the true neighbour frame."""
    _, tp = plans
    b = 4
    audio = _tones(1, b * L * N, tp.plan.fs, (1100.0,)).reshape(b, L * N)
    rf = trf.sound_on_rf(tp, torch.zeros(b, L, tp.n_rf), 0, torch.tensor(audio), 0.3)
    whole = trf.sound_from_rf(tp, rf, 0)
    head_dead, tail_dead = dead
    zero = torch.zeros(1, L, tp.n_rf)
    if head_dead:        # the global first two frames: frame -1 carries nothing
        ext, own = torch.cat([zero, rf[:3]]), slice(0, 2)
    elif tail_dead:      # the global last two frames: frame 4 carries nothing
        ext, own = torch.cat([rf[1:], zero]), slice(2, 4)
    else:                # frames 1, 2 with their true neighbours 0 and 3
        ext, own = rf, slice(1, 3)
    frame0 = own.start - 1
    got = trf.sound_from_rf_halo(
        tp, ext, frame0, 1,
        head_dead=None if head_dead is None else torch.tensor(head_dead),
        tail_dead=tail_dead)
    assert got.shape == (2, L * N)
    np.testing.assert_allclose(got.numpy(), whole[own].numpy(), rtol=0, atol=1e-5)
