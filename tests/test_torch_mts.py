"""The port's MTS/BTSC stereo multiplex (``color_modem_tpu_torch/frame/
mts.py``) against the JAX package and the frozen naive chain
``golden/sound.py``, on the CPU.

Bounds: encode and decode > 120 dB parity against golden and against JAX,
the pilot to 1e-6 (tests/test_golden_sound.py); the baseband round trip
>= 80 dB with >= 60 dB separation, >= 50 dB through the intercarrier FM
channel, the pilot within 0.01 / 0.02 of PILOT_AMP, and a mono input
decoding into equal ears to 1e-3 (tests/test_mts.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import mts as jmts
from color_modem_tpu.golden import sound as gs
from color_modem_tpu_torch.frame import mts as tmts
from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate_sound, rf_modulate
from color_modem_tpu_torch.modem.plan import plan_from_numpy

T_LINES = 64
CROP = 16384  # the channel low-pass transient


def _parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


def _snr(got, want) -> float:
    e = np.asarray(got)[:, CROP:-CROP] - np.asarray(want)[:, CROP:-CROP]
    return 10 * np.log10(np.mean(np.asarray(want)[:, CROP:-CROP] ** 2) / np.mean(e ** 2))


@pytest.fixture(scope="module")
def plan():
    return plan_from_numpy(get_plan("ntsc"))


def _tones(plan, lines=T_LINES):
    t = np.arange(lines * plan.n_samples) / plan.fs
    left = (0.7 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)[None]
    right = (0.5 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32)[None]
    return left, right


def test_channel_lpf_and_phase_match_jax(plan):
    assert np.array_equal(tmts._channel_lpf(plan.fs), jmts._channel_lpf(plan.fs))
    assert tmts.PILOT_AMP == jmts.PILOT_AMP and tmts.AUDIO_BW == jmts.AUDIO_BW
    for rows in (None, 858):
        t = tmts._phase(plan, 5000, "cpu", rows)
        j = np.asarray(jmts._phase(get_plan("ntsc"), 5000, rows))
        assert np.array_equal(t.numpy(), j)


def test_mts_matches_golden_and_jax(plan):
    left, right = _tones(plan, 32)
    t_enc = tmts.mts_encode(plan, torch.tensor(left), torch.tensor(right))
    g_enc = gs.mts_encode(plan.n_samples, left, right)
    assert _parity_db(t_enc, g_enc) > 120.0
    j_enc = jmts.mts_encode(get_plan("ntsc"), jnp.asarray(left), jnp.asarray(right))
    assert _parity_db(t_enc, j_enc) > 120.0
    a = g_enc.astype(np.float32)
    t_l, t_r, t_p = tmts.mts_decode(plan, torch.tensor(a))
    g_l, g_r, g_p = gs.mts_decode(plan.n_samples, tmts._channel_lpf(plan.fs), a)
    assert _parity_db(t_l, g_l) > 120.0 and _parity_db(t_r, g_r) > 120.0
    np.testing.assert_allclose(t_p.numpy(), g_p, atol=1e-6)
    j_l, j_r, j_p = jmts.mts_decode(get_plan("ntsc"), jnp.asarray(a))
    assert _parity_db(t_l, j_l) > 120.0 and _parity_db(t_r, j_r) > 120.0
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), atol=1e-6)


def test_baseband_roundtrip_and_separation(plan):
    left, right = _tones(plan)
    l2, r2, pilot = tmts.mts_decode(plan, tmts.mts_encode(plan, torch.tensor(left),
                                                          torch.tensor(right)))
    assert _snr(l2, left) >= 80.0 and _snr(r2, right) >= 80.0
    assert np.allclose(pilot.numpy(), tmts.PILOT_AMP, atol=0.01)
    l3, r3, _ = tmts.mts_decode(plan, tmts.mts_encode(plan, torch.tensor(left),
                                                      torch.zeros(left.shape)))
    sep = 10 * np.log10(np.mean(l3.numpy()[:, CROP:-CROP] ** 2)
                        / np.mean(r3.numpy()[:, CROP:-CROP] ** 2))
    assert sep >= 60.0, sep


def test_through_the_rf_sound_channel(plan):
    """MTS multiplex -> intercarrier FM (audio_bw 50 kHz) -> discriminator
    -> MTS demultiplex."""
    left, right = _tones(plan)
    a = tmts.mts_encode(plan, torch.tensor(left), torch.tensor(right))
    rfp = make_rf_plan(plan, audio_bw=50e3)
    rf = rf_modulate(rfp, torch.zeros(1, T_LINES, plan.n_samples), 0, a)
    l2, r2, pilot = tmts.mts_decode(plan, rf_demodulate_sound(rfp, rf, 0))
    assert _snr(l2, left) >= 50.0 and _snr(r2, right) >= 50.0
    assert np.allclose(pilot.numpy(), tmts.PILOT_AMP, atol=0.02)


def test_pilot_distinguishes_mono(plan):
    t = np.arange(T_LINES * plan.n_samples) / plan.fs
    mono = torch.tensor((0.7 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)[None])
    l2, r2, pilot = tmts.mts_decode(plan, mono)
    assert abs(float(pilot[0])) < 0.01
    np.testing.assert_allclose(l2.numpy()[:, CROP:-CROP], r2.numpy()[:, CROP:-CROP],
                               atol=1e-3, rtol=0)
