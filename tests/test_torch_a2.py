"""The port's A2 / Zweikanalton two-carrier stereo (``color_modem_tpu_torch/
frame/a2.py``) against the JAX package and the frozen naive chain
``golden/sound.py``, on the CPU.

Bounds: the plan bit-identical; ``a2_on_rf`` > 105 dB and the carrier-2
takeoff > 85 dB parity against golden (tests/test_golden_sound.py), and
the same against JAX (> 100 dB for ``a2_on_rf``; the takeoff is float32
limited through three 4097-tap FFT filters: the port reads 91.0 dB against
golden where JAX reads 94.8, PyTorch's CPU FFT being ~1.3x noisier than
JAX's on the same transform, and the two 89.7 dB apart); the receiver's statistics against JAX's on the same
RF to 1e-4 relative (the fitted ident amplitudes 1e-3, the fit residuals
1e-6 absolute) and its audio >= 90 dB; the behaviour tests of
tests/test_a2.py at their bounds (L >= 58 dB and R >= 56 dB in stereo, each
program >= 56 dB in dual, the picture within 0.3 dB, separation >= 35 dB,
mono detected by the carrier level), and the interlaced field-pair window
(``group=2``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu.frame import a2 as ja2
from color_modem_tpu.frame import rf as jrf
from color_modem_tpu.golden import sound as gs
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.dsp.apply import fir_same_fft
from color_modem_tpu_torch.frame import a2 as ta2
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate, rf_modulate
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr

L = 160  # >= 2.7 ident-tone cycles for the dual/stereo decision
CROP = 8192


def _parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


def _snr(ref, got):
    r, g = np.asarray(ref)[0][CROP:-CROP], np.asarray(got)[0][CROP:-CROP]
    return 10 * np.log10(np.mean(r ** 2) / np.mean((g - r) ** 2))


@pytest.fixture(scope="module")
def link():
    plan = plan_from_numpy(get_plan("pal"))
    rfp = make_rf_plan(plan)
    a2p = ta2.make_a2_plan(rfp)
    enc, dec, _ = make_pipeline(plan, "delayline", device="cpu")
    img = torch.tensor(smooth_scene(L, TEST_SAMPLES, seed=2), dtype=torch.float32)[None]
    comp = enc(img, 0)
    t = np.arange(L * TEST_SAMPLES) / plan.fs
    left = (0.6 * np.sin(2 * np.pi * 800 * t)
            + 0.2 * np.sin(2 * np.pi * 5000 * t)).astype(np.float32)[None]
    right = (0.5 * np.sin(2 * np.pi * 2300 * t)).astype(np.float32)[None]
    return plan, rfp, a2p, dec, img, comp, torch.tensor(left), torch.tensor(right)


def test_plan_matches_jax(link):
    _, rfp, a2p = link[:3]
    jp = ja2.make_a2_plan(jrf.make_rf_plan(get_plan("pal")))
    for f in ("f_snd2", "snd2_num", "amp2", "fh"):
        assert getattr(a2p, f) == getattr(jp, f), f
    for f in ("snd2_ramp", "pilot_ramp", "bpf1", "bpf2", "snd_lpf", "pil_lpf"):
        assert np.array_equal(getattr(a2p, f), getattr(jp, f)), f
    fh = rfp.plan.fs / rfp.row_samples
    assert a2p.snd2_num % 2 == 0 and abs((a2p.f_snd2 - rfp.f_snd) - 15.5 * fh) < 1e-6
    assert abs(a2p.ident_hz("stereo") - fh / 133) < 1e-9
    for mode in ("stereo", "dual"):
        rows = torch.arange(3 * 64, dtype=torch.int32).reshape(3, 64) + 12345
        np.testing.assert_array_equal(
            ta2._ident_phase_rows(a2p, mode, rows).numpy(),
            np.asarray(ja2._ident_phase_rows(jp, mode, jnp.asarray(rows.numpy()))))


def test_a2_matches_golden_and_jax():
    jrfp = jrf.make_rf_plan(get_plan("ntsc"))
    jp = ja2.make_a2_plan(jrfp)
    a2p = ta2.make_a2_plan(make_rf_plan(plan_from_numpy(get_plan("ntsc"))))
    lines, n = 16, 720
    tt = np.arange(lines * n, dtype=np.float64) / jrfp.plan.fs
    audio2 = (0.6 * np.sin(2 * np.pi * 1300.0 * tt)
              + 0.2 * np.sin(2 * np.pi * 2.7 * 1300.0 * tt)).astype(np.float32)[None]
    rf0 = np.zeros((1, lines, jrfp.n_rf), np.float32)
    t = ta2.a2_on_rf(a2p, torch.tensor(rf0), 3, torch.tensor(audio2), "stereo")
    g = gs.a2_on_rf(jp, rf0, 3, audio2, "stereo")
    assert _parity_db(t, g) > 105.0
    j = ja2.a2_on_rf(jp, jnp.asarray(rf0), 3, jnp.asarray(audio2), "stereo")
    assert _parity_db(t, j) > 100.0
    g32 = torch.tensor(g.astype(np.float32))
    raw, _ = ta2._takeoff(a2p, g32, a2p.bpf2, a2p.snd2_ramp, 3,
                          sign=ta2._carrier2_sign(a2p, 3, 1, lines, "cpu"))
    assert _parity_db(raw, gs.a2_takeoff2(jp, g.astype(np.float32), 3)) > 85.0
    j_raw, _ = ja2._takeoff(jp, jnp.asarray(g32.numpy()), jp.bpf2, jp.snd2_ramp, 3,
                            sign=ja2._carrier2_sign(jp, 3, 1, lines))
    assert _parity_db(raw, j_raw) > 85.0


def test_stereo_roundtrip_matches_jax(link):
    plan, rfp, a2p, dec, img, comp, left, right = link
    rf = rf_modulate(rfp, comp, 0, 0.5 * (left + right))
    rf = ta2.a2_on_rf(a2p, rf, 0, right, "stereo")
    gl, gr, info = ta2.a2_decode(a2p, rf, 0)
    assert info["mode"] == ["stereo"]
    assert info["pilot_level"][0] == pytest.approx(0.05, rel=0.3)
    assert _snr(left, gl) >= 58.0 and _snr(right, gr) >= 56.0
    jp = ja2.make_a2_plan(jrf.make_rf_plan(get_plan("pal")))
    jl, jr_, jinfo = ja2.a2_decode(jp, jnp.asarray(rf.numpy()), 0)
    assert jinfo["mode"] == info["mode"]
    for k in ("carrier2_level", "pilot_level"):
        np.testing.assert_allclose(info[k], jinfo[k], rtol=1e-4)
    for m in ("stereo", "dual"):
        np.testing.assert_allclose(info["ident_power"][m], jinfo["ident_power"][m], rtol=1e-3)
        # the residual is mean(env^2) ~ 2.5e-3 less the fit: it keeps the
        # float32 rounding of that difference
        np.testing.assert_allclose(info["ident_resid"][m], jinfo["ident_resid"][m], rtol=0,
                                   atol=1e-6)
    assert _parity_db(gl, jl) > 90.0 and _parity_db(gr, jr_) > 90.0
    # the second carrier costs the picture nothing
    p_via = psnr(dec(rf_demodulate(rfp, rf, 0), 0)[:, :, 2:-2], img[:, :, 2:-2])
    p_dir = psnr(dec(comp, 0)[:, :, 2:-2], img[:, :, 2:-2])
    assert p_via >= p_dir - 0.3, (p_via, p_dir)


def test_mono_compatibility(link):
    plan, rfp, a2p, dec, img, comp, left, right = link
    mono = 0.5 * (left + right)
    rf1 = rf_modulate(rfp, comp, 0, mono)
    rf2 = ta2.a2_on_rf(a2p, rf1, 0, right, "stereo")
    s1 = _snr(mono, fir_same_fft(ta2._takeoff(a2p, rf1, a2p.bpf1, rfp.snd_ramp, 0)[0],
                                 rfp.aud_lpf))
    s2 = _snr(mono, fir_same_fft(ta2._takeoff(a2p, rf2, a2p.bpf1, rfp.snd_ramp, 0)[0],
                                 rfp.aud_lpf))
    assert s1 >= 58.0 and s2 >= s1 - 1.0, (s1, s2)


def test_dual_and_mono_detection(link):
    plan, rfp, a2p, dec, img, comp, left, right = link
    rf = ta2.a2_on_rf(a2p, rf_modulate(rfp, comp, 0, left), 0, right, "dual")
    g1, g2, info = ta2.a2_decode(a2p, rf, 0)
    assert info["mode"] == ["dual"]
    assert info["ident_power"]["dual"][0] > 3 * info["ident_power"]["stereo"][0]
    assert _snr(left, g1) >= 56.0 and _snr(right, g2) >= 56.0
    gl, gr, infom = ta2.a2_decode(a2p, rf_modulate(rfp, comp, 0, left), 0)
    assert infom["mode"] == ["mono"] and infom["carrier2_level"][0] < 0.3 * a2p.amp2
    assert _snr(left, gl) >= 58.0 and torch.equal(gl, gr)


def test_stereo_separation(link):
    plan, rfp, a2p, dec, img, comp, left, right = link
    rf = rf_modulate(rfp, comp, 0, 0.5 * left)
    rf = ta2.a2_on_rf(a2p, rf, 0, torch.zeros_like(left), "stereo")
    gl, gr, info = ta2.a2_decode(a2p, rf, 0)
    assert info["mode"] == ["stereo"]
    sep = 10 * np.log10(np.mean(gl.numpy()[0][CROP:-CROP] ** 2)
                        / np.mean(gr.numpy()[0][CROP:-CROP] ** 2))
    assert sep >= 35.0, sep


def test_field_pair_window(link):
    """group=2: two half-height items of consecutive broadcast time decide
    together, as one item of twice the lines does, and get its mode."""
    plan, rfp, a2p, dec, img, comp, left, right = link
    half = L // 2
    rf = ta2.a2_on_rf(a2p, rf_modulate(rfp, comp, 0, left), 0, right, "dual")
    fields = rf.reshape(2, half, rf.shape[-1])
    level2, powers2, resid2 = ta2.a2_detect_mode(
        a2p, ta2._takeoff(a2p, fields, a2p.bpf2, a2p.snd2_ramp, 0,
                          sign=ta2._carrier2_sign(a2p, 0, 2, half, "cpu"))[0], 0, 2, half, 2)
    assert resid2["dual"][0] < resid2["stereo"][0] and torch.equal(level2[0], level2[1])
    _, _, info = ta2.a2_decode(a2p, fields, 0, group=2)
    assert info["mode"] == ["dual", "dual"]
    with pytest.raises(ValueError, match="group"):
        ta2.a2_detect_mode(a2p, torch.zeros(3, half * TEST_SAMPLES), 0, 3, half, 2)
