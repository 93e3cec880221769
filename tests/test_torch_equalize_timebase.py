"""The port's GCR equalizer (``color_modem_tpu_torch/frame/equalize.py``)
and time-base corrector (``frame/timebase.py``) against the JAX package,
on the CPU.

Both run on ``torch.fft`` at non-power-of-two lengths where the JAX
package uses real-DFT matmuls (``dsp/rdft.py``); the bounds are
tests/test_rdft.py's (1e-4 on a round trip) and tests/test_equalize.py's
and tests/test_timebase.py's, and the designed taps agree with JAX's to
1e-4.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import equalize as jeq
from color_modem_tpu.frame import timebase as jtb
from color_modem_tpu.frame.channel import impair as jimpair
from color_modem_tpu.frame.raster import make_raster as jmake_raster
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import equalize as teq
from color_modem_tpu_torch.frame import rf as trf
from color_modem_tpu_torch.frame import timebase as ttb
from color_modem_tpu_torch.frame.channel import impair
from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
from color_modem_tpu_torch.frame.raster import make_raster
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr

L, N = 48, 720


@pytest.fixture(scope="module")
def plan():
    return plan_from_numpy(get_plan("ntsc"))


@pytest.fixture(scope="module")
def comb3(plan):
    enc, dec, _ = make_pipeline(plan, "comb3", device="cpu")
    img = torch.tensor(smooth_scene(L, N, seed=13), dtype=torch.float32)[None]
    return enc, dec, img


def test_gcr_records_are_bit_identical(plan):
    jplan = get_plan("ntsc")
    assert np.array_equal(teq.gcr_line(plan), jeq.gcr_line(jplan))
    assert np.array_equal(teq.gcr_record(plan), jeq.gcr_record(jplan))
    assert np.array_equal(teq.gcr_record(plan, 4, samples=858),
                          jeq.gcr_record(jplan, 4, samples=858))
    assert np.array_equal(teq.gcr_record_guarded(plan), jeq.gcr_record_guarded(jplan))
    for d in (0.0, 1.2, 10.0, 45.0):
        assert teq.ntaps_for_delay(plan, d) == jeq.ntaps_for_delay(jplan, d)
    with pytest.raises(ValueError, match="prefix"):
        teq.gcr_record(plan, 1)


@pytest.mark.parametrize("record,ntaps,pivot", [
    (False, 129, 0.0), (True, 129, 0.0), (True, 1281, 0.0), (True, 411, 1.2),
], ids=["line", "record", "record-1281", "record-pivot"])
def test_design_equalizer_matches_jax(plan, record, ntaps, pivot):
    jplan = get_plan("ntsc")
    imp = {"ghost_delay_us": 10.0, "ghost_gain": 0.25, "chroma_gain": 0.8}
    if record:
        rx = np.asarray(jimpair(jplan, jnp.asarray(jeq.gcr_record(jplan))[None], **imp)[0])
    else:
        rx = np.asarray(jimpair(jplan, jnp.asarray(jeq.gcr_line(jplan))[None, None], **imp)[0, 0])
    got = teq.design_equalizer(plan, torch.tensor(rx), ntaps=ntaps, pivot=pivot)
    want = np.asarray(jeq.design_equalizer(jplan, jnp.asarray(rx), ntaps=ntaps, pivot=pivot))
    assert got.shape == (ntaps,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    comp = np.random.default_rng(1).random((2, 8, N)).astype(np.float32)
    np.testing.assert_allclose(
        teq.apply_equalizer(torch.tensor(comp), got, pivot).numpy(),
        np.asarray(jeq.apply_equalizer(jnp.asarray(comp), jnp.asarray(want), pivot)),
        rtol=0, atol=1e-4)


def test_design_refusals(plan):
    with pytest.raises(ValueError, match="odd"):
        teq.design_equalizer(plan, torch.tensor(teq.gcr_line(plan)), ntaps=64)
    with pytest.raises(ValueError, match=">= 2 lines"):
        teq.design_equalizer(plan, torch.zeros(1, N))


def test_clean_channel_gives_identity_taps(plan, comb3):
    enc, _, img = comb3
    taps = teq.design_equalizer(plan, torch.tensor(teq.gcr_line(plan)))
    half = len(taps) // 2
    assert abs(float(taps[half]) - 1.0) < 0.02
    assert float(torch.cat([taps[:half], taps[half + 1:]]).abs().max()) < 0.02
    comp = enc(img)
    assert psnr(teq.apply_equalizer(comp, taps), comp) > 45.0


def test_known_impulse_response_is_inverted(plan):
    d, g = 17, -0.35
    rx = impair(plan, torch.tensor(teq.gcr_line(plan))[None, None],
                ghost_delay_us=d / plan.fs * 1e6, ghost_gain=g)[0, 0]
    taps = teq.design_equalizer(plan, rx)
    imp = torch.zeros(1, 1, 4 * N)
    imp[0, 0, 2 * N] = 1.0
    chan = imp + g * torch.cat([torch.zeros(1, 1, d), imp[..., :-d]], dim=-1)
    out = teq.apply_equalizer(chan, taps)[0, 0]
    assert float((out - imp[0, 0]).abs().max()) < 0.03


def test_long_ghost_needs_the_record_and_longer_taps(plan, comb3):
    enc, dec, img = comb3
    comp = enc(img)
    clean = psnr(dec(comp), img)
    imp = {"ghost_delay_us": 10.0, "ghost_gain": 0.25}
    bad = impair(plan, comp, **imp)
    rec = impair(plan, torch.tensor(teq.gcr_record(plan))[None], **imp)[0]
    short = psnr(dec(teq.apply_equalizer(bad, teq.design_equalizer(plan, rec))), img)
    n = teq.ntaps_for_delay(plan, imp["ghost_delay_us"])
    fixed = psnr(dec(teq.apply_equalizer(bad, teq.design_equalizer(plan, rec, ntaps=n))), img)
    assert clean - fixed < 3.0 and fixed - short > 15.0, (clean, short, fixed)


def test_equalizer_recovers_an_rf_ghost(plan):
    """An RF ghost is a linear composite-rate channel about the zero-carrier
    level through synchronous detection, not through envelope detection."""
    enc, _, _ = make_pipeline(plan, "notch", device="cpu")
    x = torch.tensor(np.stack([smooth_scene(64, N, seed=s) for s in range(2)]),
                     dtype=torch.float32)
    comp = enc(x, 0)
    rfp = trf.make_rf_plan(plan)

    def chain(c, detection="sync"):
        rf = trf.rf_modulate(rfp, c, 0)
        return trf.rf_demodulate(rfp, trf.rf_ghost(rfp, rf, 3.0, 0.30), 0, detection)

    ghosted = chain(comp)
    assert psnr(ghosted[:, 2:-2], comp[:, 2:-2]) < 22.0
    pv = rfp.video_zero
    guarded = torch.tensor(teq.gcr_record_guarded(plan))[None]
    taps = teq.design_equalizer(plan, chain(guarded)[0][:3], ntaps=1281, reg=1e-4, pivot=pv)
    p_eq = psnr(teq.apply_equalizer(ghosted, taps, pivot=pv)[:, 2:-2], comp[:, 2:-2])
    assert p_eq >= 45.0
    taps_e = teq.design_equalizer(plan, chain(guarded, "envelope")[0][:3], ntaps=1281,
                                  reg=1e-4, pivot=pv)
    eq_e = teq.apply_equalizer(chain(comp, "envelope"), taps_e, pivot=pv)
    assert psnr(eq_e[:, 2:-2], comp[:, 2:-2]) < p_eq - 6.0


@pytest.mark.parametrize("n", [138, 720, 858, 864, 1440])
def test_fractional_shift_at_non_pow2_lengths(n):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    got = ttb.fractional_shift(torch.tensor(x), torch.full((3,), 3.0))
    np.testing.assert_allclose(got.numpy(), np.roll(x, 3, axis=-1), rtol=0, atol=1e-4)
    back = ttb.fractional_shift(got, torch.full((3,), -3.0))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-4)


def test_fractional_shift_matches_jax():
    rng = np.random.default_rng(0)
    spec = np.zeros((4, N), np.complex128)
    spec[:, :100] = rng.normal(size=(4, 100)) + 1j * rng.normal(size=(4, 100))
    x = np.fft.irfft(spec, n=N).astype(np.float32)
    delta = np.array([0.3, -1.7, 2.25, 5.0], np.float32)
    got = ttb.fractional_shift(torch.tensor(x), torch.tensor(delta)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jtb.fractional_shift(jnp.asarray(x), jnp.asarray(delta))),
        rtol=0, atol=1e-5)


def test_profile_matches_jax(plan):
    jplan = get_plan("ntsc")
    got = ttb.timebase_profile(plan, L, wobble_us=0.4, flagging_us=0.3, device="cpu")
    want = np.asarray(jtb.timebase_profile(jplan, L, wobble_us=0.4, flagging_us=0.3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="Generator"):
        ttb.timebase_profile(plan, 16, jitter_us=0.1, device="cpu")
    jit = ttb.timebase_profile(plan, 4096, wobble_us=0.0, jitter_us=0.1,
                               generator=torch.Generator().manual_seed(3), device="cpu")
    assert abs(float(jit.std()) / (0.1 * plan.fs * 1e-6) - 1.0) < 0.05


def test_profile_defaults_to_the_card(plan):
    """With no device the profile is made on the card, and without CUDA
    that raises as the factories do; a device it is given holds."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttb.timebase_profile(plan, 16)
    assert ttb.timebase_profile(plan, 16, device="meta").device.type == "meta"


@pytest.fixture(scope="module")
def rastered(plan):
    enc, dec, _ = make_pipeline(plan, "comb3", device="cpu", raster=True)
    img = torch.tensor(smooth_scene(L, N, seed=31), dtype=torch.float32)[None]
    return enc, dec, img, enc(img, 0), frame_line_index(plan, 0, 1, L, "cpu")


def test_delay_estimator_recovers_the_injected_profile(plan, rastered):
    _, _, _, ras, g = rastered
    rp = make_raster(plan)
    shifted, true_delta = ttb.impair_timebase(
        plan, ras, wobble_us=0.4, flagging_us=0.3, jitter_us=0.05,
        generator=torch.Generator().manual_seed(3))
    est = ttb.measure_line_shift(plan, rp, shifted, g)
    assert float((est - true_delta).abs().max()) < 0.05
    jplan = get_plan("ntsc")
    want = np.asarray(jtb.measure_line_shift(jplan, jmake_raster(jplan),
                                             jnp.asarray(shifted.numpy()), jnp.asarray(g.numpy())))
    np.testing.assert_allclose(est.numpy(), want, rtol=0, atol=1e-4)
    assert ttb.correctable_reach(rp) == jtb.correctable_reach(jmake_raster(jplan))
    with pytest.raises(ValueError, match="front porch"):
        ttb.measure_line_shift(plan, rp, shifted, g, max_shift=rp.sync_start)


def test_tbc_restores_qam_decoding(plan, rastered):
    _, dec, img, ras, g = rastered
    rp = make_raster(plan)
    clean = psnr(dec(ras, 0), img)
    shifted, _ = ttb.impair_timebase(plan, ras, wobble_us=0.3)
    wrecked = psnr(dec(shifted, 0), img)
    fixed_ras = ttb.tbc_correct(plan, rp, shifted, g)
    fixed = psnr(dec(fixed_ras, 0), img)
    assert clean - wrecked > 8.0 and clean - fixed < 1.0, (clean, wrecked, fixed)
    jplan = get_plan("ntsc")
    want = np.asarray(jtb.tbc_correct(jplan, jmake_raster(jplan), jnp.asarray(shifted.numpy()),
                                      jnp.asarray(g.numpy())))
    np.testing.assert_allclose(fixed_ras.numpy(), want, rtol=0, atol=1e-4)
