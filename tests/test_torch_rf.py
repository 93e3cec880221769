"""The port's RF/VSB picture hop (``color_modem_tpu_torch/frame/rf.py``)
against the JAX package and the frozen naive chain
``golden/transmission.py``, on the CPU.

Bounds: the plan's arrays bit-identical (sound filters included);
``rf_modulate`` and ``rf_demodulate`` >= 60 dB parity against JAX on the
same input, > 54 / > 42 dB against golden
(tests/test_golden_transmission.py); transparency, detectors, carrier
recovery, AGC, DOC and co-channel at tests/test_rf.py's bounds.  Dropouts
draw from JAX's key (``utils/prng.py``): the damaged RF equals JAX's bit
for bit, and DOC's decode is held to JAX's at the 60 dB parity bound.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import rf as jrf
from color_modem_tpu.golden import transmission as gt
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import rf as trf
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.frame.raster import make_raster
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils import prng
from color_modem_tpu_torch.utils.metrics import psnr
from torch_threads import one_torch_thread  # noqa: F401

L = 64
PLAN_ARRAYS = ("tx_taps", "rx_taps", "det_taps", "ramp", "snd_bpf", "snd_lpf", "aud_lpf",
               "snd_ramp")
PLAN_SCALARS = ("r", "row_samples", "fc", "cpl_num", "f_vestige", "f_video", "f_snd",
                "snd_num", "snd_dev", "snd_amp", "fs_rf", "n_rf", "video_zero")


def _parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


def _composite(standard, decoder="notch", lines=L, raster=False):
    plan = plan_from_numpy(get_plan(standard))
    enc, dec, _ = make_pipeline(plan, decoder, device="cpu", raster=raster)
    x = torch.tensor(np.stack([smooth_scene(lines, 720, seed=s) for s in range(2)]),
                     dtype=torch.float32)
    return plan, dec, x, enc(x, 0)


@pytest.fixture(scope="module")
def ntsc():
    plan, dec, x, comp = _composite("ntsc", "comb3")
    rfp = trf.make_rf_plan(plan)
    return plan, dec, x, comp, rfp, trf.rf_modulate(rfp, comp, 0)


def _crop(t):
    return t[:, 2:-2]


@pytest.mark.parametrize("standard,kw", [
    ("ntsc", {}), ("pal", {}), ("secam", {}), ("ntsc", {"raster": True}),
    ("ntsc", {"r": 8, "f_video": 4.2e6, "intercarrier": 4.5e6, "transition": 0.2e6}),
], ids=["ntsc", "pal", "secam", "ntsc-raster", "ntsc-authentic-r8"])
def test_plan_is_bit_identical(standard, kw):
    kw = dict(kw)
    jplan = get_plan(standard)
    if kw.pop("raster", False):
        kw["row_samples"] = make_raster(plan_from_numpy(jplan)).n_total
    jp, tp = jrf.make_rf_plan(jplan, **kw), trf.make_rf_plan(plan_from_numpy(jplan), **kw)
    for f in PLAN_SCALARS:
        assert getattr(tp, f) == getattr(jp, f), f
    for f in PLAN_ARRAYS:
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
    for df in (0.0, 7e3):
        for m in ("mod_taps", "dem_taps", "snd_dem_taps"):
            assert np.array_equal(getattr(tp, m)(df), getattr(jp, m)(df)), m
            assert getattr(tp, m)(df) is getattr(tp, m)(df)  # built once per (plan, df)
    assert np.array_equal(tp.ramp_comp, jp.ramp_comp)
    assert np.array_equal(tp.snd_ramp_comp, jp.snd_ramp_comp)


def test_plan_feasibility_checks():
    plan = plan_from_numpy(get_plan("ntsc"))
    with pytest.raises(ValueError, match="RF Nyquist"):
        trf.make_rf_plan(plan, r=2)
    with pytest.raises(ValueError, match="2fc detection image"):
        trf.make_rf_plan(plan, fc=3.0e6)
    with pytest.raises(ValueError, match="power of two"):
        trf.make_rf_plan(plan, r=3)


def test_modulate_and_demodulate_match_jax_and_golden():
    plan, _, _, comp = _composite("ntsc", lines=16)
    c = comp.numpy()
    tp, jp = trf.make_rf_plan(plan), jrf.make_rf_plan(get_plan("ntsc"))
    t_rf = trf.rf_modulate(tp, comp, 3).numpy()
    assert _parity_db(t_rf, np.asarray(jrf.rf_modulate(jp, jnp.asarray(c), 3))) >= 60.0
    g_rf = gt.rf_modulate(tp, c, 3)
    assert _parity_db(t_rf, g_rf) > 54.0
    g32 = g_rf.astype(np.float32)
    t_out = trf.rf_demodulate(tp, torch.tensor(g32), 3).numpy()
    assert _parity_db(t_out, np.asarray(jrf.rf_demodulate(jp, jnp.asarray(g32), 3))) >= 60.0
    assert _parity_db(t_out, gt.rf_demodulate(tp, g32, 3)) > 42.0


@pytest.mark.parametrize("standard,bound", [("ntsc", 63.0), ("pal", 60.0), ("secam", 52.0)])
def test_composite_transparency(standard, bound):
    plan, _, _, comp = _composite(standard)
    out = trf.rf_roundtrip(trf.make_rf_plan(plan), comp, 0)
    assert psnr(_crop(out), _crop(comp)) >= bound


def test_rgb_round_trip_matches_direct(ntsc):
    _, dec, x, comp, rfp, rf = ntsc
    out = trf.rf_demodulate(rfp, rf, 0)
    p_rf = psnr(dec(out, 0)[:, :, 2:-2], x[:, :, 2:-2])
    assert p_rf >= psnr(dec(comp, 0)[:, :, 2:-2], x[:, :, 2:-2]) - 0.2


def test_detectors_and_phase(ntsc):
    _, dec, x, comp, rfp, rf = ntsc
    th = np.pi / 3

    def tp(detection, phase_error=0.0):
        out = trf.rf_demodulate(rfp, rf, 0, detection, phase_error)
        return psnr(_crop(out), _crop(comp)), out

    sync_clean, _ = tp("sync")
    sync_bad, _ = tp("sync", th)
    envl_clean, out0 = tp("envelope")
    _, out1 = tp("envelope", th)
    assert sync_clean >= 63.0 and sync_bad < 15.0
    assert 35.0 <= envl_clean < sync_clean
    torch.testing.assert_close(out1, out0, rtol=0, atol=1e-5)
    assert psnr(dec(out0, 0)[:, :, 2:-2], x[:, :, 2:-2]) >= 35.0
    # the carrier's (-1)^row law is what the detector locks to
    assert psnr(_crop(trf.rf_demodulate(rfp, -rf, 0)), _crop(comp)) < 15.0
    with pytest.raises(ValueError, match="unknown detection"):
        trf.rf_demodulate(rfp, rf, 0, "product")


def test_carrier_phase_recovery_matches_jax(ntsc):
    _, _, _, comp, rfp, _ = ntsc
    th = np.pi / 3
    rf_rot = trf.rf_modulate(dataclasses.replace(rfp, ramp=rfp.ramp + th), comp, 0)
    est = trf.recover_carrier_phase(rfp, rf_rot, 0).numpy()
    assert np.allclose(est, th, atol=np.deg2rad(2.0))
    jp = jrf.make_rf_plan(get_plan("ntsc"))
    jest = np.asarray(jrf.recover_carrier_phase(jp, jnp.asarray(rf_rot.numpy()), 0))
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-5)
    locked = trf.rf_demodulate(rfp, rf_rot, 0, "sync", float(est[0]))
    assert psnr(_crop(locked), _crop(comp)) >= 55.0


def test_frequency_offset_aft_and_retune(ntsc):
    _, _, _, comp, rfp, _ = ntsc
    df = 20e3
    rf = trf.rf_modulate(rfp, comp, 0, df=df)
    jp = jrf.make_rf_plan(get_plan("ntsc"))
    np.testing.assert_allclose(
        rf.numpy(), np.asarray(jrf.rf_modulate(jp, jnp.asarray(comp.numpy()), 0, df=df)),
        rtol=0, atol=1e-5)
    assert psnr(_crop(trf.rf_demodulate(rfp, rf, 0)), _crop(comp)) < 12.0
    assert psnr(_crop(trf.rf_demodulate(rfp, rf, 0, "envelope")), _crop(comp)) >= 25.0
    est = trf.recover_carrier_frequency(rfp, rf, 0).numpy()
    assert np.all(np.abs(est - df) < 5.0)
    jest = np.asarray(jrf.recover_carrier_frequency(jp, jnp.asarray(rf.numpy()), 0))
    np.testing.assert_allclose(est, jest, rtol=0, atol=0.05)
    dfh = float(est[0])
    th = float(trf.recover_carrier_phase(rfp, rf, 0, dfh)[0])
    p_mix = psnr(_crop(trf.rf_demodulate(rfp, rf, 0, "sync", th, freq_error=dfh)), _crop(comp))
    assert p_mix >= 28.0
    tuned = trf.rf_retune(rfp, rf, dfh, 0)
    np.testing.assert_allclose(
        tuned.numpy(), np.asarray(jrf.rf_retune(jp, jnp.asarray(rf.numpy()), dfh, 0)),
        rtol=0, atol=1e-5)
    th2 = float(trf.recover_carrier_phase(rfp, tuned, 0)[0])
    assert psnr(_crop(trf.rf_demodulate(rfp, tuned, 0, "sync", th2)), _crop(comp)) >= 50.0


def test_frame0_keys_the_carrier_law(ntsc):
    _, _, _, comp, rfp, rf = ntsc
    solo = trf.rf_modulate(rfp, comp[1:], 1)
    assert torch.equal(rf[1:], solo)
    both = trf.rf_modulate(rfp, comp, 0, df=7e3)
    two = trf.rf_modulate(rfp, comp[1:], 1, df=7e3)
    torch.testing.assert_close(both[1:], two, rtol=0, atol=2e-5)


def test_rastered_lines():
    plan, dec, x, comp = _composite("ntsc", "comb3", raster=True)
    rp = make_raster(plan)
    assert comp.shape[-1] == rp.n_total
    rfp = trf.make_rf_plan(plan, row_samples=rp.n_total)
    out = trf.rf_roundtrip(rfp, comp, 0)
    assert psnr(_crop(out), _crop(comp)) >= 45.0
    p = psnr(dec(out, 0)[:, :, 2:-2], x[:, :, 2:-2])
    assert p >= psnr(dec(comp, 0)[:, :, 2:-2], x[:, :, 2:-2]) - 1.0
    with pytest.raises(ValueError, match="row_samples"):
        trf.rf_modulate(trf.make_rf_plan(plan), comp, 0)


def test_sync_tip_agc_on_a_rastered_composite():
    plan, _, _, comp = _composite("ntsc", "comb3", raster=True)
    rfp = trf.make_rf_plan(plan, row_samples=make_raster(plan).n_total)
    rf = trf.rf_modulate(rfp, comp, 0)
    assert psnr(_crop(trf.rf_demodulate(rfp, rf, 0, agc=True)), _crop(comp)) >= 44.0
    weak = 0.7 * rf
    assert psnr(_crop(trf.rf_demodulate(rfp, weak, 0)), _crop(comp)) < 20.0
    assert psnr(_crop(trf.rf_demodulate(rfp, weak, 0, agc=True)), _crop(comp)) >= 40.0
    jp = jrf.make_rf_plan(get_plan("ntsc"), row_samples=rfp.row_samples)
    np.testing.assert_allclose(
        trf.rf_demodulate(rfp, weak, 0, agc=True).numpy(),
        np.asarray(jrf.rf_demodulate(jp, jnp.asarray(weak.numpy()), 0, agc=True)),
        rtol=0, atol=2e-5)


def test_row_quantile_matches_jnp_quantile():
    x = torch.tensor(np.random.default_rng(4).standard_normal((3, 10_001)), dtype=torch.float32)
    for q in (0.975, 0.25, 0.5):
        np.testing.assert_allclose(trf._row_quantile(x, q).numpy(),
                                   np.asarray(jnp.quantile(jnp.asarray(x.numpy()), q, axis=-1)),
                                   rtol=0, atol=1e-6)


def test_dropouts_and_doc(ntsc):
    _, dec, x, _, rfp, rf = ntsc
    assert torch.equal(trf.rf_demodulate(rfp, rf, 0, doc=True), trf.rf_demodulate(rfp, rf, 0))
    hit = trf.rf_dropout(rfp, rf, 7, rate=0.15, len_us=8.0)
    lost = (hit == 0) & (rf != 0)
    lines_hit = lost.any(dim=-1).float().mean()
    assert 0.08 < float(lines_hit) < 0.22
    again = trf.rf_dropout(rfp, rf, prng.PRNGKey(7), rate=0.15, len_us=8.0)
    assert torch.equal(hit, again)
    # JAX's dropouts from the same key, and its compensator on them
    jrfp = jrf.make_rf_plan(get_plan("ntsc"))
    j_hit = jrf.rf_dropout(jrfp, jnp.asarray(rf.numpy()), 7, rate=0.15, len_us=8.0)
    assert np.array_equal(hit.numpy(), np.asarray(j_hit))
    doc = trf.rf_demodulate(rfp, hit, 0, doc=True)
    assert _parity_db(doc, jrf.rf_demodulate(jrfp, j_hit, 0, doc=True)) >= 60.0

    def rgb_psnr(sig, use_doc):
        return psnr(dec(trf.rf_demodulate(rfp, sig, 0, doc=use_doc), 0)[:, :, 2:-2],
                    x[:, :, 2:-2])

    p_raw, p_doc = rgb_psnr(hit, False), rgb_psnr(hit, True)
    assert p_raw < 28.0 and p_doc - p_raw > 5.0, (p_raw, p_doc)


def test_ghost_and_cochannel_match_jax(ntsc):
    _, _, _, comp, rfp, rf = ntsc
    jp = jrf.make_rf_plan(get_plan("ntsc"))
    torch.testing.assert_close(
        trf.rf_ghost(rfp, rf, 3.0, 0.3),
        torch.tensor(np.asarray(jrf.rf_ghost(jp, jnp.asarray(rf.numpy()), 3.0, 0.3))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        trf.rf_cochannel(rfp, comp, 5, 1, 2).numpy(),
        np.asarray(jrf.rf_cochannel(jp, jnp.asarray(comp.numpy()), 5, 1, 2)), rtol=0, atol=1e-5)


def test_cochannel_precision_offset_cancels_temporally():
    plan = plan_from_numpy(get_plan("ntsc"))
    enc, _, _ = make_pipeline(plan, "notch", device="cpu")
    lines = 63  # odd rows per frame: the beat reverses frame to frame

    def static(seed):
        s = torch.tensor(smooth_scene(lines, 720, seed=seed), dtype=torch.float32)
        return enc(torch.stack([s, s]), 0)

    comp_w, comp_i = static(4), static(9)
    rfp = trf.make_rf_plan(plan)
    rf_w = trf.rf_modulate(rfp, comp_w, 0)
    clean_avg = trf.rf_demodulate(rfp, rf_w, 0).mean(dim=0)

    def residual(offset):
        out = trf.rf_demodulate(rfp, rf_w + 0.05 * trf.rf_cochannel(rfp, comp_i, 0, *offset), 0)
        return float(torch.mean((out.mean(dim=0) - clean_avg)[2:-2] ** 2))

    assert 10 * np.log10(residual((0, 1)) / residual((1, 2))) > 6.0
