"""The port's NICAM-728 (``color_modem_tpu_torch/frame/nicam.py``) against
the JAX package, on the CPU.

Bounds: the digital chain (companding, parity and signalling, interleave,
scrambler, frames, parse) equal to JAX's bit for bit; the passband against
JAX to 1e-3: the port counts the DQPSK symbol phase in exact quarter
turns, JAX sums the increments as float32 radians, which drift by +pi/4
per symbol on average (1814 rad after 2184 symbols) and are off by up to
~2e-4 rad there (the passbands then differ by 2.4e-4); the demodulated
frames and the FAW offset equal; the behaviour tests of
tests/test_nicam.py at their bounds (companding > 50 dB, audio > 55 dB,
parity errors 0 on a clean or mildly noisy channel and counted under heavy
noise, the picture under the RF burst within 0.2 dB).  Channel noise draws
from a ``torch.Generator``, so the noise cases are held by their effect.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import nicam as jn
from color_modem_tpu.frame import rf as jrf
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import nicam as tn
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate, rf_modulate
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr

PASSBAND_ATOL = 1e-3


def _tones(n_frames=6, fl=997.0, fr=1503.0, al=0.7, ar=0.05):
    t = np.arange(tn.BLOCK * n_frames) / 32000.0
    return ((al * np.sin(2 * np.pi * fl * t)).astype(np.float32),
            (ar * np.sin(2 * np.pi * fr * t)).astype(np.float32))


def _snr(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return 10 * np.log10(np.mean(ref ** 2) / np.mean((ref - got) ** 2))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def plan():
    return plan_from_numpy(get_plan("pal"))


# --- the digital chain, bit for bit ------------------------------------------


def test_tables_match_jax():
    assert np.array_equal(tn._prbs(), jn._prbs())
    assert np.array_equal(tn._interleave_order(), jn._interleave_order())
    assert np.array_equal(tn._DILV, jn._DILV)
    assert (tn.FAW, tn.FRAME_BITS, tn.N_HEADER, tn._SF_GROUPS) == (
        jn.FAW, jn.FRAME_BITS, jn.N_HEADER, jn._SF_GROUPS)
    for spb, beta in ((37, 1.0), (148, 0.4)):
        assert np.array_equal(tn._rrc_taps(spb, beta), jn._rrc_taps(spb, beta))


def test_compand_expand_match_jax():
    rng = np.random.default_rng(0)
    levels = np.array([0.0, 0.01, 0.05, 0.12, 0.3, 0.9, 1.2])[:, None]
    x = (levels * rng.uniform(-1, 1, (7, tn.BLOCK))).astype(np.float32)
    x[0, :4] = [0.5 / 8192, -0.5 / 8192, 1.5 / 8192, -2.5 / 8192]   # round half to even
    m, s = tn.compand(_t(x))
    jm, js = jn.compand(jnp.asarray(x))
    assert torch.equal(m, _t(jm)) and torch.equal(s, _t(js))
    assert torch.equal(tn.expand(m, s), _t(jn.expand(jm, js)))


def test_compand_quiet_block_is_lossless():
    x = torch.tensor(np.linspace(-511, 511, tn.BLOCK) / 8192.0, dtype=torch.float32)[None]
    mant, shift = tn.compand(x)
    assert int(shift[0]) == 0
    np.testing.assert_allclose(tn.expand(mant, shift)[0].numpy(), x[0].numpy(),
                               atol=0.5 / 8192.0)


def test_compand_loud_block_and_level_tracking():
    x = torch.tensor(0.9 * np.sin(np.linspace(0, 11.0, tn.BLOCK)), dtype=torch.float32)[None]
    mant, shift = tn.compand(x)
    assert int(shift[0]) == tn.MAX_SHIFT
    assert _snr(x, tn.expand(mant, shift)) > 50.0
    rng = np.random.default_rng(0)
    xs = torch.tensor(np.stack([a * rng.uniform(-1, 1, tn.BLOCK)
                                for a in (0.01, 0.05, 0.12, 0.3, 0.9)]), dtype=torch.float32)
    s = tn.compand(xs)[1].numpy()
    assert list(s) == sorted(s) and s[0] < s[-1]


@pytest.mark.parametrize("control", [0, 0b10110])
def test_frames_and_parse_match_jax(control):
    left, right = _tones(6, al=0.9, ar=0.02)
    fr = tn.nicam_frames(_t(left), _t(right), control=control)
    jfr = jn.nicam_frames(left, right, control=control)
    assert fr.dtype == torch.int32 and fr.shape == (6, tn.FRAME_BITS)
    assert torch.equal(fr, _t(jfr))
    # the sound bits before the interleave and scrambler, too
    la, ls = tn.compand(_t(left).reshape(6, tn.BLOCK))
    ra, rs = tn.compand(_t(right).reshape(6, tn.BLOCK))
    mant = torch.stack([la, ra], -1).reshape(6, 64)
    shift = torch.stack([ls, rs], -1)
    assert torch.equal(tn._sound_bits(mant, shift),
                       _t(jn._sound_bits(jnp.asarray(mant.numpy()), jnp.asarray(shift.numpy()))))
    bad = fr.clone()
    bad[1, 100] ^= 1
    bad[3, 5] ^= 1
    l2, r2, rep = tn.parse_frames(bad)
    jl, jr_, jrep = jn.parse_frames(jnp.asarray(bad.numpy()))
    assert torch.equal(l2, _t(jl)) and torch.equal(r2, _t(jr_))
    for k in ("faw_ok", "control", "parity_errors"):
        assert np.array_equal(rep[k].numpy(), np.asarray(jrep[k])), k


def test_frames_digital_roundtrip_exact():
    left, right = _tones()
    l2, r2, rep = tn.parse_frames(tn.nicam_frames(_t(left), _t(right)))
    assert bool(rep["faw_ok"].all()) and int(rep["parity_errors"].sum()) == 0
    assert _snr(left, l2) > 55.0 and _snr(right, r2) > 55.0


def test_scrambler_properties():
    seq = tn._prbs()
    assert seq.shape == (tn.FRAME_BITS - len(tn.FAW),)
    assert 0.45 < seq.mean() < 0.55
    left, right = _tones(2)
    body = tn.nicam_frames(_t(left), _t(right)).numpy()[:, len(tn.FAW):]
    assert 0.4 < body.mean() < 0.6


def test_interleave_spreads_a_sample():
    order = tn._interleave_order()
    assert sorted(order) == list(range(tn.N_SOUND))
    pos = np.argsort(order)
    assert np.abs(np.diff(np.sort(pos[:11]))).min() >= 16


def test_parity_flags_a_flipped_mantissa_bit():
    left, right = _tones(2)
    fr = tn.nicam_frames(_t(left), _t(right))
    target = tn.N_HEADER + int(np.argsort(tn._ILV)[3 * 11])
    bad = fr.clone()
    bad[1, target] = 1 - bad[1, target]
    rep = tn.parse_frames(bad)[2]
    assert int(rep["parity_errors"][1]) == 1 and int(rep["parity_errors"][0]) == 0


def test_scale_factor_survives_parity_bit_errors():
    left, right = _tones(2, al=0.9, ar=0.9)
    fr = tn.nicam_frames(_t(left), _t(right))
    sound_pos = tn.N_HEADER + np.argsort(tn._ILV)
    bad = fr.clone()
    for p in (int(sound_pos[0 * 11 + 10]), int(sound_pos[2 * 11 + 10])):
        bad[0, p] = 1 - bad[0, p]
    l2 = tn.parse_frames(bad)[0]
    assert _snr(left[: tn.BLOCK], l2[: tn.BLOCK]) > 40.0


def test_control_bits_roundtrip():
    left, right = _tones(2)
    rep = tn.parse_frames(tn.nicam_frames(_t(left), _t(right), control=0b10110))[2]
    assert list(rep["control"][0].numpy()) == [1, 0, 1, 1, 0]


# --- the passband ----------------------------------------------------------------


def test_plans_match_jax(plan):
    jplan = get_plan("pal")
    tp, jp = tn.make_nicam_plan(plan), jn.make_nicam_plan(jplan)
    assert (tp.fs, tp.fc, tp.spb) == (jp.fs, jp.fc, jp.spb)
    assert np.array_equal(tp.shaping, jp.shaping) and np.array_equal(tp.matched, jp.matched)
    trfp, jrfp = make_rf_plan(plan), jrf.make_rf_plan(jplan)
    tq, jq = tn.make_nicam_rf_plan(trfp), jn.make_nicam_rf_plan(jrfp)
    assert tq is tn.make_nicam_rf_plan(trfp)          # built once per RF plan
    assert (tq.fs, tq.fc, tq.spb) == (jq.fs, jq.fc, jq.spb)
    assert np.array_equal(tq.matched, jq.matched)
    assert tn._head_samples(tq) == jn._head_samples(jq)
    for shape in ((1, 64, 2880), (2, 576, 2880)):
        assert tn.nicam_capacity(trfp, shape) == jn.nicam_capacity(jrfp, shape)
    with pytest.raises(ValueError, match="Carson"):
        tn.make_nicam_rf_plan(trfp, offset=0.1e6)


def test_passband_and_demodulation_match_jax(plan):
    left, right = _tones()
    fr = tn.nicam_frames(_t(left), _t(right))
    tp, jp = tn.make_nicam_plan(plan), jn.make_nicam_plan(get_plan("pal"))
    x = tn.nicam_modulate(tp, fr, carrier_phase=0.4)
    jx = np.asarray(jn.nicam_modulate(jp, jnp.asarray(fr.numpy()), carrier_phase=0.4))
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=PASSBAND_ATOL)
    rx, lock = tn.nicam_demodulate(tp, x, n_frames=6)
    jrx, jlock = jn.nicam_demodulate(jp, jnp.asarray(jx), n_frames=6)
    assert torch.equal(rx, fr) and torch.equal(rx, _t(jrx))
    assert int(lock["offset_bits"]) == int(jlock["offset_bits"]) == 0
    assert float(lock["faw_score"]) == float(jlock["faw_score"]) == 48.0


def test_faw_search_finds_misaligned_stream(plan):
    left, right = _tones(5)
    fr = tn.nicam_frames(_t(left), _t(right))
    tp = tn.make_nicam_plan(plan)
    x = tn.nicam_modulate(tp, fr)
    cut = 7 * tp.spb
    rx, lock = tn.nicam_demodulate(tp, x[cut:], n_frames=3)
    jrx, jlock = jn.nicam_demodulate(jn.make_nicam_plan(get_plan("pal")),
                                     jnp.asarray(x[cut:].numpy()), n_frames=3)
    off = int(lock["offset_bits"])
    assert off == int(jlock["offset_bits"]) == (tn.FRAME_BITS - 2 * 7) % tn.FRAME_BITS
    assert torch.equal(rx, fr[1:4]) and torch.equal(rx, _t(jrx))
    # n_frames=None takes all but the last whole frame the stream holds
    n_bits = 2 * (x.shape[0] // tp.spb - 1)
    assert tn.nicam_demodulate(tp, x)[1]["n_frames"] == n_bits // tn.FRAME_BITS - 1


@pytest.mark.parametrize("phase_deg", [30.0, 117.0, -150.0])
def test_carrier_phase_immunity(plan, phase_deg):
    left, right = _tones(4)
    l2, r2, rep, lock = tn.nicam_roundtrip(plan, _t(left), _t(right),
                                           carrier_phase=np.deg2rad(phase_deg))
    assert bool(rep["faw_ok"].all()) and _snr(left, l2) > 55.0


def test_noise_performance(plan):
    left, right = _tones(4)
    l2, _, rep, _ = tn.nicam_roundtrip(plan, _t(left), _t(right), noise_sigma=0.05,
                                       generator=torch.Generator().manual_seed(1))
    assert int(rep["parity_errors"].sum()) == 0 and _snr(left, l2) > 55.0
    rep3 = tn.nicam_roundtrip(plan, _t(left), _t(right), noise_sigma=2.0,
                              generator=torch.Generator().manual_seed(2))[2]
    assert int(rep3["parity_errors"].sum()) > 0
    with pytest.raises(ValueError, match="Generator"):
        tn.nicam_roundtrip(plan, _t(left), _t(right), noise_sigma=0.05)


def test_nicam_rides_the_rf_channel(plan):
    """NICAM beside the FM sound carrier on the VSB stream: bits exact and
    equal to JAX's receiver on the same RF, the picture untouched."""
    rfp = make_rf_plan(plan)
    enc, dec, _ = make_pipeline(plan, "comb3", device="cpu")
    rgb = torch.tensor(smooth_scene(64, plan.n_samples, seed=3), dtype=torch.float32)[None]
    comp = enc(rgb, 0)
    rf = rf_modulate(rfp, comp, 0)
    cap = tn.nicam_capacity(rfp, rf.shape)
    assert cap >= 2
    left, right = _tones(cap, al=0.7, ar=0.3)
    rf2 = tn.nicam_on_rf(rfp, rf, _t(left), _t(right))
    jrfp = jrf.make_rf_plan(get_plan("pal"))
    j_rf2 = np.asarray(jn.nicam_on_rf(jrfp, jnp.asarray(rf.numpy()), left, right))
    np.testing.assert_allclose(rf2.numpy(), j_rf2, rtol=0, atol=PASSBAND_ATOL)
    p_with = psnr(dec(rf_demodulate(rfp, rf2, 0), 0)[0], rgb[0])
    p_without = psnr(dec(rf_demodulate(rfp, rf, 0), 0)[0], rgb[0])
    assert p_without - p_with < 0.2
    l2, r2, rep, lock = tn.nicam_from_rf(rfp, rf2, cap)
    assert int(rep["parity_errors"].sum()) == 0 and bool(rep["faw_ok"].all())
    assert _snr(left, l2) > 55.0 and _snr(right, r2) > 55.0
    jl, jr_, _, jlock = jn.nicam_from_rf(jrfp, jnp.asarray(rf2.numpy()), cap)
    assert torch.equal(l2, _t(jl)) and torch.equal(r2, _t(jr_))
    assert int(lock["offset_bits"]) == int(jlock["offset_bits"])
    with pytest.raises(ValueError, match="nicam_capacity"):
        l3, r3 = _tones(cap + 2)
        tn.nicam_on_rf(rfp, rf, _t(l3), _t(r3))
