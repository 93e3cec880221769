"""The port's satellite FM hop (``color_modem_tpu_torch/frame/satellite.py``)
against the JAX package and the frozen naive chain
``golden/transmission.py``, on the CPU.

Bounds (tests/test_golden_transmission.py and tests/test_satellite.py):
the plan's arrays bit-identical; ``fm_modulate`` > 60 dB parity against
golden and JAX (the port keeps the phase integral in float64, the JAX
package in float32, so the modulated signal cannot match bit for bit),
``fm_demodulate`` > 95 dB;
MAC transparency >= 54 dB with the picture within 1.2 dB of the direct
path; the FM improvement >= 10 dB above the CNR; the audio subcarrier
ladder > 60 dB (modulate) and > 100 dB (demodulate) against golden
``golden/sound.py`` and JAX, and its SNRs at tests/test_satellite.py's
bounds.  The port's noise comes
from ``torch.Generator``, so noisy runs are held by their statistics and
effect, not bitwise.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import satellite as jsat
from color_modem_tpu.frame.pipeline import make_pipeline as jmake_pipeline
from color_modem_tpu.golden import transmission as gt
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import satellite as tsat
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem import mac
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr

L, W = 48, 720
PLAN_ARRAYS = ("interp_taps", "rx_taps", "iq_taps", "dec_taps", "pre_taps", "de_taps",
               "dec2_taps", "mux_lpf", "sub_lpf", "aud_rx", "aud_pre")
COMPOSED = ("tx_video_taps", "rx_video_taps", "interp_up_taps", "h_demod_taps",
            "dec_down_taps", "h_demod2_taps", "dec_down2_taps")


def _parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


@pytest.fixture(scope="module")
def comp():
    """2 x 16 x 720 NTSC composite (the golden-parity fixture)."""
    rgb = np.stack([smooth_scene(16, 720, seed=s) for s in (0, 1)]).astype(np.float32)
    enc, _, _ = jmake_pipeline(get_plan("ntsc"), "notch")
    return np.asarray(enc(jnp.asarray(rgb), 0))


@pytest.fixture(scope="module")
def mac_link():
    plan = mac.make_mac_plan(W)
    img = torch.tensor(smooth_scene(L, W, seed=3).astype(np.float32))
    g = torch.arange(L)
    sp = tsat.make_sat_plan(plan.cfg.fs, plan.cfg.samples_per_line)
    return plan, img, g, mac.encode(plan, img[None], g[None]), sp


@pytest.mark.parametrize("args,kw", [
    ((13.5e6, 720), {}),
    ((20.25e6, 1296), {"dispersal": 0.1}),
    ((27e6, 1440), {"audio_subs": 2}),
    ((13.5e6, 720), {"r": 8, "deviation": 10e6}),
], ids=["ntsc", "mac", "subs", "r8"])
def test_plan_is_bit_identical(args, kw):
    jp, tp = jsat.make_sat_plan(*args, **kw), tsat.make_sat_plan(*args, **kw)
    for f in ("base_fs", "n_base", "r", "fs_rf", "n_rf", "deviation", "center",
              "dispersal", "total_lines", "sub_freqs", "sub_dev", "sub_amp", "audio_bw"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in PLAN_ARRAYS:
        a, b = getattr(tp, f), getattr(jp, f)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), f
    for m in COMPOSED:
        assert np.array_equal(getattr(tp, m)(), getattr(jp, m)()), m
        assert getattr(tp, m)() is getattr(tp, m)()  # built once per plan


def test_plan_validation_matches_jax():
    with pytest.raises(ValueError, match="power of two"):
        tsat.make_sat_plan(13.5e6, 720, r=3)
    with pytest.raises(ValueError, match="scaled subcarrier slots"):
        tsat.make_sat_plan(13.5e6, 720, audio_subs=3)
    with pytest.raises(ValueError, match="too close"):
        tsat.make_sat_plan(27e6, 1440, audio_subs=2, sub_freqs=(6.5e6, 6.6e6))


def test_fm_modulate_and_demodulate_match_jax_and_golden(comp):
    sp, jp = tsat.make_sat_plan(13.5e6, 720), jsat.make_sat_plan(13.5e6, 720)
    t_fm = tsat.fm_modulate(sp, torch.tensor(comp)).numpy()
    g_fm = gt.fm_modulate(sp, comp)
    assert _parity_db(t_fm, g_fm) > 60.0
    assert _parity_db(t_fm, np.asarray(jsat.fm_modulate(jp, jnp.asarray(comp)))) > 60.0
    g32 = g_fm.astype(np.float32)
    t_v = tsat.fm_demodulate(sp, torch.tensor(g32)).numpy()
    assert t_v.shape == comp.shape
    assert _parity_db(t_v, gt.fm_demodulate(sp, g32)) > 95.0
    assert _parity_db(t_v, np.asarray(jsat.fm_demodulate(jp, jnp.asarray(g32)))) > 95.0


def test_multiplex_plan_video_matches_golden(comp):
    """Subcarriers designed: the mux/reject low-passes join both video
    paths (composed with the emphasis here, separate in the oracle)."""
    sp = tsat.make_sat_plan(27e6, 1440, audio_subs=1)
    base = np.concatenate([comp[:, :, :720]] * 2, axis=-1).astype(np.float32)
    t_fm = tsat.fm_modulate(sp, torch.tensor(base)).numpy()
    g_fm = gt.fm_modulate(sp, base)
    assert _parity_db(t_fm, g_fm) > 60.0
    g32 = g_fm.astype(np.float32)
    assert _parity_db(tsat.fm_demodulate(sp, torch.tensor(g32)).numpy(),
                      gt.fm_demodulate(sp, g32)) > 95.0


def test_mac_transparency_and_picture(mac_link):
    plan, img, g, sig, sp = mac_link
    rx = tsat.sat_roundtrip(sp, sig)
    assert psnr(rx, sig) >= 54.0
    direct = psnr(mac.decode(plan, sig, g[None]), img[None])
    via = psnr(mac.decode(plan, rx, g[None]), img[None])
    assert via >= direct - 1.2, (via, direct)
    ok, _ = mac.decode_data(plan, rx)
    assert bool(ok.all())


@pytest.mark.parametrize("cnr_db", [25.0, 18.0])
def test_fm_advantage_above_threshold(mac_link, cnr_db):
    _, _, _, sig, sp = mac_link
    gen = torch.Generator().manual_seed(1)
    snr = psnr(tsat.sat_roundtrip(sp, sig, generator=gen, cnr_db=cnr_db), sig)
    assert snr >= cnr_db + 10.0, (cnr_db, snr)


def test_data_survives_satellite_noise(mac_link):
    plan, _, g, _, sp = mac_link
    img = torch.tensor(smooth_scene(L, W, seed=1).astype(np.float32))
    payload = torch.randint(0, 2, (1, L, 99), generator=torch.Generator().manual_seed(5))
    sig = mac.encode(plan, img[None], g[None], payload)
    rx = tsat.sat_roundtrip(sp, sig, generator=torch.Generator().manual_seed(2), cnr_db=20.0)
    ok, bits = mac.decode_data(plan, rx)
    assert bool(ok.all()) and torch.equal(bits, payload.to(torch.int32))


def test_dispersal_removed_by_the_mac_clamp(mac_link):
    plan, img, g, sig, sp0 = mac_link
    sp1 = tsat.make_sat_plan(plan.cfg.fs, plan.cfg.samples_per_line, dispersal=0.1)
    raw0 = tsat.sat_roundtrip(sp0, sig, gline=g[None])
    raw1 = tsat.sat_roundtrip(sp1, sig, gline=g[None])
    p0 = psnr(mac.decode(plan, raw0, g[None]), img[None])
    p1 = psnr(mac.decode(plan, raw1, g[None]), img[None])
    assert abs(p0 - p1) < 0.1, (p0, p1)
    assert float(torch.max(torch.abs(raw0 - raw1))) > 0.05
    jp = jsat.make_sat_plan(plan.cfg.fs, plan.cfg.samples_per_line, dispersal=0.1)
    gl = np.arange(3000)[None]
    np.testing.assert_array_equal(tsat.dispersal_offset(sp1, torch.tensor(gl)).numpy(),
                                  np.asarray(jsat.dispersal_offset(jp, jnp.asarray(gl))))


def test_secam_composite_transparency():
    plan = plan_from_numpy(get_plan("secam"))
    enc, dec, _ = make_pipeline(plan, "interp", device="cpu")
    img = torch.tensor(smooth_scene(L, W, seed=7).astype(np.float32))[None]
    c = enc(img, 0)
    rx = tsat.sat_roundtrip(tsat.make_sat_plan(plan.fs, W), c)
    assert psnr(dec(rx, 0), img) >= psnr(dec(c, 0), img) - 0.5


def test_frames_are_independent(comp):
    """The FM phase closes per frame: a batch is its frames side by side.
    The phase is summed in float64 and reduced mod 2 pi before float32
    holds it, so the FFTs' batch-dependent last bits stay at ~1e-6 in the
    demodulated video (a float32 phase of ~2.4 krad would carry them to
    ~1e-4)."""
    sp = tsat.make_sat_plan(13.5e6, 720)
    both = tsat.sat_roundtrip(sp, torch.tensor(comp))
    one = tsat.sat_roundtrip(sp, torch.tensor(comp[1:]))
    torch.testing.assert_close(both[1:], one, rtol=0, atol=1e-5)


def test_noise_sigma_and_awgn_statistics():
    sp, jp = tsat.make_sat_plan(13.5e6, 720), jsat.make_sat_plan(13.5e6, 720)
    for cnr in (8.0, 12.0, 20.0):
        assert tsat.noise_sigma(sp, cnr) == jsat.noise_sigma(jp, cnr)
    sigma = tsat.noise_sigma(sp, 12.0)
    x = torch.zeros(4, 64, 2880)
    n = tsat.awgn(sp, x, torch.Generator().manual_seed(3), 12.0) - x
    assert abs(float(n.mean())) < 0.01 * sigma
    assert abs(float(n.std()) / sigma - 1.0) < 0.01
    again = tsat.awgn(sp, x, torch.Generator().manual_seed(3), 12.0) - x
    assert torch.equal(n, again)


def test_rows_must_match_the_plan():
    with pytest.raises(ValueError, match="plan expects"):
        tsat.fm_modulate(tsat.make_sat_plan(13.5e6, 720), torch.zeros(1, 8, 700))


# --- the analog audio subcarriers -------------------------------------------------


def _bin_tone(f, amp, n_tot, fs):
    """A tone of a whole number of cycles over the frame stream (one period
    of the satellite layer's circular model)."""
    k = max(1, round(f * n_tot / fs))
    t = np.arange(n_tot) / fs
    return (amp * np.sin(2 * np.pi * (k * fs / n_tot) * t)).astype(np.float32)


@pytest.fixture(scope="module")
def sub_link():
    fs = 13.5e6
    sp = tsat.make_sat_plan(fs, W, audio_subs=2)
    base = torch.tensor(smooth_scene(L, W, seed=4).astype(np.float32)[0])[None]
    n_tot = L * W
    a = np.stack([_bin_tone(1000, 0.6, n_tot, fs) + _bin_tone(7000, 0.3, n_tot, fs),
                  _bin_tone(3000, 0.5, n_tot, fs)])
    rf = tsat.fm_modulate(sp, base, audio=torch.tensor(a)[None])
    return sp, base, a, rf


def _audio_snr(ref, out):
    ref = ref - ref.mean()  # the receiver is AC-coupled
    err = np.asarray(out) - ref
    return 10 * np.log10(np.mean(ref ** 2) / np.mean(err ** 2))


def test_audio_ladder_matches_golden_and_jax(comp):
    """fm_modulate(audio=) > 60 dB and fm_demodulate_audio > 100 dB against
    golden/sound.py (tests/test_golden_sound.py), and the same against JAX;
    the subcarrier tables equal the JAX package's."""
    from color_modem_tpu.golden import sound as gs

    sp, jp = tsat.make_sat_plan(13.5e6, 720, audio_subs=1), jsat.make_sat_plan(
        13.5e6, 720, audio_subs=1)
    n_tot = 16 * 720
    tt = np.arange(n_tot, dtype=np.float64)
    audio = (0.7 * np.sin(2.0 * np.pi * 9 * tt / n_tot))[None, None, :]
    audio = np.broadcast_to(audio, (2, 1, n_tot)).astype(np.float32)
    k = tsat._sub_cycles(sp, sp.sub_freqs[0], n_tot)
    for got, want in zip(tsat._sub_trig(k, n_tot, torch.device("cpu")),
                         jsat._sub_trig(k, n_tot)):
        assert np.array_equal(got.numpy(), want)
    t_fm = tsat.fm_modulate(sp, torch.tensor(comp), audio=torch.tensor(audio))
    g_fm = gs.sat_fm_modulate_audio(jp, comp, audio)
    assert _parity_db(t_fm, g_fm) > 60.0
    assert _parity_db(t_fm, jsat.fm_modulate(jp, jnp.asarray(comp),
                                             audio=jnp.asarray(audio))) > 60.0
    g32 = g_fm.astype(np.float32)
    t_a = tsat.fm_demodulate_audio(sp, torch.tensor(g32))
    assert t_a.shape == (2, 1, n_tot)
    assert _parity_db(t_a, gs.sat_fm_demodulate_audio(jp, g32)) > 100.0
    assert _parity_db(t_a, jsat.fm_demodulate_audio(jp, jnp.asarray(g32))) > 100.0


def test_audio_subcarriers_clean(sub_link):
    """Noise-free: >= 58/55 dB audio, the video >= 57 dB through the
    multiplex low-pass (tests/test_satellite.py)."""
    sp, base, a, rf = sub_link
    assert psnr(tsat.fm_demodulate(sp, rf), base) >= 57.0
    aud = tsat.fm_demodulate_audio(sp, rf)
    s0, s1 = _audio_snr(a[0], aud[0, 0]), _audio_snr(a[1], aud[0, 1])
    assert s0 >= 58.0 and s1 >= 55.0, (s0, s1)


def test_audio_subcarriers_under_noise(sub_link):
    """CNR 14 dB: audio >= 46/43 dB, the higher subcarrier the noisier (the
    discriminator's triangular noise spectrum), the video >= 28 dB."""
    sp, base, a, rf = sub_link
    rfn = tsat.awgn(sp, rf, torch.Generator().manual_seed(7), 14.0)
    aud = tsat.fm_demodulate_audio(sp, rfn)
    s0, s1 = _audio_snr(a[0], aud[0, 0]), _audio_snr(a[1], aud[0, 1])
    assert s0 >= 46.0 and s1 >= 43.0 and s0 > s1, (s0, s1)
    assert psnr(tsat.fm_demodulate(sp, rfn), base) >= 28.0


def test_audio_emphasis_pair_flat(sub_link):
    """50 us pre-emphasis times (de-emphasis * audio LPF) is flat to 2 %
    through the audio band."""
    from color_modem_tpu.dsp.design import freqz

    sp = sub_link[0]
    f = np.linspace(100.0, 12e3, 40)
    prod = np.abs(freqz(sp.aud_pre, sp.base_fs, f)) * np.abs(freqz(sp.aud_rx, sp.base_fs, f))
    assert np.max(np.abs(prod - 1.0)) < 0.02


def test_audio_needs_designed_subcarriers():
    sp0 = tsat.make_sat_plan(13.5e6, 720)
    with pytest.raises(ValueError, match="no audio subcarriers"):
        tsat.fm_modulate(sp0, torch.zeros(1, 8, 720), audio=torch.zeros(1, 1, 8 * 720))
    with pytest.raises(ValueError, match="no audio subcarriers"):
        tsat.fm_demodulate_audio(sp0, torch.zeros(1, 8, 2880))
    sp = tsat.make_sat_plan(13.5e6, 720, audio_subs=2)
    with pytest.raises(ValueError, match="audio shape"):
        tsat.fm_modulate(sp, torch.zeros(1, 8, 720), audio=torch.zeros(1, 1, 8 * 720))
