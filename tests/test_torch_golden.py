"""The port's oracle (``color_modem_tpu_torch/golden/``) against the JAX
package's (``color_modem_tpu/golden/``), bit for bit.

Both are NumPy float64 code; each side takes its own package's plans
(the port's read through ``golden/modems.py::host_plan``), and every
public function must return what the JAX package's returns for the same
seeded inputs, compared with ``np.array_equal``.  Small sizes: 8 lines
(16 for the temporal combs and PALplus), 720 samples.
"""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

from color_modem_tpu import golden as jg
from color_modem_tpu.frame import a2 as j_a2
from color_modem_tpu.frame import mts as j_mts
from color_modem_tpu.frame import palplus as j_pp
from color_modem_tpu.frame import rf as j_rf
from color_modem_tpu.frame import satellite as j_sat
from color_modem_tpu.golden import mac as jg_mac
from color_modem_tpu.golden import modems as jg_modems
from color_modem_tpu.golden import palplus as jg_pp
from color_modem_tpu.golden import sound as jg_sound
from color_modem_tpu.golden import transmission as jg_tx
from color_modem_tpu.modem import mac_plan as j_mac_plan
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import ALL_STANDARDS as JAX_STANDARDS
from color_modem_tpu.standards.decoders import temporal_comb_spacing as jax_temporal

from color_modem_tpu_torch import ALL_STANDARDS
from color_modem_tpu_torch import golden as tg
from color_modem_tpu_torch.frame import a2 as t_a2
from color_modem_tpu_torch.frame import mts as t_mts
from color_modem_tpu_torch.frame import palplus as t_pp
from color_modem_tpu_torch.frame import rf as t_rf
from color_modem_tpu_torch.frame import satellite as t_sat
from color_modem_tpu_torch.golden import mac as tg_mac
from color_modem_tpu_torch.golden import modems as tg_modems
from color_modem_tpu_torch.golden import palplus as tg_pp
from color_modem_tpu_torch.golden import sound as tg_sound
from color_modem_tpu_torch.golden import transmission as tg_tx
from color_modem_tpu_torch.modem import mac_plan as t_mac_plan
from color_modem_tpu_torch.modem.plan import make_plan

L, N = 8, 720
TEMPORAL = ("comb3d", "comb3dA")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """``np.convolve`` takes its inner products from the BLAS; with the
    suite's worker processes sharing the cores, a threaded BLAS spins on
    every one of them (the long sound filters ran minutes instead of
    seconds).  Both oracles run under the same limit."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield

_PLANS = {}


def plans(name: str, n: int = N):
    """(JAX ModemPlan, port plan) for one standard, made once."""
    if (name, n) not in _PLANS:
        _PLANS[name, n] = (jax_make_plan(JAX_STANDARDS[name](), n),
                           make_plan(ALL_STANDARDS[name](), n))
    return _PLANS[name, n]


def same(a, b) -> None:
    """Bit-equal arrays, or tuples/lists of them, or equal scalars."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), f"max |diff| {np.max(np.abs(a.astype(float) - b)):.3e}"


def _rgb(lines: int = L, n: int = N, seed: int = 0, frames: int | None = None):
    rng = np.random.default_rng(seed)
    shape = (3, lines, n) if frames is None else (frames, 3, lines, n)
    return rng.uniform(0.0, 1.0, shape)


def _cases(temporal: bool):
    out = []
    for name in sorted(ALL_STANDARDS):
        for dec in tg.allowed_decoders(ALL_STANDARDS[name]()):
            if (dec in TEMPORAL) == temporal:
                out.append((name, dec))
    return out


# --- modems.py ------------------------------------------------------------------


@pytest.mark.parametrize("num, den, gline", [
    (455, 2, 0), (455, 2, 12345), (1135, 4, 3), (1135, 4, 10 ** 9 + 7),
    (909, 4, 625 * 1000 + 1), (2273, 8, 2 ** 40 + 5)])
def test_line_phase0_exact(num, den, gline):
    got = tg_modems.line_phase0_exact(num, den, gline)
    assert got == jg_modems.line_phase0_exact(num, den, gline)
    assert isinstance(got, float)


def test_conv_helpers():
    rng = np.random.default_rng(1)
    x, taps = rng.standard_normal(301), rng.standard_normal(31)
    same(tg_modems.conv_same(x, taps), jg_modems.conv_same(x, taps))
    same(tg_modems.conv_same_held(x, taps), jg_modems.conv_same_held(x, taps))


def test_host_plan_fields_equal_jax_plan():
    for name in sorted(ALL_STANDARDS):
        jp, tp = plans(name)
        view = tg_modems.host_plan(tp)
        assert tg_modems.host_plan(view) is view
        for key, value in vars(view).items():
            if key == "cfg":
                assert value.name == jp.cfg.name
            else:
                same(value, getattr(jp, key))


@pytest.mark.parametrize("name", ["ntsc", "pal", "niir", "pal_m"])
def test_qam_modem_methods(name):
    jp, tp = plans(name)
    jm, tm = jg_modems.GoldenQamModem(jp), tg_modems.GoldenQamModem(tp)
    rng = np.random.default_rng(2)
    y, c1, c2, comp = (rng.uniform(-0.5, 1.0, N) for _ in range(4))
    for g in (0, 1, 2, 525 * 7 + 3, 625 * 11 + 4):
        same(tm.carrier_phase(g), jm.carrier_phase(g))
        assert tm.v_sign(g) == jm.v_sign(g)
        assert tm.is_reference_line(g) == jm.is_reference_line(g)
        same(tm.modulate_components(g, y, c1, c2), jm.modulate_components(g, y, c1, c2))
        same(tm.separate_notch(comp), jm.separate_notch(comp))
        same(tm.demodulate_carrier(g, comp), jm.demodulate_carrier(g, comp))
        same(tm.demodulate_components(g, comp), jm.demodulate_components(g, comp))


@pytest.mark.parametrize("n", [720, 1440])
def test_secam_modem_methods(n):
    jp, tp = plans("secam", n)
    jm, tm = jg_modems.GoldenSecamModem(jp), tg_modems.GoldenSecamModem(tp)
    rng = np.random.default_rng(3)
    y, dr, db = rng.uniform(0.0, 1.0, n), rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    for g in (0, 1, 625 * 5 + 2, 625 * 5 + 3):
        assert tm.is_r_line(g) == jm.is_r_line(g)
        comp = jm.modulate_components(g, y, dr, db)
        same(tm.modulate_components(g, y, dr, db), comp)
        same(tm.demodulate_component(g, comp), jm.demodulate_component(g, comp))


# --- frame.py ---------------------------------------------------------------------


def test_reexports():
    for key in ("FM_DECODERS", "QAM_DECODERS"):
        assert getattr(tg, key) == getattr(jg, key)
    for name in sorted(ALL_STANDARDS):
        jp, tp = plans(name)
        assert tg.allowed_decoders(tp.cfg) == jg.allowed_decoders(jp.cfg)
        assert tg.comb_spacing(tp.cfg) == jg.comb_spacing(jp.cfg)


@pytest.mark.parametrize("name", sorted(ALL_STANDARDS))
def test_encode_frame(name):
    jp, tp = plans(name)
    rgb = _rgb(seed=4)
    same(tg.encode_frame(tp, rgb, frame=3), jg.encode_frame(jp, rgb, frame=3))


@pytest.mark.parametrize("name, decoder", _cases(temporal=False))
def test_decode_frame(name, decoder):
    jp, tp = plans(name)
    comp = jg.encode_frame(jp, _rgb(seed=5), frame=2)
    comp = comp + 0.01 * np.random.default_rng(6).standard_normal(comp.shape)
    same(tg.decode_frame(tp, comp, frame=2, decoder=decoder),
         jg.decode_frame(jp, comp, frame=2, decoder=decoder))


@pytest.mark.parametrize("name, decoder", _cases(temporal=True) + [("pal", "delayline")])
def test_decode_sequence(name, decoder):
    jp, tp = plans(name)
    pt = jax_temporal(jp.cfg) or 1
    frames = 2 * pt + 1
    comps = np.stack([jg.encode_frame(jp, x, frame=5 + f)
                      for f, x in enumerate(_rgb(lines=16, seed=7, frames=frames))])
    same(tg.decode_sequence(tp, comps, frame0=5, decoder=decoder),
         jg.decode_sequence(jp, comps, frame0=5, decoder=decoder))


def test_frame_refusals_match():
    jp, tp = plans("ntsc")
    comp = np.zeros((L, N))
    for fn, args, exc in ((lambda g, p: g.decode_frame(p, comp, decoder="interp"), (), ValueError),
                          (lambda g, p: g.decode_frame(p, comp, decoder="comb3d"), (),
                           NotImplementedError),
                          (lambda g, p: g.decode_sequence(p, comp[None]), (), ValueError)):
        with pytest.raises(exc) as e_t:
            fn(tg, tp)
        with pytest.raises(exc) as e_j:
            fn(jg, jp)
        assert str(e_t.value) == str(e_j.value)


# --- transmission.py ------------------------------------------------------------------


@pytest.fixture(scope="module")
def rf_plans():
    jp, tp = plans("ntsc")
    return j_rf.make_rf_plan(jp), t_rf.make_rf_plan(tp)


def _comp(frames: int = 2, seed: int = 8):
    jp, _ = plans("ntsc")
    return np.stack([jg.encode_frame(jp, x) for x in _rgb(seed=seed, frames=frames)])


def test_rf_chain(rf_plans):
    jr, tr = rf_plans
    comp = _comp()
    rf = jg_tx.rf_modulate(jr, comp, 3)
    same(tg_tx.rf_modulate(tr, comp, 3), rf)
    rf32 = rf.astype(np.float32)
    same(tg_tx.rf_demodulate(tr, rf32, 3), jg_tx.rf_demodulate(jr, rf32, 3))


@pytest.mark.parametrize("audio_subs", [0, 2])
def test_satellite_chain(audio_subs):
    jp, tp = plans("ntsc")
    js = j_sat.make_sat_plan(jp.fs, N, audio_subs=audio_subs)
    ts = t_sat.make_sat_plan(tp.fs, N, audio_subs=audio_subs)
    comp = _comp(seed=9)
    fm = jg_tx.fm_modulate(js, comp)
    same(tg_tx.fm_modulate(ts, comp), fm)
    fm32 = fm.astype(np.float32)
    same(tg_tx.fm_demodulate(ts, fm32), jg_tx.fm_demodulate(js, fm32))


# --- sound.py ---------------------------------------------------------------------


def _tones(b: int, t: int, fs: float, freqs) -> np.ndarray:
    tt = np.arange(t, dtype=np.float64) / fs
    return np.stack([0.6 * np.sin(2.0 * np.pi * f * tt) + 0.2 * np.sin(5.4 * np.pi * f * tt)
                     for f in freqs[:b]]).astype(np.float32)


def test_intercarrier_sound(rf_plans):
    jr, tr = rf_plans
    audio = _tones(2, L * N, jr.plan.fs, (700.0, 1700.0))
    rf0 = np.zeros((2, L, jr.n_rf), np.float32)
    rf = jg_sound.sound_on_rf(jr, rf0, 3, audio, 1.234)
    same(tg_sound.sound_on_rf(tr, rf0, 3, audio, 1.234), rf)
    rf32 = rf.astype(np.float32)
    same(tg_sound.sound_from_rf(tr, rf32, 3), jg_sound.sound_from_rf(jr, rf32, 3))


def test_mts():
    jp, tp = plans("ntsc")
    left = _tones(1, 4 * L * N, jp.fs, (900.0,))  # longer than the 16385 taps
    right = _tones(1, 4 * L * N, jp.fs, (2400.0,))
    a = jg_sound.mts_encode(N, left, right)
    same(tg_sound.mts_encode(N, left, right), a)
    a32 = a.astype(np.float32)
    same(tg_sound.mts_decode(N, t_mts._channel_lpf(tp.fs), a32),
         jg_sound.mts_decode(N, j_mts._channel_lpf(jp.fs), a32))


def test_satellite_audio():
    jp, tp = plans("ntsc")
    js = j_sat.make_sat_plan(jp.fs, N, audio_subs=2)
    ts = t_sat.make_sat_plan(tp.fs, N, audio_subs=2)
    base = _comp(seed=10)
    k = np.arange(L * N, dtype=np.float64)
    audio = np.stack([0.7 * np.sin(2 * np.pi * 9 * k / (L * N)),
                      0.5 * np.cos(2 * np.pi * 5 * k / (L * N))])[None]
    audio = np.broadcast_to(audio, (2, 2, L * N)).astype(np.float32)
    fm = jg_sound.sat_fm_modulate_audio(js, base, audio)
    same(tg_sound.sat_fm_modulate_audio(ts, base, audio), fm)
    fm32 = fm.astype(np.float32)
    same(tg_sound.sat_fm_demodulate_audio(ts, fm32), jg_sound.sat_fm_demodulate_audio(js, fm32))


@pytest.mark.parametrize("mode", ["stereo", "dual"])
def test_a2(rf_plans, mode):
    jr, tr = rf_plans
    ja, ta = j_a2.make_a2_plan(jr), t_a2.make_a2_plan(tr)
    audio2 = _tones(1, L * N, jr.plan.fs, (1300.0,))
    same(tg_sound.a2_multiplex(ta, audio2, mode, 3, 1, L),
         jg_sound.a2_multiplex(ja, audio2, mode, 3, 1, L))
    rf0 = np.zeros((1, L, jr.n_rf), np.float32)
    rf = jg_sound.a2_on_rf(ja, rf0, 3, audio2, mode)
    same(tg_sound.a2_on_rf(ta, rf0, 3, audio2, mode), rf)
    rf32 = rf.astype(np.float32)
    same(tg_sound.a2_takeoff2(ta, rf32, 3), jg_sound.a2_takeoff2(ja, rf32, 3))


# --- mac.py -----------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["d2", "d"])
def test_mac(variant):
    jp, tp = j_mac_plan.make_mac_plan(N, variant), t_mac_plan.make_mac_plan(N, variant)
    rgb = _rgb(seed=11)
    rng = np.random.default_rng(12)
    cap = jp.cfg.data_symbols - len(jp.cfg.line_sync_word)
    payload = rng.integers(0, 2, (L, cap)).tolist()
    ycc = np.einsum("ij,jlw->ilw", jp.rgb_to_ycc, rgb)
    same(tg_mac.encode_line(tp, ycc[0, 0], ycc[1, 0], ycc[2, 0], 5, payload[0]),
         jg_mac.encode_line(jp, ycc[0, 0], ycc[1, 0], ycc[2, 0], 5, payload[0]))
    for pl in (None, payload):
        sig = jg_mac.encode_frame(jp, rgb, 7, pl)
        same(tg_mac.encode_frame(tp, rgb, 7, pl), sig)
        same(tg_mac.decode_frame(tp, sig, 7), jg_mac.decode_frame(jp, sig, 7))
    for line in sig[:3]:
        assert tg_mac.decode_data_line(tp, line) == jg_mac.decode_data_line(jp, line)


# --- palplus.py ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def palplus_case():
    jp, tp = plans("pal")
    lines = 32
    rgb = np.clip(_rgb(lines=lines, seed=13)
                  + 0.25 * np.cos(2 * np.pi * 0.42 * np.arange(lines))[None, :, None], 0, 1)
    return jp, tp, rgb, j_pp._helper_taps(jp), t_pp._helper_taps(tp)


def test_palplus_helper_bank(palplus_case):
    _, _, rgb, _, _ = palplus_case
    y = rgb[0]
    down, helper = jg_pp.helper_encode(32, y)
    same(tg_pp.helper_encode(32, y), (down, helper))
    same(tg_pp.helper_reconstruct(32, down, helper), jg_pp.helper_reconstruct(32, down, helper))


def test_palplus_encode(palplus_case):
    jp, tp, rgb, jt, tt = palplus_case
    same(tt, jt)
    same(tg_pp.encode_palplus(tp, rgb, tt, frame=3, helper_gain=1.5),
         jg_pp.encode_palplus(jp, rgb, jt, frame=3, helper_gain=1.5))
    same(tg_pp.encode_palplus_fields(tp, rgb, tt, frame=3),
         jg_pp.encode_palplus_fields(jp, rgb, jt, frame=3))


@pytest.mark.parametrize("decoder, use_helper", [("notch", True), ("comb3", True),
                                                 ("comb3", False)])
def test_palplus_decode(palplus_case, decoder, use_helper):
    jp, tp, rgb, jt, tt = palplus_case
    comp = jg_pp.encode_palplus(jp, rgb, jt, frame=3)
    same(tg_pp.decode_palplus(tp, comp, tt, frame=3, decoder=decoder, use_helper=use_helper),
         jg_pp.decode_palplus(jp, comp, jt, frame=3, decoder=decoder, use_helper=use_helper))
