"""The PyTorch port's VIR (``frame/vir.py``) and measurement suite
(``frame/measure.py``) against the JAX package's on the CPU.

The same composite (encoded and impaired by the JAX package) goes into
both readouts.  Bounds: the stimuli, the masks, the bar targets and the
instrument images drawn from the same composite are identical (the
spectrum to 1e-6 dB: both are float64 NumPy on the host); the VIR line
agrees to 1e-6 and its readout to 1e-5; the corrected decode to 5e-4 (the
RGB bound of tests/test_torch_pipeline.py); DG to 1e-5, DP and the step
phases to 0.01 deg, the step gains to 1e-5; each multiburst packet's gain
to 1e-5; the K-rating to 1e-3 %, P/B and the chroma/luma gain to 1e-5 and
the chroma/luma delay to 0.5 ns (a centroid of squared envelopes summed
over 50T).  The vectorscope histograms the demodulated chroma, which agrees
to ~1e-7, so a sample on a bin edge may move one count: its image agrees
to 0.05 per pixel.  The readouts also meet the JAX tests' own bounds
(tests/test_measure.py, tests/test_vir.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import measure as jm
from color_modem_tpu.frame import vir as jvir
from color_modem_tpu.frame.channel import impair as jax_impair
from color_modem_tpu.frame.channel import vhs_playback as jax_vhs
from color_modem_tpu.frame.pipeline import decode_block as jax_decode_block
from color_modem_tpu.frame.pipeline import encode_block as jax_encode_block
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.frame.raster import add_raster, make_raster
from color_modem_tpu_torch.frame import measure as tm
from color_modem_tpu_torch.frame import vir as tvir
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils.metrics import psnr
from torch_threads import one_torch_thread  # noqa: F401

L, N = 32, 720
RGB_ATOL = 5e-4


def t(x):
    return torch.tensor(np.asarray(x))


def _encoded(name, rgb, frame0=3, frames=2, **impairments):
    """(JAX plan, port plan, impaired composite, line indices) of ``rgb``
    (3, L, N) repeated over ``frames``."""
    jp = get_plan(name)
    g = jax_frame_line_index(jp, frame0, frames, rgb.shape[-2])
    comp = jax_encode_block(jp, jnp.asarray(np.stack([rgb] * frames)), g)
    if impairments:
        comp = jax_impair(jp, comp, **impairments)
    return jp, plan_from_numpy(jp), comp, g


# --- VIR ---------------------------------------------------------------------------

def test_vir_constants_are_identical():
    for n in (720, 1440, 960):
        for a, b in zip(tvir._masks(n), jvir._masks(n)):
            assert np.array_equal(a, b)
    assert (tvir.PEDESTAL_LUMA, tvir.CHROMA_AMP, tvir.LUMA_REF, tvir.BLACK_REF) == \
        (jvir.PEDESTAL_LUMA, jvir.CHROMA_AMP, jvir.LUMA_REF, jvir.BLACK_REF)


@pytest.mark.parametrize("impairments", [{}, dict(chroma_phase_deg=30.0, chroma_gain=0.6),
                                         dict(diff_phase_deg=20.0, diff_gain=-0.3)])
def test_vir_matches_jax(impairments):
    jp = get_plan("ntsc")
    tp = plan_from_numpy(jp)
    g = jax_frame_line_index(jp, 5, 2, L)
    lines_j = np.asarray(jvir.vir_lines(jp, g))
    np.testing.assert_allclose(tvir.vir_lines(tp, t(g)).numpy(), lines_j, rtol=0, atol=1e-6)
    rgb = np.random.default_rng(0).uniform(0.2, 0.8, (2, 3, L, N)).astype(np.float32)
    comp = np.array(jax_encode_block(jp, jnp.asarray(rgb), g))
    comp[:, :2] = lines_j[:, :2]
    comp = np.asarray(jax_impair(jp, jnp.asarray(comp), **impairments)) if impairments else comp
    rep_j = jvir.measure_vir(jp, jnp.asarray(comp[:, :2]), g[:, :2])
    rep = tvir.measure_vir(tp, t(comp[:, :2]), t(g)[:, :2])
    assert sorted(rep) == sorted(rep_j)
    for k in rep:
        np.testing.assert_allclose(rep[k].numpy(), np.asarray(rep_j[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    if not impairments:  # tests/test_vir.py: the clean line reads the spec
        assert abs(float(rep["chroma_gain_corr"][0]) - 1.0) < 0.02
        assert abs(float(rep["phase_err"][0])) < 0.02
    out_j = np.asarray(jvir.decode_vir_corrected(jp, jnp.asarray(comp), g, 2, "comb3"))
    for backend in ("kernel", "plain"):
        out = tvir.decode_vir_corrected(tp, t(comp), t(g), 2, "comb3", backend)
        np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=RGB_ATOL)


def test_vir_corrects_a_static_error():
    """tests/test_vir.py's correction loop: a 30-degree phase error costs
    the uncorrected picture over 10 dB that the VIR loop wins back."""
    from color_modem_tpu.utils.testimages import smooth_scene

    rgb = smooth_scene(L, N, seed=1).astype(np.float32)
    jp, tp, comp, g = _encoded("ntsc", rgb, frames=1)
    comp = np.array(comp)
    comp[:, :2] = np.asarray(jvir.vir_lines(jp, g[:, :2]))
    bad = np.asarray(jax_impair(jp, jnp.asarray(comp), chroma_phase_deg=30.0))
    ref = torch.tensor(rgb)[None, :, 2:]
    corr = tvir.decode_vir_corrected(tp, t(bad), t(g), 2, "comb3")
    from color_modem_tpu_torch.frame.pipeline import decode_block

    plain = decode_block(tp, t(bad)[:, 2:], t(g)[:, 2:], "comb3")
    assert psnr(corr, ref) - psnr(plain, ref) > 10.0


def test_vir_refuses_fm():
    tp = plan_from_numpy(get_plan("secam"))
    with pytest.raises(ValueError, match="QAM subcarrier"):
        tvir.vir_lines(tp, torch.zeros(1, 4, dtype=torch.int32))


# --- the measurement suite --------------------------------------------------------------

@pytest.mark.parametrize("name", ["ntsc", "pal", "niir", "secam"])
def test_stimuli_and_targets_are_identical(name):
    jp = get_plan(name)
    tp = plan_from_numpy(jp)
    assert np.array_equal(tm.multiburst(tp, 8), jm.multiburst(jp, 8))
    assert np.array_equal(tm.bar_vectors(tp), jm.bar_vectors(jp))
    assert tm._pb_layout(tp) == jm._pb_layout(jp)
    assert np.array_equal(tm.pulse_and_bar(tp, 4), jm.pulse_and_bar(jp, 4))
    if name != "secam":
        assert np.array_equal(tm.modulated_staircase(tp, 4, N),
                              jm.modulated_staircase(jp, 4, N))
        with pytest.raises(ValueError, match="clips RGB"):
            tm.modulated_staircase(tp, 4, N, 0.5, 0.5)


@pytest.mark.parametrize("name,impairments", [
    ("ntsc", {}), ("ntsc", dict(diff_phase_deg=20.0, diff_gain=0.3)),
    ("pal", dict(diff_phase_deg=-15.0)), ("niir", dict(diff_gain=0.4, diff_phase_deg=10.0)),
])
def test_differential_matches_jax(name, impairments):
    jp, tp, comp, g = _encoded(name, jm.modulated_staircase(get_plan(name), L, N),
                               **impairments)
    rep_j = jm.measure_differential(jp, comp, g)
    rep = tm.measure_differential(tp, t(comp), t(g))
    assert abs(rep["dg"] - rep_j["dg"]) <= 1e-5
    assert abs(rep["dp_deg"] - rep_j["dp_deg"]) <= 0.01
    np.testing.assert_allclose(rep["step_gain"], rep_j["step_gain"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rep["step_phase_deg"], rep_j["step_phase_deg"], rtol=0,
                               atol=0.01)
    if name == "ntsc" and not impairments:  # tests/test_measure.py
        assert rep["dg"] < 0.03 and rep["dp_deg"] < 2.0


@pytest.mark.parametrize("name,impairments", [
    ("ntsc", {}), ("ntsc", dict(ghost_delay_us=1.0, ghost_gain=0.25)), ("pal", {}),
    ("niir", {}), ("ntsc", "vhs"),
])
def test_pulse_bar_matches_jax(name, impairments):
    jp = get_plan(name)
    rgb = jm.pulse_and_bar(jp, L)
    if impairments == "vhs":
        jp, tp, comp, g = _encoded(name, rgb)
        comp = jax_vhs(jp, comp)
    else:
        jp, tp, comp, g = _encoded(name, rgb, **impairments)
    rep_j = jm.measure_pulse_bar(jp, comp, g)
    rep = tm.measure_pulse_bar(tp, t(comp), t(g))
    assert abs(rep["k2t_pct"] - rep_j["k2t_pct"]) <= 1e-3
    assert abs(rep["pulse_bar_ratio"] - rep_j["pulse_bar_ratio"]) <= 1e-5
    assert abs(rep["cl_gain"] - rep_j["cl_gain"]) <= 1e-5
    assert abs(rep["cl_delay_ns"] - rep_j["cl_delay_ns"]) <= 0.5
    if impairments == {}:  # tests/test_measure.py: a clean line reads flat
        assert rep["k2t_pct"] < 1.0 and abs(rep["cl_delay_ns"]) < 15.0


@pytest.mark.parametrize("name,decoder,vhs", [("ntsc", "notch", False), ("ntsc", "comb3", True),
                                              ("pal", "delayline", False),
                                              ("secam", "interp", False)])
def test_frequency_response_and_k_rating_match_jax(name, decoder, vhs):
    """The multiburst and the pulse-and-bar through a decode, read off the
    decoded luma plane (the SECAM half of the instrument reads K there)."""
    jp = get_plan(name)
    for stim, read in ((jm.multiburst(jp, L), "fr"), (jm.pulse_and_bar(jp, L), "k")):
        jp, tp, comp, g = _encoded(name, stim)
        if vhs:
            comp = jax_vhs(jp, comp)
        rgb = np.asarray(jax_decode_block(jp, comp, g, decoder))
        y = np.tensordot(jp.rgb_to_ycc[0], rgb, axes=(0, 1)).astype(np.float32)
        if read == "fr":
            want = jm.measure_frequency_response(jp, jnp.asarray(y))
            got = tm.measure_frequency_response(tp, torch.tensor(y))
            assert list(got) == list(want)
            for f in want:
                assert abs(got[f] - want[f]) <= 1e-5, f
            if not vhs and decoder != "notch":
                assert abs(got[1.0] - 1.0) < 0.05
        else:
            want = jm.measure_k_rating(jp, jnp.asarray(y))
            got = tm.measure_k_rating(tp, torch.tensor(y))
            assert abs(got["k2t_pct"] - want["k2t_pct"]) <= 1e-3
            assert abs(got["pulse_bar_ratio"] - want["pulse_bar_ratio"]) <= 1e-5


@pytest.mark.parametrize("name", ["ntsc", "pal"])
def test_instrument_images_match_jax(name):
    jp = get_plan(name)
    bars = np.zeros((3, L, N), np.float32)
    for k, (r, g_, b) in enumerate([[1, 1, 0], [0, 1, 1], [0, 1, 0], [1, 0, 1], [1, 0, 0],
                                    [0, 0, 1]]):
        bars[:, :, k * N // 6 : (k + 1) * N // 6] = 0.75 * np.array([r, g_, b])[:, None, None]
    jp, tp, comp, g = _encoded(name, bars)
    img_j = np.asarray(jm.vectorscope_image(jp, comp, g, size=128))
    img = tm.vectorscope_image(tp, t(comp), t(g), size=128)
    assert img.shape == (128, 128, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, img_j, rtol=0, atol=0.05)
    rastered = np.asarray(add_raster(jp, make_raster(jp), comp, g))
    f_j, db_j = jm.composite_spectrum(jp, rastered)
    f, db = tm.composite_spectrum(tp, t(rastered))
    assert np.array_equal(f, f_j)
    np.testing.assert_allclose(db, db_j, rtol=0, atol=1e-6)
    assert np.array_equal(tm.spectrum_image(tp, t(rastered), 128),
                          jm.spectrum_image(jp, rastered, 128))
    assert np.array_equal(tm.waveform_image(t(rastered), 128), jm.waveform_image(rastered, 128))


@pytest.mark.parametrize("call", [
    lambda m, p, c, g: m.measure_differential(p, c, g),
    lambda m, p, c, g: m.measure_pulse_bar(p, c, g),
    lambda m, p, c, g: m.vectorscope_image(p, c, g),
])
def test_secam_readouts_refused_like_jax(call):
    jp = get_plan("secam")
    comp = np.zeros((1, 8, N), np.float32)
    g = np.arange(8, dtype=np.int32)[None]
    with pytest.raises(ValueError, match="QAM"):
        call(jm, jp, jnp.asarray(comp), jnp.asarray(g))
    with pytest.raises(ValueError, match="QAM"):
        call(tm, plan_from_numpy(jp), t(comp), t(g))
