"""The PyTorch port's plan and phase law against the JAX package.

Host arrays must be bit-identical (same NumPy code), the float32 buffers
their exact casts, and the int32 phase law bit-equal up to line indices
near 2^31.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu.dsp import design as jdesign
from color_modem_tpu.dsp import nco as jnco
from color_modem_tpu.dsp.apply import toeplitz_same as jax_toeplitz_same
from color_modem_tpu.dsp.apply import toeplitz_same_held as jax_toeplitz_same_held
from color_modem_tpu.kernels.qam import _ramp_rows
from color_modem_tpu.modem import plan as jplan
from color_modem_tpu.standards import ALL_STANDARDS, SECAM
from color_modem_tpu_torch.dsp import design, nco
from color_modem_tpu_torch.dsp.apply import (
    fir_same,
    fir_same_held,
    toeplitz_same,
    toeplitz_same_held,
)
from color_modem_tpu_torch.modem import plan as tplan
from color_modem_tpu_torch.modem.plan import (
    FM_HOST_FIELDS,
    FM_TAPS,
    HOST_FIELDS,
    FmPlan,
    QamPlan,
    make_plan,
    plan_from_numpy,
)
from torch_threads import one_torch_thread  # noqa: F401

N = TEST_SAMPLES
QAM = sorted(n for n, f in ALL_STANDARDS.items() if not f().is_fm)
INT32_MAX = 2**31 - 1


def _buffers(plan: QamPlan) -> dict:
    return {k: v.numpy() for k, v in plan.state_dict().items()}


@pytest.mark.parametrize("name", QAM)
def test_make_plan_matches_jax(name):
    jp = get_plan(name)
    tp = make_plan(ALL_STANDARDS[name](), N)
    for k in HOST_FIELDS:
        assert np.array_equal(tp.host[k], getattr(jp, k)), k
        assert np.array_equal(getattr(tp, k).numpy(), getattr(jp, k).astype(np.float32)), k
    assert (tp.theta, tp.n_samples, tp.fs) == (jp.theta, jp.n_samples, jp.fs)
    assert (tp.cpl_num, tp.cpl_den, tp.total_lines) == (
        jp.cfg.cpl_num, jp.cfg.cpl_den, jp.cfg.total_lines)
    rc, rs = _ramp_rows(jp.ramp, N, N)
    assert np.array_equal(tp.ramp_cos.numpy(), rc[0])
    assert np.array_equal(tp.ramp_sin.numpy(), rs[0])
    for k in ("c1_lpf", "c2_lpf", "chroma_bpf"):
        assert np.array_equal(
            getattr(tp, k + "_mat").numpy(), jax_toeplitz_same(getattr(jp, k), N)
        ), k


@pytest.mark.parametrize("name", QAM)
def test_plan_from_numpy_matches_make_plan(name):
    jp = get_plan(name)
    a, b = plan_from_numpy(jp), make_plan(ALL_STANDARDS[name](), N)
    ba, bb = _buffers(a), _buffers(b)
    assert ba.keys() == bb.keys()
    for k in ba:
        assert np.array_equal(ba[k], bb[k]), k
    for k in HOST_FIELDS:
        assert np.array_equal(a.host[k], b.host[k]), k
    assert (a.theta, a.fs, a.cfg) == (b.theta, b.fs, b.cfg)


def test_fm_is_not_ported_yet():
    """The FM family is ported now: SECAM plans are FmPlans, and each plan
    class refuses the other family's standard."""
    assert isinstance(make_plan(SECAM(), N), FmPlan)
    assert isinstance(plan_from_numpy(get_plan("secam")), FmPlan)
    qam_host = {k: getattr(get_plan("ntsc"), k) for k in HOST_FIELDS}
    with pytest.raises(TypeError, match="QAM standard"):
        QamPlan(SECAM(), N, 13.5e6, theta=0.0, **qam_host)
    fm = get_plan("secam")
    with pytest.raises(TypeError, match="FM standard"):
        FmPlan(ALL_STANDARDS["ntsc"](), N, fm.fs, f_center=fm.f_center,
               fm_margin=fm.fm_margin, fm_luma_est=fm.fm_luma_est,
               **{k: getattr(fm, k) for k in FM_HOST_FIELDS})


@pytest.mark.parametrize("n", [720, 1440])
def test_fm_plan_matches_jax(n):
    """make_plan(SECAM(), n): bit-equal host arrays and scalars, float32
    buffers the exact casts, mix rows as the JAX kernel builds them, and
    Toeplitz matrices equal to the JAX package's."""
    jp = get_plan("secam") if n == N else jplan.make_plan(SECAM(), n)
    tp = make_plan(SECAM(), n)
    assert isinstance(tp, FmPlan)
    for k in FM_HOST_FIELDS:
        assert np.array_equal(tp.host[k], getattr(jp, k)), k
        assert np.array_equal(getattr(tp, k).numpy(), getattr(jp, k).astype(np.float32)), k
    assert (tp.n_samples, tp.fs, tp.f_center, tp.fm_margin, tp.fm_luma_est) == (
        jp.n_samples, jp.fs, jp.f_center, jp.fm_margin, jp.fm_luma_est)
    mix = np.asarray(jp.mix_ramp_ext, np.float64)
    assert np.array_equal(tp.mix_cos.numpy(), np.cos(mix).astype(np.float32))
    assert np.array_equal(tp.mix_sin.numpy(), np.sin(mix).astype(np.float32))
    n_ext = n + 2 * jp.fm_margin
    for k in ("comp_lpf", "preemph"):
        assert np.array_equal(getattr(tp, k + "_held").numpy(),
                              jax_toeplitz_same_held(getattr(jp, k), n)), k
    assert np.array_equal(tp.anticloche_mat.numpy(), jax_toeplitz_same(jp.anticloche, n))
    for k in ("bell_takeoff", "luma_notch", "mix_lpf", "diff", "deemph", "demod_lpf"):
        assert np.array_equal(getattr(tp, k + "_mat").numpy(),
                              jax_toeplitz_same(getattr(jp, k), n_ext)), k
    # tap counts scale with fs / REF_FS, so each filter keeps its time span
    k = tp.fs / tplan.REF_FS
    for name, base in (("comp_lpf", 129), ("preemph", 257), ("anticloche", 193),
                       ("diff", 31)):
        assert len(tp.host[name]) == tplan._odd(base * k), name


def test_fm_plan_from_numpy_matches_make_plan():
    a, b = plan_from_numpy(get_plan("secam")), make_plan(SECAM(), N)
    ba, bb = _buffers(a), _buffers(b)
    assert ba.keys() == bb.keys()
    for k in ba:
        assert np.array_equal(ba[k], bb[k]), k
    assert (a.f_center, a.fm_margin, a.fm_luma_est, a.cfg) == (
        b.f_center, b.fm_margin, b.fm_luma_est, b.cfg)


def test_fm_plan_rejects_narrow_lines():
    """SECAM needs fs >= 2 x (band top + transition): 704 samples is too
    few, in both packages."""
    with pytest.raises(ValueError, match="too low for the chroma band"):
        make_plan(SECAM(), 704)
    with pytest.raises(ValueError, match="too low for the chroma band"):
        jplan.make_plan(SECAM(), 704)


def test_fm_constants_match_jax():
    for k in ("SECAM_MIX_LPF", "SECAM_MARGIN", "SECAM_LUMA_EST",
              "SECAM_TAKEOFF_HALFWIDTH", "SECAM_BAND_TRANSITION", "REF_FS"):
        assert getattr(tplan, k) == getattr(jplan, k), k


_F = np.linspace(0.0, 13.5e6, 4097)
_CH = SECAM().chroma
_DESIGNS = {
    "tukey": lambda d: d.tukey(193),
    "tukey_alpha": lambda d: d.tukey(31, alpha=0.3),
    "freq_sampled": lambda d: d.freq_sampled_taps(
        27e6, lambda f: d.secam_preemph_response(f, 85e3), 513),
    # 2049 taps: the design grid widens past DESIGN_NFFT
    "freq_sampled_wide": lambda d: d.freq_sampled_taps(
        13.5e6, lambda f: d.secam_deemph_response(f, 85e3), 2049),
    "differentiator": lambda d: d.differentiator_taps(13.5e6, 31),
    "preemph": lambda d: d.secam_preemph_response(_F, _CH.preemph_f1),
    "deemph": lambda d: d.secam_deemph_response(_F, _CH.preemph_f1),
    "bell_F": lambda d: d._bell_F(_F, _CH.bell_f0),
    "anticloche": lambda d: d.secam_anticloche_response(
        _F, _CH.bell_f0, _CH.bell_m0, _CH.bell_k_num, _CH.bell_k_den),
    "cloche": lambda d: d.secam_cloche_response(
        _F, _CH.bell_f0, _CH.bell_m0, _CH.bell_k_num, _CH.bell_k_den),
    "band_mask": lambda d: d.raised_cosine_bandpass_response(_F, 2.286e6, 6.286e6, 0.4e6),
}


@pytest.mark.parametrize("name", sorted(_DESIGNS))
def test_secam_designs_bit_equal(name):
    assert design.DESIGN_NFFT == jdesign.DESIGN_NFFT
    got, ref = _DESIGNS[name](design), _DESIGNS[name](jdesign)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("name", ["preemph", "anticloche", "bell_takeoff", "diff"])
def test_secam_taps_are_asymmetric(name):
    """The FM taps have intrinsic phase, so a mirrored FIR would be wrong:
    the kernels' tap orientation is tested on them (and the differentiator
    is antisymmetric)."""
    taps = make_plan(SECAM(), N).host[name]
    assert not np.allclose(taps, taps[::-1])
    if name == "diff":
        np.testing.assert_allclose(taps, -taps[::-1], atol=1e-12)


def test_plan_to_moves_every_buffer():
    plan = make_plan(ALL_STANDARDS["ntsc"](), N).to("meta")
    assert {b.device.type for b in plan.buffers()} == {"meta"}
    assert {b.dtype for b in plan.buffers()} == {torch.float32}
    assert plan.n_samples == N and plan.cpl_den == 2


def _phase_law_lines(den: int) -> np.ndarray:
    rng = np.random.default_rng(den)
    return np.concatenate([
        np.arange(0, 64),
        np.arange(INT32_MAX - 3 * den, INT32_MAX + 1, 7),
        rng.integers(2**30, INT32_MAX, 512, endpoint=True),
    ]).astype(np.int32)


@pytest.mark.parametrize("name", QAM)
def test_line_phase0_bit_equal_near_2_31(name):
    cfg = ALL_STANDARDS[name]()
    g = _phase_law_lines(cfg.cpl_den)
    got = nco.line_phase0(cfg.cpl_num, cfg.cpl_den, torch.from_numpy(g)).numpy()
    ref = np.asarray(jnco.line_phase0(cfg.cpl_num, cfg.cpl_den, jnp.asarray(g)))
    assert got.dtype == np.float32
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("total_lines", [525, 625])
def test_global_line_index_bit_equal_near_2_31(total_lines):
    frame0 = INT32_MAX // total_lines - 16
    got = nco.global_line_index(frame0, 16, 480, total_lines, "cpu").numpy()
    ref = np.asarray(jnco.global_line_index(frame0, 16, 480, total_lines))
    assert got.dtype == np.int32 and got.max() > 2**31 - 2 * total_lines * 16
    assert np.array_equal(got, ref)
    # PAL's den 2500 on those indices
    cfg = ALL_STANDARDS["pal"]()
    assert np.array_equal(
        nco.line_phase0(cfg.cpl_num, cfg.cpl_den, torch.from_numpy(got)).numpy(),
        np.asarray(jnco.line_phase0(cfg.cpl_num, cfg.cpl_den, jnp.asarray(ref))),
    )


@pytest.mark.parametrize("kind", ["numpy int", "0-dim tensor"])
def test_global_line_index_takes_frame0_as_int_or_tensor(kind):
    """An int frame0 takes the no-copy arange; a tensor frame0 is added on
    the device.  Both give the JAX package's indices."""
    frame0 = INT32_MAX // 625 - 16
    f0 = np.int64(frame0) if kind == "numpy int" else torch.tensor(frame0, dtype=torch.int32)
    got = nco.global_line_index(f0, 16, 288, 625, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jnco.global_line_index(frame0, 16, 288, 625)))


def test_sample_phase_ramp_matches_jax():
    args = (315e6 / 88, 13.5e6, N)
    assert np.array_equal(nco.sample_phase_ramp(*args), jnco.sample_phase_ramp(*args))


def test_toeplitz_orientation_on_asymmetric_taps():
    """x @ M is np.convolve(x, taps, 'same'), also for asymmetric taps."""
    rng = np.random.default_rng(3)
    taps = rng.normal(size=31)
    x = rng.normal(size=(5, 97)).astype(np.float32)
    mat = toeplitz_same(taps, 97)
    assert np.array_equal(mat, jax_toeplitz_same(taps, 97))
    got = fir_same(torch.from_numpy(x), torch.tensor(mat)).numpy()
    ref = np.stack([np.convolve(r.astype(np.float64), taps, "same") for r in x])
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("n_valid", [None, 80])
def test_toeplitz_same_held_matches_jax(n_valid):
    taps = np.random.default_rng(8).normal(size=31)
    assert np.array_equal(toeplitz_same_held(taps, 97, n_valid),
                          jax_toeplitz_same_held(taps, 97, n_valid))


@pytest.mark.parametrize("ntaps", [31, 257])
def test_fir_same_held_is_convolve_on_edge_padded_line(ntaps):
    """Held edge: np.convolve on the np.pad(mode='edge') line, to 1e-6,
    also for asymmetric taps longer than the line."""
    rng = np.random.default_rng(ntaps)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(5, 97)).astype(np.float32)
    h = (ntaps - 1) // 2
    ref = np.stack([
        np.convolve(np.pad(r.astype(np.float64), h, mode="edge"), taps, "same")[h : h + 97]
        for r in x
    ])
    got = fir_same_held(torch.from_numpy(x), torch.tensor(toeplitz_same_held(taps, 97)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
