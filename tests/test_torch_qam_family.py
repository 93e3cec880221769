"""The QAM family in the PyTorch port (every QAM standard with every decoder
``allowed_decoders`` offers it) against the JAX package and the golden
oracle, on the CPU.

* every spatial (standard, decoder) pair on both backends against the JAX
  ``xla`` pipeline at 2x3x64x720, frame0 = 3: composite <= 2e-5, RGB <=
  5e-4 (the JAX package's kernel-vs-twin bounds);
* the same pairs against golden (>= 60 dB) and the round-trip floors of
  tests/test_roundtrip.py on its fixtures;
* the temporal combs on a static 4-frame batch against JAX and
  ``golden.decode_sequence``;
* the pieces: frame stencils (bit-equal), NIIR normalisation (<= 1e-6), the
  burst phase/gain hooks (<= 5e-4), ``comb_sel_lpf`` and ``hilbert_taps``
  (bit-equal).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_LINES, TEST_SAMPLES, get_plan
from test_roundtrip import PARITY_BOUND, ROUNDTRIP_BOUNDS, TEMPORAL_BOUNDS
from color_modem_tpu import golden
from color_modem_tpu.dsp import design as jdesign
from color_modem_tpu.frame.pipeline import decode_block as jax_decode_block
from color_modem_tpu.frame.pipeline import encode_block as jax_encode_block
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.modem import niir as jax_niir
from color_modem_tpu.modem import plan as jplan
from color_modem_tpu.separate import stencil as jax_stencil
from color_modem_tpu.standards import ALL_STANDARDS
from color_modem_tpu.standards.decoders import allowed_decoders, temporal_comb_spacing
from color_modem_tpu.utils.metrics import psnr as np_psnr
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import toeplitz_same
from color_modem_tpu_torch.frame.pipeline import decode_block, make_pipeline
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.modem import niir
from color_modem_tpu_torch.modem.plan import make_plan, plan_from_numpy
from color_modem_tpu_torch.separate import stencil
from torch_threads import one_torch_thread  # noqa: F401

FRAME0 = 3
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
CATCH_ALL_BOUND = 25.0  # tests/test_roundtrip.py::test_every_allowed_pair_roundtrips
TEMPORAL = ("comb3d", "comb3dA")
QAM = sorted(n for n, f in ALL_STANDARDS.items() if not f().is_fm)
PAIRS = [(n, d) for n in QAM for d in allowed_decoders(ALL_STANDARDS[n]())
         if d not in TEMPORAL]
TEMPORAL_PAIRS = [(n, d) for n in ("ntsc", "pal", "pal_m", "pal_n") for d in TEMPORAL]
BACKENDS = ["kernel", "plain"]


def port_pipeline(name, decoder, backend):
    return make_pipeline(plan_from_numpy(get_plan(name)), decoder, backend, device="cpu")


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    reset_launches()
    yield
    assert set(launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def rgb():
    return np.stack([
        smooth_scene(TEST_LINES, TEST_SAMPLES, seed=s) for s in (1, 2)
    ]).astype(np.float32)


_JAX_OUT = {}


def jax_outputs(name, decoder, x, frame0):
    """(composite, round-trip RGB) of the JAX xla pipeline, cached."""
    key = (name, decoder, x.shape, frame0)
    if key not in _JAX_OUT:
        enc, _, rt = jax_make_pipeline(get_plan(name), decoder, "xla")
        _JAX_OUT[key] = (np.asarray(enc(jnp.asarray(x), frame0)),
                         np.asarray(rt(jnp.asarray(x), frame0)))
    return _JAX_OUT[key]


def test_every_qam_pair_is_covered():
    """The two lists cover allowed_decoders exactly, for all 7 QAM standards."""
    got = sorted(PAIRS + [p for p in TEMPORAL_PAIRS])
    want = sorted((n, d) for n in QAM for d in allowed_decoders(ALL_STANDARDS[n]()))
    assert got == want and len(QAM) == 7


# --- the pipeline ------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,decoder", PAIRS)
def test_pair_matches_jax_xla(name, decoder, backend, rgb):
    comp_j, out_j = jax_outputs(name, decoder, rgb, FRAME0)
    enc, dec, rt = port_pipeline(name, decoder, backend)
    comp = enc(rgb, FRAME0)
    np.testing.assert_allclose(comp.numpy(), comp_j, atol=ENC_ATOL)
    out = rt(rgb, FRAME0)
    assert out.shape == rgb.shape and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), out_j, atol=DEC_ATOL)
    assert torch.equal(dec(comp, FRAME0), out)


@pytest.mark.parametrize("name,decoder", PAIRS)
def test_pair_golden_parity_and_roundtrip_bound(name, decoder, scene):
    """On tests/test_roundtrip.py's fixtures: its bound where it records one
    (the 64-line scene), else its 25 dB catch-all (32 lines, seed 11)."""
    bound = ROUNDTRIP_BOUNDS.get((name, decoder))
    img = scene if bound else smooth_scene(32, TEST_SAMPLES, seed=11).astype(np.float32)
    jp = get_plan(name)
    comp_g = golden.encode_frame(jp, img, frame=0)
    for backend in BACKENDS:
        enc, dec, _ = port_pipeline(name, decoder, backend)
        comp = enc(img[None], 0)
        out = dec(comp, 0).numpy()[0]
        rgb_g = golden.decode_frame(jp, comp.numpy()[0], frame=0, decoder=decoder)
        assert np_psnr(comp.numpy()[0], comp_g) >= PARITY_BOUND, "encode parity"
        assert np_psnr(out, rgb_g) >= PARITY_BOUND, "decode parity"
        assert np_psnr(out, img) >= (bound or CATCH_ALL_BOUND), backend


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,decoder", TEMPORAL_PAIRS)
def test_temporal_pair(name, decoder, backend):
    """Static 4-frame 32x720 batch (tests/test_roundtrip.py's temporal
    fixture): JAX xla, golden.decode_sequence and TEMPORAL_BOUNDS (the
    catch-all 25 dB where it records none)."""
    jp = get_plan(name)
    f = max(4, 2 * temporal_comb_spacing(jp.cfg))
    one = smooth_scene(32, TEST_SAMPLES, seed=7).astype(np.float32)
    batch = np.broadcast_to(one, (f,) + one.shape).copy()
    comp_j, out_j = jax_outputs(name, decoder, batch, 0)
    enc, dec, _ = port_pipeline(name, decoder, backend)
    comp = enc(batch, 0)
    out = dec(comp, 0).numpy()
    np.testing.assert_allclose(comp.numpy(), comp_j, atol=ENC_ATOL)
    np.testing.assert_allclose(out, out_j, atol=DEC_ATOL)
    rgb_g = golden.decode_sequence(jp, comp.numpy(), frame0=0, decoder=decoder)
    assert np_psnr(out, rgb_g) >= PARITY_BOUND
    assert np_psnr(out, batch) >= TEMPORAL_BOUNDS.get((name, decoder), CATCH_ALL_BOUND)


# --- the pieces --------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2])
def test_frame_stencils_bit_equal(p):
    x = np.random.default_rng(p).normal(size=(2, 5, 3, 16)).astype(np.float32)
    for frames in (2 * p, 5):
        xs = x[:, :frames]
        for ours, theirs in ((stencil.prev_reflect_frames, jax_stencil.prev_reflect_frames),
                             (stencil.next_reflect_frames, jax_stencil.next_reflect_frames)):
            got = ours(torch.from_numpy(xs.copy()), p).numpy()
            assert np.array_equal(got, np.asarray(theirs(jnp.asarray(xs), p)))
    # the edge frames borrow t+p (p frames away), not the index reflection
    got = stencil.prev_reflect_frames(torch.from_numpy(x[0].copy()), p).numpy()
    assert np.array_equal(got[:p], x[0, p : 2 * p])
    short = torch.from_numpy(x[:, : 2 * p - 1].copy())
    for fn in (stencil.prev_reflect_frames, stencil.next_reflect_frames):
        with pytest.raises(ValueError, match=f">= {2 * p} frames"):
            fn(short, p)
    for fn in (jax_stencil.prev_reflect_frames, jax_stencil.next_reflect_frames):
        with pytest.raises(ValueError, match=f">= {2 * p} frames"):
            fn(jnp.asarray(short.numpy()), p)


def test_niir_normalize_matches_jax():
    """Random demodulated planes; every third reference line zeroed trips
    the weak-reference guard (|zr|^2 < 1e-12)."""
    jp = get_plan("niir")
    tp = plan_from_numpy(jp)
    rng = np.random.default_rng(4)
    c1, c2 = rng.normal(scale=0.3, size=(2, 2, 24, TEST_SAMPLES)).astype(np.float32)
    g = np.asarray(jax_frame_line_index(jp, FRAME0, 2, 24))
    weak = (g % 2 == 1) & (np.arange(24) % 3 == 0)
    c1[weak], c2[weak] = 0.0, 1e-7
    assert weak.sum() >= 4
    ref = jax_niir.normalize(jp, jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(g))
    got = niir.normalize(tp, torch.from_numpy(c1), torch.from_numpy(c2),
                         torch.from_numpy(g.copy()))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    assert np.array_equal(niir.is_chroma_line(torch.from_numpy(g.copy())).numpy(),
                          np.asarray(jax_niir.is_chroma_line(jnp.asarray(g))))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,decoder", [("ntsc", "notch"), ("pal", "delayline"),
                                          ("niir", "avg"), ("ntsc", "combA")])
def test_burst_hooks_match_jax(name, decoder, backend):
    """Random per-line phase_err and chroma_gain through decode_block on two
    smooth scenes: the kernel backend against JAX's Pallas path (interpret
    mode), plain against JAX xla.  (Random pixels would leave NIIR's
    reference measurement near zero at some samples, where its division
    amplifies float32 rounding past any fixed bound.)"""
    jp = get_plan(name)
    tp = plan_from_numpy(jp)
    rng = np.random.default_rng(11)
    rgb = np.stack([smooth_scene(24, TEST_SAMPLES, seed=s) for s in (5, 6)]).astype(np.float32)
    g = jax_frame_line_index(jp, FRAME0, 2, 24)
    comp = np.array(jax_encode_block(jp, jnp.asarray(rgb), g))
    phase_err = rng.uniform(-0.6, 0.6, (2, 24)).astype(np.float32)
    gain = rng.uniform(0.5, 2.0, (2, 24)).astype(np.float32)
    jax_backend = "pallas" if backend == "kernel" else "xla"
    ref = jax_decode_block(jp, jnp.asarray(comp), g, decoder, jax_backend,
                           phase_err=jnp.asarray(phase_err), chroma_gain=jnp.asarray(gain))
    gt = torch.from_numpy(np.array(g))
    got = decode_block(tp, torch.from_numpy(comp), gt, decoder,
                       backend, phase_err=torch.from_numpy(phase_err),
                       chroma_gain=torch.from_numpy(gain))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DEC_ATOL)
    # each hook alone, against JAX xla
    for kw in ({"phase_err": phase_err}, {"chroma_gain": gain}):
        ref = jax_decode_block(jp, jnp.asarray(comp), g, decoder, "xla",
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        got = decode_block(tp, torch.from_numpy(comp), gt, decoder, backend,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DEC_ATOL)


@pytest.mark.parametrize("n", [720, 1440])
def test_comb_sel_lpf_and_hilbert_bit_equal(n):
    """comb_sel_lpf keeps a fixed 63 taps at any width; the Hilbert taps are
    antisymmetric, and the plain Toeplitz FIR applies them unmirrored."""
    for name in QAM:
        cfg = ALL_STANDARDS[name]()
        jp = get_plan(name) if n == TEST_SAMPLES else jplan.make_plan(cfg, n)
        tp = make_plan(cfg, n)
        assert len(tp.host["comb_sel_lpf"]) == 63
        assert np.array_equal(tp.host["comb_sel_lpf"], jp.comb_sel_lpf), name
        assert np.array_equal(tp.comb_sel_lpf_mat.numpy(), toeplitz_same(jp.comb_sel_lpf, n))
        assert np.array_equal(plan_from_numpy(jp).host["comb_sel_lpf"], jp.comb_sel_lpf)
        ch = cfg.chroma
        args = (jp.fs, ch.fsc - ch.chroma_band, ch.fsc + ch.chroma_band, 129)
        hil = design.hilbert_taps(*args)
        assert np.array_equal(hil, jdesign.hilbert_taps(*args)), name
        np.testing.assert_allclose(hil, -hil[::-1], atol=1e-12)
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    got = torch.from_numpy(x) @ torch.tensor(toeplitz_same(hil, n))
    ref = np.stack([np.convolve(r.astype(np.float64), hil, "same") for r in x])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
