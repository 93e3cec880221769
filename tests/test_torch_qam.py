"""The PyTorch port's QAM modules against the JAX package, on the CPU.

* the plain twins (``modem/qam.py``, ``separate/comb.py``) against the JAX
  ``xla`` functions;
* the kernel wrappers (``kernels/qam.py``), which run their plain versions
  on CPU tensors, against the JAX Pallas kernels in interpret mode, as
  tests/test_kernels.py runs them.

Bounds are the JAX package's own kernel-vs-twin bounds
(tests/test_kernels.py): 2e-5 on the composite, 5e-4 on the decode.
Inputs come from numpy with a seed: B=2 frames of 32 lines x 720 samples.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu.dsp.colorimetry import apply_mat3 as jax_apply_mat3
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.kernels import qam as jax_qk
from color_modem_tpu.modem import qam as jax_qam
from color_modem_tpu.separate import comb as jax_comb
from color_modem_tpu.separate import stencil as jax_stencil
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.modem import qam
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.separate import comb, stencil
from torch_threads import one_torch_thread  # noqa: F401

B, L, N = 2, 32, TEST_SAMPLES
FRAME0 = 3
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
ENCODERS = ["ntsc", "pal", "niir"]
DECODES = [("ntsc", "notch"), ("ntsc", "comb2"), ("ntsc", "comb3"),
           ("pal", "comb3"), ("niir", "notch")]

_PLANS = {}


def plans(name):
    """(JAX ModemPlan, port QamPlan) carrying the same parameters."""
    if name not in _PLANS:
        jp = get_plan(name)
        _PLANS[name] = (jp, plan_from_numpy(jp))
    return _PLANS[name]


def ycc_input(lines=L, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(0.0, 1.0, (B, lines, N)),
        rng.uniform(-0.6, 0.6, (B, lines, N)),
        rng.uniform(-0.6, 0.6, (B, lines, N)),
    ], axis=1).astype(np.float32)


def glines(jp, lines=L):
    return np.asarray(jax_frame_line_index(jp, FRAME0, B, lines))


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    reset_launches()
    yield
    assert set(launch_counts().values()) == {0}


# --- plain twins vs the JAX xla functions -----------------------------------


@pytest.mark.parametrize("name", ENCODERS)
def test_plain_encode_matches_jax(name):
    jp, tp = plans(name)
    ycc, g = ycc_input(), glines(jp)
    ref = np.asarray(jax_qam.encode(jp, jnp.asarray(ycc), jnp.asarray(g)))
    got = qam.encode(tp, t(ycc), t(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL)


@pytest.mark.parametrize("name,decoder", DECODES)
def test_plain_demodulate_matches_jax(name, decoder):
    jp, tp = plans(name)
    g = glines(jp)
    comp = np.asarray(jax_qam.encode(jp, jnp.asarray(ycc_input()), jnp.asarray(g)))
    luma_j, band_j = jax_comb.separate(jp, jnp.asarray(comp), decoder)
    ref = [luma_j, *jax_qam.demodulate_carrier(jp, band_j, jnp.asarray(g))]
    luma, band = comb.separate(tp, t(comp), decoder)
    got = [luma, *qam.demodulate_carrier(tp, band, t(g))]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=DEC_ATOL)


# --- kernel wrappers vs the JAX Pallas kernels ------------------------------


@pytest.mark.parametrize("name", ENCODERS)
def test_phase_cols_bit_equal(name):
    jp, tp = plans(name)
    g = glines(jp)
    ref = np.concatenate(
        [np.asarray(c) for c in jax_qk._phase_cols(jp, jnp.asarray(g))], axis=1
    )
    assert np.array_equal(qk.phase_cols(tp, t(g)).numpy(), ref)


@pytest.mark.parametrize("lines", [L, 27])
@pytest.mark.parametrize("name", ENCODERS)
def test_kernel_encode_matches_pallas(name, lines):
    jp, tp = plans(name)
    ycc, g = ycc_input(lines), glines(jp, lines)
    ref = np.asarray(jax_qk.encode(jp, jnp.asarray(ycc), jnp.asarray(g)))
    got = qk.encode(tp, t(ycc), t(g)).numpy()
    assert got.shape == (B, lines, N)
    np.testing.assert_allclose(got, ref, atol=ENC_ATOL)


@pytest.mark.parametrize("lines", [L, 27])
@pytest.mark.parametrize("name,decoder", DECODES)
def test_kernel_demodulate_matches_pallas(name, decoder, lines):
    jp, tp = plans(name)
    g = glines(jp, lines)
    comp = np.asarray(jax_qam.encode(jp, jnp.asarray(ycc_input(lines)), jnp.asarray(g)))
    sep = np.asarray(jax_comb.stencil_signal(jp, jnp.asarray(comp), decoder))
    ref = np.stack([np.asarray(a) for a in jax_qk.demodulate_separated(
        jp, jnp.asarray(sep), jnp.asarray(comp), jnp.asarray(g))], axis=-3)
    got = qk.demodulate_separated(
        tp, comb.stencil_signal(tp, t(comp), decoder), t(comp), t(g)).numpy()
    assert got.shape == (B, 3, lines, N)
    np.testing.assert_allclose(got, ref, atol=DEC_ATOL)


@pytest.mark.parametrize("name", ENCODERS)
def test_lines_plain_match_modem_twins(name):
    """The kernels' plain versions (angle-addition carrier) agree with the
    modem twins (direct sin/cos of the phase) on the port itself."""
    _, tp = plans(name)
    ycc, g = t(ycc_input()), t(glines(plans(name)[0]))
    cols = qk.phase_cols(tp, g)
    comp = qk.encode_lines(tp, ycc, cols)
    np.testing.assert_allclose(comp.numpy(), qam.encode(tp, ycc, g).numpy(), atol=ENC_ATOL)
    luma, band = qam.separate_notch(tp, comp)
    c1, c2 = qam.demodulate_carrier(tp, band, g)
    got = qk.decode_lines(tp, comp, comp, cols)
    np.testing.assert_allclose(
        got.numpy(), torch.stack([luma, c1, c2], dim=1).numpy(), atol=DEC_ATOL)


# --- small pieces -----------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2])
def test_stencils_bit_equal(p):
    x = np.random.default_rng(p).normal(size=(B, 9, 16)).astype(np.float32)
    for ours, theirs in ((stencil.prev_reflect, jax_stencil.prev_reflect),
                         (stencil.next_reflect, jax_stencil.next_reflect)):
        assert np.array_equal(ours(t(x), p).numpy(), np.asarray(theirs(jnp.asarray(x), p)))


def test_apply_mat3_matches_jax():
    jp, tp = plans("ntsc")
    x = np.random.default_rng(5).uniform(size=(B, 3, L, N)).astype(np.float32)
    ref = np.asarray(jax_apply_mat3(jp.rgb_to_ycc, jnp.asarray(x)))
    np.testing.assert_allclose(apply_mat3(tp.rgb_to_ycc, t(x)).numpy(), ref, atol=1e-6)


def test_wrappers_check_their_inputs():
    _, tp = plans("ntsc")
    ycc = torch.zeros((1, 3, 4, N))
    cols = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        qk.encode_lines(tp, ycc.double(), cols)
    with pytest.raises(ValueError, match="contiguous"):
        qk.encode_lines(tp, ycc.transpose(2, 3).contiguous().transpose(2, 3), cols)
    with pytest.raises(ValueError, match="samples per line"):
        qk.encode_lines(tp, ycc[..., :-1].contiguous(), cols)
    with pytest.raises(ValueError, match="cols"):
        qk.encode_lines(tp, ycc, cols[:3])
    with pytest.raises(ValueError, match="plan is on"):
        qk.encode_lines(tp, ycc.to("meta"), cols.to("meta"))
    meta = plan_from_numpy(get_plan("ntsc")).to("meta")
    with pytest.raises(ValueError, match="no QAM kernel"):
        qk.decode_lines(meta, *(torch.zeros((1, 4, N), device="meta"),) * 2,
                        torch.zeros((4, 3), device="meta"))
