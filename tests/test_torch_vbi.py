"""The PyTorch port's data lines (``color_modem_tpu_torch/frame/vbi.py``)
against ``color_modem_tpu/frame/vbi.py`` on the CPU.

Bounds: the packed caption bits, the specs and the shaping taps are
identical; the waveforms agree to 1e-6 (float32 FIRs summed in another
order); every decoded bit equals JAX's (``torch.equal``) and the bits sent,
and the eye margins agree to 1e-5.  Both run-in kinds are covered: the
EIA-608 sine burst (captions on NTSC, the half-rate teletext spec on PAL)
and the alternating WST run-in with cosine roll-off shaping (PAL at 1440
samples).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from color_modem_tpu.frame import teletext as jtt
from color_modem_tpu.frame import vbi as jv
from color_modem_tpu.modem.plan import make_plan as jax_make_plan
from color_modem_tpu.standards import NTSC as JNTSC
from color_modem_tpu.standards import PAL as JPAL
from color_modem_tpu_torch.frame import vbi
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

WAVE_ATOL, MARGIN_ATOL = 1e-6, 1e-5

_PLANS = {}


def plans(name, n):
    """(JAX plan, port plan) of a standard at n samples, built once."""
    if (name, n) not in _PLANS:
        jp = jax_make_plan({"ntsc": JNTSC, "pal": JPAL}[name](), n)
        _PLANS[name, n] = (jp, plan_from_numpy(jp))
    return _PLANS[name, n]


def port_spec(spec):
    return vbi.DataLineSpec(spec.f_bit, spec.n_bits, spec.run_in_cycles, spec.level,
                            spec.start_bits, spec.run_in_alt)


#: case -> (standard, samples, the JAX spec factory)
SPECS = {
    "caption": ("ntsc", 720, jv.cc_spec),
    "teletext-half-rate": ("pal", 720, jv.teletext_spec),
    "wst-alternating-run-in": ("pal", 1440, jtt.wst_spec),
}

#: (delay in samples, gain, noise sigma) of the channels each case goes through
CHANNELS = ((0, 1.0, 0.0), (1, 0.8, 0.02), (-1, 1.25, 0.03))


@pytest.mark.parametrize("text", ["HI", "a~", "\x00\x7f", "  "])
def test_cc_pack_matches_jax_and_unpacks(text):
    got = vbi.cc_pack(text)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.tensor(np.asarray(jv.cc_pack(text))))
    assert vbi.cc_unpack(got) == jv.cc_unpack(np.asarray(got)) == (text, True)
    flipped = got.clone()
    flipped[3] ^= 1
    assert vbi.cc_unpack(flipped) == jv.cc_unpack(flipped.numpy())
    assert vbi.cc_unpack(flipped)[1] is False


@pytest.mark.parametrize("text", ["A", "ABC", "é!"])
def test_cc_pack_refuses_like_jax(text):
    with pytest.raises(ValueError):
        jv.cc_pack(text)
    with pytest.raises(ValueError):
        vbi.cc_pack(text)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_and_taps_are_identical(case):
    name, n, factory = SPECS[case]
    jp, tp = plans(name, n)
    spec = factory(jp)
    if factory is not jtt.wst_spec:
        assert port_spec(spec) == {jv.cc_spec: vbi.cc_spec,
                                   jv.teletext_spec: vbi.teletext_spec}[factory](tp)
    assert vbi._layout(tp, port_spec(spec)) == jv._layout(jp, spec)
    assert np.array_equal(vbi._shaping_taps(tp, port_spec(spec)), jv._shaping_taps(jp, spec))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_data_line_matches_jax(case):
    name, n, factory = SPECS[case]
    jp, tp = plans(name, n)
    spec = factory(jp)
    rng = np.random.default_rng(sorted(SPECS).index(case))
    bits = rng.integers(0, 2, (5, spec.n_bits)).astype(np.int32)
    wave_j = np.asarray(jv.encode_data_line(jp, spec, jnp.asarray(bits)))
    wave = vbi.encode_data_line(tp, port_spec(spec), torch.tensor(bits))
    assert wave.dtype == torch.float32 and wave.shape == (5, n)
    np.testing.assert_allclose(wave.numpy(), wave_j, rtol=0, atol=WAVE_ATOL)
    for delay, gain, sigma in CHANNELS:
        line = (gain * np.roll(wave_j, delay, axis=-1)
                + rng.normal(0.0, sigma, wave_j.shape)).astype(np.float32)
        bits_j, margin_j = jv.decode_data_line(jp, spec, jnp.asarray(line))
        got, margin = vbi.decode_data_line(tp, port_spec(spec), torch.tensor(line))
        assert got.dtype == torch.int32
        assert torch.equal(got, torch.tensor(np.asarray(bits_j))), (delay, gain, sigma)
        assert torch.equal(got, torch.tensor(bits)), (delay, gain, sigma)
        np.testing.assert_allclose(margin.numpy(), np.asarray(margin_j), rtol=0,
                                   atol=MARGIN_ATOL)


def test_decode_batches_over_any_leading_axes():
    jp, tp = plans("ntsc", 720)
    spec = vbi.cc_spec(tp)
    bits = torch.tensor(np.random.default_rng(5).integers(0, 2, (2, 3, 16)), dtype=torch.int32)
    wave = vbi.encode_data_line(tp, spec, bits)
    got, margin = vbi.decode_data_line(tp, spec, wave)
    assert torch.equal(got, bits) and margin.shape == (2, 3)
    one, _ = vbi.decode_data_line(tp, spec, wave[1, 2])
    assert torch.equal(one, bits[1, 2])


def test_layout_refusals_match_jax():
    jp, tp = plans("pal", 720)
    too_long = jv.DataLineSpec(32.0 * jp.cfg.fh, 400, 7, 0.5, (0, 0, 1))
    too_fast = jv.DataLineSpec(1200.0 * jp.cfg.fh, 8, 2, 0.5, (1,))
    for spec in (too_long, too_fast):
        with pytest.raises(ValueError) as e_j:
            jv._layout(jp, spec)
        with pytest.raises(ValueError) as e_t:
            vbi.encode_data_line(tp, port_spec(spec), torch.zeros(spec.n_bits, dtype=torch.int32))
        assert str(e_t.value) == str(e_j.value)
    with pytest.raises(ValueError, match="expected 16 bits"):
        vbi.encode_data_line(tp, vbi.cc_spec(tp), torch.zeros(15, dtype=torch.int32))
