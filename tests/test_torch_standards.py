"""The port's own standard tables, decoder registry and test image against
the JAX package's: every configuration equal field for field, every rule
giving the same answer, and the same plan built from either configuration."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from color_modem_tpu import standards as jstd
from color_modem_tpu.standards import base as jbase
from color_modem_tpu.standards import decoders as jdec
from color_modem_tpu.utils.testimages import smooth_scene as jax_smooth_scene

from color_modem_tpu_torch import standards as tstd
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import base as tbase
from color_modem_tpu_torch.standards import decoders as tdec
from color_modem_tpu_torch.utils.testimages import smooth_scene
from torch_threads import one_torch_thread  # noqa: F401

NAMES = sorted(jstd.ALL_STANDARDS)

VARIANTS = [(n, {}) for n in NAMES] + [
    ("ntsc", {"equiband": True}),
    ("ntsc", {"i_bandwidth": 1.5e6, "q_bandwidth": 0.5e6}),
    ("niir", {"reference_amplitude": 0.2}),
]


def test_same_standards_and_names():
    assert sorted(tstd.ALL_STANDARDS) == NAMES
    assert sorted(tstd.__all__) == sorted(jstd.__all__)


@pytest.mark.parametrize("name,kw", VARIANTS, ids=lambda v: str(v))
def test_configs_equal_field_for_field(name, kw):
    t, j = tstd.ALL_STANDARDS[name](**kw), jstd.ALL_STANDARDS[name](**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert type(t.chroma).__name__ == type(j.chroma).__name__
    assert t.is_fm == j.is_fm
    np.testing.assert_array_equal(t.rgb_to_ycc_np(), j.rgb_to_ycc_np())
    np.testing.assert_array_equal(t.ycc_to_rgb_np(), j.ycc_to_rgb_np())
    for n in (720, 1440):
        assert t.sample_rate(n) == j.sample_rate(n)
    hash(t)


@pytest.mark.parametrize("name", NAMES)
def test_decoder_rules_agree(name):
    t, j = tstd.ALL_STANDARDS[name](), jstd.ALL_STANDARDS[name]()
    assert tdec.allowed_decoders(t) == jdec.allowed_decoders(j)
    assert tdec.temporal_comb_spacing(t) == jdec.temporal_comb_spacing(j)
    assert tdec.comb_spacing(t) == jdec.comb_spacing(j)
    assert tdec.comb_flip_error(t) == jdec.comb_flip_error(j)


def test_constants_equal():
    for k in ("QAM_DECODERS", "FM_DECODERS", "NIIR_DECODERS", "ADAPTIVE_EPS",
              "ADAPTIVE_BIAS", "COMB_FLIP_TOL"):
        assert getattr(tdec, k) == getattr(jdec, k), k
    assert tbase.LUMA_ROW == jbase.LUMA_ROW
    assert tstd.T_ACTIVE_601 == jstd.T_ACTIVE_601
    for ch, s in (("R", 0.877), ("B", -1.902)):
        assert tbase.diff_row(ch, s) == jbase.diff_row(ch, s)


@pytest.mark.parametrize("shape,seed", [((16, 720), 0), ((5, 97), 3), ((576, 1440), 7)])
def test_smooth_scene_bit_equal(shape, seed):
    np.testing.assert_array_equal(smooth_scene(*shape, seed=seed),
                                  jax_smooth_scene(*shape, seed=seed))


@pytest.mark.parametrize("name", ["ntsc", "pal", "niir", "secam"])
def test_plan_from_either_config_is_the_same(name):
    """The port's plans take the port's configurations and, as the
    cross-package tests pass them, the JAX package's: the same buffers."""
    a = make_plan(tstd.ALL_STANDARDS[name](), 720)
    b = make_plan(jstd.ALL_STANDARDS[name](), 720)
    assert type(a) is type(b)
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].equal(sb[k]), k
