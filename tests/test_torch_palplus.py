"""The PyTorch port's PALplus (``color_modem_tpu_torch/frame/palplus.py``)
against ``color_modem_tpu/frame/palplus.py`` and the frozen
``golden/palplus.py`` on the CPU, PAL at 64 lines x 720 samples.

Bounds: the geometry and the helper taps are identical; the composite
agrees with JAX's to 2e-5 (the encode bound of tests/test_kernels.py) and
the decoded RGB to 5e-4 (the decode bound), helper on and off, progressive
and interlaced, with and without the raster; against the golden oracle
the parity is above tests/test_golden_palplus.py's bounds for the JAX
package on the same fixture (115-125 dB; ROADMAP.md's floor for golden
parity is 60 dB).  On the CPU the ``kernel`` backend runs its plain versions, so
both backends are held here; on the card the letterbox rows go through the
``_shared`` QAM kernels (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import get_plan
from color_modem_tpu.frame import palplus as jpp
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.golden import palplus as gp
from color_modem_tpu.utils.metrics import psnr
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import palplus as tpp
from color_modem_tpu_torch.frame.pipeline import frame_line_index
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

L, N = 64, 720
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
#: tests/test_golden_palplus.py's parity bounds, dB
BANK_DB, HELPER_DB, ENCODE_DB, DECODE_DB = 120.0, 125.0, 120.0, 115.0


def _parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


@pytest.fixture(scope="module")
def plans():
    jp = get_plan("pal")
    return jp, plan_from_numpy(jp)


@pytest.fixture(scope="module")
def rgb():
    """tests/test_golden_palplus.py's fixture: a smooth scene plus
    helper-band vertical detail."""
    vert = 0.25 * np.cos(2 * np.pi * 0.42 * np.arange(L)[:, None])
    return np.clip(smooth_scene(L, N, seed=11) + vert[None], 0.0, 1.0).astype(np.float32)


def test_constants_are_identical(plans):
    jp, tp = plans
    assert np.array_equal(tpp._helper_taps(tp), jpp._helper_taps(jp))
    for lines in (64, 576, 128):
        a, b = tpp.PalPlusGeometry(lines), jpp.PalPlusGeometry(lines)
        assert vars(a) == vars(b)
    assert np.array_equal(tpp._row_sign(L, torch.device("cpu")).numpy(), jpp._row_sign(L))
    assert (tpp.HELPER_BW_HZ, tpp.HELPER_CLIP) == (jpp.HELPER_BW_HZ, jpp.HELPER_CLIP)


def test_geometry_refusals(plans):
    jp, tp = plans
    with pytest.raises(ValueError, match="divisible by 8"):
        tpp.PalPlusGeometry(60)
    with pytest.raises(ValueError, match="divisible by 16"):
        tpp.encode_palplus_fields(tp, torch.zeros(1, 3, 56, N), 0)
    with pytest.raises(ValueError, match="is FM"):
        tpp.make_palplus_pipeline(plan_from_numpy(get_plan("secam")), device="cpu")


def test_vertical_bank_matches_jax_and_golden(rgb):
    geo = tpp.PalPlusGeometry(L)
    down, helper = tpp.helper_encode(geo, torch.tensor(rgb[0]))
    down_j, helper_j = jpp.helper_encode(jpp.PalPlusGeometry(L), jnp.asarray(rgb[0]))
    np.testing.assert_allclose(down.numpy(), np.asarray(down_j), rtol=0, atol=ENC_ATOL)
    np.testing.assert_allclose(helper.numpy(), np.asarray(helper_j), rtol=0, atol=ENC_ATOL)
    down_g, helper_g = gp.helper_encode(L, rgb[0])
    assert _parity_db(down, down_g) > BANK_DB and _parity_db(helper, helper_g) > HELPER_DB
    rec = tpp.helper_reconstruct(geo, down, helper)
    assert _parity_db(rec, gp.helper_reconstruct(L, down_g, helper_g)) > BANK_DB
    # tests/test_palplus.py: helper-band detail survives the two bands, and
    # the letterbox alone loses it
    interior = slice(8, -8)
    assert psnr(rec.numpy()[interior], rgb[0][interior]) - psnr(
        tpp.resample_lines(down, L).numpy()[interior], rgb[0][interior]) > 8.0


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_progressive_matches_jax_and_golden(plans, rgb, backend):
    jp, tp = plans
    g = frame_line_index(tp, 3, 1, L, "cpu")
    comp = tpp.encode_palplus(tp, torch.tensor(rgb)[None], g, backend)
    comp_j = np.asarray(jpp.encode_palplus(jp, jnp.asarray(rgb)[None],
                                           jax_frame_line_index(jp, 3, 1, L)))
    np.testing.assert_allclose(comp.numpy(), comp_j, rtol=0, atol=ENC_ATOL)
    taps = jpp._helper_taps(jp)
    comp_g = gp.encode_palplus(jp, rgb, taps, frame=3)
    assert _parity_db(comp[0], comp_g) > ENCODE_DB
    for use_helper in (True, False):
        out = tpp.decode_palplus(tp, torch.tensor(comp_g, dtype=torch.float32)[None], g,
                                 "comb3", backend, use_helper=use_helper)[0]
        out_g = gp.decode_palplus(jp, comp_g, taps, frame=3, decoder="comb3",
                                  use_helper=use_helper)
        assert _parity_db(out, out_g) > DECODE_DB, use_helper
        out_j = np.asarray(jpp.decode_palplus(jp, jnp.asarray(comp_g, jnp.float32)[None],
                                              jax_frame_line_index(jp, 3, 1, L), "comb3",
                                              use_helper=use_helper))[0]
        np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=DEC_ATOL)


def test_interlaced_matches_jax_and_golden(plans, rgb):
    jp, tp = plans
    comp = tpp.encode_palplus_fields(tp, torch.tensor(rgb)[None], 3)
    assert comp.shape == (2, L // 2, N)
    comp_j = np.asarray(jpp.encode_palplus_fields(jp, jnp.asarray(rgb)[None], 3))
    np.testing.assert_allclose(comp.numpy(), comp_j, rtol=0, atol=ENC_ATOL)
    taps = jpp._helper_taps(jp)
    comp_g = gp.encode_palplus_fields(jp, rgb, taps, frame=3)
    assert _parity_db(comp, comp_g) > ENCODE_DB
    interior = slice(8, -8)
    reads = {}
    for use_helper in (True, False):
        out = tpp.decode_palplus_fields(tp, torch.tensor(comp_g, dtype=torch.float32), 3,
                                        "comb3", use_helper=use_helper)[0]
        out_j = np.asarray(jpp.decode_palplus_fields(
            jp, jnp.asarray(comp_g, jnp.float32), 3, "comb3", use_helper=use_helper))[0]
        np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=DEC_ATOL)
        reads[use_helper] = psnr(out.numpy()[..., interior, :], rgb[..., interior, :])
    # tests/test_golden_palplus.py: the helper buys > 8 dB over the zoom
    assert reads[True] - reads[False] > 8.0, reads


#: (interlaced, raster) -> the pipeline factories of both packages
PIPELINES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("interlaced,raster", PIPELINES)
def test_pipelines_match_jax(plans, interlaced, raster):
    jp, tp = plans
    frames = np.stack([smooth_scene(L, N, seed=s) for s in (3, 4)]).astype(np.float32)
    mk_j = jpp.make_interlaced_palplus_pipeline if interlaced else jpp.make_palplus_pipeline
    mk = tpp.make_interlaced_palplus_pipeline if interlaced else tpp.make_palplus_pipeline
    enc_j, dec_j, rt_j = mk_j(jp, "comb3", "xla", 1.0, raster)
    enc, dec, rt = mk(tp, "comb3", "kernel", 1.0, raster, device="cpu")
    comp_j = np.asarray(enc_j(jnp.asarray(frames), 5))
    comp = enc(frames, 5)
    np.testing.assert_allclose(comp.numpy(), comp_j, rtol=0, atol=ENC_ATOL)
    for use_helper in (True, False):
        out = dec(comp_j, 5, use_helper=use_helper)
        out_j = np.asarray(dec_j(jnp.asarray(comp_j), 5, use_helper=use_helper))
        np.testing.assert_allclose(out.numpy(), out_j, rtol=0, atol=DEC_ATOL)
        assert abs(psnr(out.numpy(), frames) - psnr(out_j, frames)) <= 0.01
    # the round trip skips the raster: strip(add(x)) == x
    np.testing.assert_allclose(rt(frames, 5).numpy(),
                               np.asarray(rt_j(jnp.asarray(frames), 5)), rtol=0, atol=DEC_ATOL)


def test_helper_gain_round_trips(plans, rgb):
    """tests/test_palplus.py: a helper sent at another gain and undone at
    the receiver reads the same picture, to float rounding."""
    _, tp = plans
    frames = torch.tensor(rgb)[None]
    ref = tpp.make_palplus_pipeline(tp, device="cpu")[2](frames)
    half = tpp.make_palplus_pipeline(tp, helper_gain=0.5, device="cpu")[2](frames)
    assert psnr(half.numpy(), ref.numpy()) > 80.0
