"""The PyTorch port's raster layer (sync, colour burst, burst lock, PAL
ident) against ``color_modem_tpu/frame/raster.py``, on the CPU.

Bounds: ``make_raster`` field-equal; ``add_raster`` <= 2e-5 (the composite
bound); ``measure_burst_phase`` <= 1e-5; burst-locked decodes <= 5e-4 (the
decode bound) on tests/test_raster.py's fixtures; ident decisions equal.
The impaired inputs come from the JAX package's own ``impair``, so both
packages decode the same signal.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import TEST_LINES, TEST_SAMPLES, get_plan
from color_modem_tpu.frame import raster as jr
from color_modem_tpu.frame.channel import impair as jax_impair
from color_modem_tpu.frame.pipeline import encode_block as jax_encode_block
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.frame.pipeline import make_pipeline as jax_make_pipeline
from color_modem_tpu.standards import ALL_STANDARDS
from color_modem_tpu.utils.metrics import psnr as np_psnr
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import raster
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
BURST_ATOL = 1e-5
ALL = sorted(ALL_STANDARDS)
QAM = [n for n in ALL if not ALL_STANDARDS[n]().is_fm]
BACKENDS = ["kernel", "plain"]


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _rastered(name, seed=3, frames=1, frame0=0):
    """(jax plan, port plan, RasterPlan, rgb, gline, JAX rastered composite)."""
    jp = get_plan(name)
    rp = jr.make_raster(jp)
    rgb = np.stack([smooth_scene(TEST_LINES, TEST_SAMPLES, seed=seed + f)
                    for f in range(frames)]).astype(np.float32)
    g = jax_frame_line_index(jp, frame0, frames, TEST_LINES)
    comp = jax_encode_block(jp, jnp.asarray(rgb), g)
    return jp, plan_from_numpy(jp), rp, rgb, np.asarray(g), jr.add_raster(jp, rp, comp, g)


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b)))))


@pytest.mark.parametrize("name", ALL)
def test_make_raster_field_equal(name):
    jp = get_plan(name)
    got = raster.make_raster(plan_from_numpy(jp))
    assert dataclasses.asdict(got) == dataclasses.asdict(jr.make_raster(jp))
    assert got.n_blank == jr.make_raster(jp).n_blank


@pytest.mark.parametrize("name", ALL)
def test_add_raster_matches_jax_and_strip_is_exact(name):
    jp, tp, rp, rgb, g, rast_j = _rastered(name, frames=2, frame0=5)
    comp = np.array(jr.strip_raster(rp, rast_j))
    got = raster.add_raster(tp, rp, t(comp), t(g))
    assert got.shape == rast_j.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(rast_j), atol=ENC_ATOL)
    assert np.array_equal(raster.strip_raster(rp, got).numpy(), comp)
    with pytest.raises(ValueError, match="rastered lines"):
        raster.strip_raster(rp, t(comp))


@pytest.mark.parametrize("name", QAM)
def test_measure_burst_phase_matches_jax(name):
    jp, tp, rp, _, g, rast_j = _rastered(name, frames=2, frame0=5)
    amp_j, ph_j = jr.measure_burst_phase(jp, rp, rast_j, jnp.asarray(g))
    amp, ph = raster.measure_burst_phase(tp, rp, t(rast_j), t(g))
    np.testing.assert_allclose(amp.numpy(), np.asarray(amp_j), atol=BURST_ATOL)
    assert _wrapped(ph.numpy(), ph_j).max() <= BURST_ATOL
    # the spec angles: NTSC-family 180 deg, PAL-family +-135 deg by V-switch
    expected = raster._expected_angle(tp, rp, t(g)).numpy()
    assert _wrapped(ph.numpy(), expected).max() < 0.05


def _impaired(name, seed, **impairments):
    jp, tp, rp, rgb, g, rast_j = _rastered(name, seed=seed)
    return jp, tp, rp, rgb, g, np.array(jax_impair(jp, rast_j, **impairments))


# (standard, impairment, decode_burst_locked keywords): tests/test_raster.py's
CASES = {
    "ntsc-phase": ("ntsc", 8, {"chroma_phase_deg": 25.0}, {}),
    "pal-phase": ("pal", 8, {"chroma_phase_deg": 25.0}, {}),
    "ntsc-acc": ("ntsc", 9, {"chroma_gain": 0.5}, {"acc": True}),
    "pal-acc": ("pal", 9, {"chroma_gain": 0.5}, {"acc": True}),
    "ntsc-kill": ("ntsc", 9, {}, {"color_kill": 0.4}),
    "pal-delayline-acc-kill": ("pal", 3, {"chroma_phase_deg": 20.0, "chroma_gain": 0.7},
                               {"acc": True, "color_kill": 0.4, "decoder": "delayline"}),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_burst_locked_matches_jax(case, backend):
    name, seed, imp, kw = CASES[case]
    jp, tp, rp, rgb, g, bad = _impaired(name, seed, **imp)
    kw = dict(kw)
    decoder = kw.pop("decoder", "notch")
    ref = np.asarray(jr.decode_burst_locked(jp, rp, jnp.asarray(bad), jnp.asarray(g),
                                            decoder, **kw))
    reset_launches()
    got = raster.decode_burst_locked(tp, rp, t(bad), t(g), decoder, backend, **kw)
    assert launch_counts()["qam_decode"] == 0  # CPU tensors run the plain versions
    np.testing.assert_allclose(got.numpy(), ref, atol=DEC_ATOL)
    if imp:  # the lock undoes the channel: better than a nominal decode
        _, dec, _ = make_pipeline(tp, decoder, backend, raster=True, device="cpu")
        nominal = np_psnr(dec(bad, 0).numpy(), rgb)
        assert np_psnr(got.numpy(), rgb) > nominal + 0.5, case


def test_color_killer_on_a_monochrome_transmission():
    """No burst on the line: every line's chroma gain is 0, as in JAX."""
    jp, tp, rp, rgb, g, _ = _rastered("ntsc", seed=11)
    mono = dataclasses.replace(rp, burst_len=0)
    comp = jax_encode_block(jp, jnp.asarray(rgb), jnp.asarray(g))
    rast = np.array(jr.add_raster(jp, mono, comp, jnp.asarray(g)))
    ref = np.asarray(jr.decode_burst_locked(jp, rp, jnp.asarray(rast), jnp.asarray(g),
                                            "notch", color_kill=0.4))
    got = raster.decode_burst_locked(tp, rp, t(rast), t(g), "notch", "kernel",
                                     color_kill=0.4)
    np.testing.assert_allclose(got.numpy(), ref, atol=DEC_ATOL)
    assert np.allclose(got.numpy()[:, 0], got.numpy()[:, 2], atol=1e-6)  # grey


@pytest.mark.parametrize("name", ["pal", "pal_m"])
def test_identify_vswitch_matches_jax(name):
    """Slips 0-3 of the receiver's line counter under a 20-degree channel
    phase: the same int32 decisions as JAX, and decode_identified equal to
    JAX's to the decode bound."""
    jp, tp, rp, rgb, g, bad = _impaired(name, 3, chroma_phase_deg=20.0)
    for k in (0, 1, 2, 3):
        g_rx = g + k
        slip_j = np.asarray(jr.identify_vswitch(jp, rp, jnp.asarray(bad), jnp.asarray(g_rx)))
        slip = raster.identify_vswitch(tp, rp, t(bad), t(g_rx))
        assert slip.dtype == torch.int32 and slip.shape == (1,)
        assert np.array_equal(slip.numpy(), slip_j) and int(slip[0]) == k % 2
        out, s2 = raster.decode_identified(tp, rp, t(bad), t(g_rx), "delayline", "kernel")
        ref, _ = jr.decode_identified(jp, rp, jnp.asarray(bad), jnp.asarray(g_rx),
                                      "delayline")
        assert torch.equal(s2, slip)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DEC_ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name,decoder", [("ntsc", "comb3"), ("pal", "delayline"),
                                          ("niir", "avg"), ("secam", "notch")])
def test_rastered_pipeline_roundtrip_identical(name, decoder, backend):
    """encode(raster) then decode(raster) equals the round trip bit for bit,
    and the rastered composite equals JAX's to the composite bound."""
    rgb = smooth_scene(TEST_LINES, TEST_SAMPLES, seed=4)[None].astype(np.float32)
    tp = plan_from_numpy(get_plan(name))
    enc_r, dec_r, _ = make_pipeline(tp, decoder, backend, raster=True, device="cpu")
    _, _, rt = make_pipeline(tp, decoder, backend, device="cpu")
    comp = enc_r(rgb, 2)
    assert torch.equal(dec_r(comp, 2), rt(rgb, 2))
    enc_j, _, _ = jax_make_pipeline(get_plan(name), decoder, raster=True)
    np.testing.assert_allclose(comp.numpy(), np.asarray(enc_j(jnp.asarray(rgb), 2)),
                               atol=ENC_ATOL)


def test_blanking_constants_upload_once():
    """The blanking ramp is reduced mod 2*pi in float64 on the host and
    uploaded once per (frequency, width, device); the sync and burst
    windows are built on the device.  Values are those of the host build."""
    tp = plan_from_numpy(get_plan("ntsc"))
    rp = raster.make_raster(tp)
    k = 2.0 * np.pi * tp.cfg.chroma.fsc / tp.fs
    first = raster._blank_ramp(k, rp.n_blank, torch.device("cpu"))
    assert raster._blank_ramp(k, rp.n_blank, torch.device("cpu")) is first
    m = np.arange(rp.n_blank, dtype=np.float64) - rp.n_blank
    np.testing.assert_array_equal(first.numpy(), ((k * m) % (2.0 * np.pi)).astype(np.float32))
    idx = np.arange(rp.n_blank)
    win = raster._window(rp, rp.burst_start, rp.burst_len, torch.device("cpu"))
    np.testing.assert_array_equal(
        win.numpy(), (idx >= rp.burst_start) & (idx < rp.burst_start + rp.burst_len))
