"""The PyTorch port's channel impairments against
``color_modem_tpu/frame/channel.py``, on the CPU.

Without noise the port must equal JAX to the composite bound, 2e-5.  Noise
is drawn from the same JAX key (``utils/prng.py``): the noisy composite is
held to JAX's at that bound too (the draws agree to 1e-6 of a unit
normal), and noise is refused without a key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TEST_SAMPLES, get_plan
from color_modem_tpu.frame import channel as jc
from color_modem_tpu.frame.pipeline import encode_block as jax_encode_block
from color_modem_tpu.frame.pipeline import frame_line_index as jax_frame_line_index
from color_modem_tpu.frame.raster import add_raster, make_raster
from color_modem_tpu.utils.metrics import psnr as np_psnr
from color_modem_tpu.utils.testimages import smooth_scene
from color_modem_tpu_torch.frame import channel
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.modem.plan import plan_from_numpy
from color_modem_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

ENC_ATOL = 2e-5
L, N = 48, TEST_SAMPLES

IMPAIRMENTS = {
    "ghost": dict(ghost_delay_us=1.0, ghost_gain=0.25),
    "ghost-negative-long": dict(ghost_delay_us=60.0, ghost_gain=-0.4),
    "gain": dict(chroma_gain=0.6),
    "phase": dict(chroma_phase_deg=25.0),
    "gain-phase": dict(chroma_gain=0.7, chroma_phase_deg=-30.0),
    "diff-gain": dict(diff_gain=-0.4),
    "diff-phase": dict(diff_phase_deg=20.0),
    "everything": dict(ghost_delay_us=0.8, ghost_gain=0.2, chroma_gain=0.8,
                       chroma_phase_deg=10.0, diff_gain=0.3, diff_phase_deg=-15.0),
}


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _composite(name, frames=2, rastered=False):
    """(jax plan, port plan, JAX composite) of two smooth frames."""
    jp = get_plan(name)
    rgb = np.stack([smooth_scene(L, N, seed=9 + f) for f in range(frames)])
    g = jax_frame_line_index(jp, 1, frames, L)
    comp = jax_encode_block(jp, jnp.asarray(rgb.astype(np.float32)), g)
    if rastered:
        comp = add_raster(jp, make_raster(jp), comp, g)
    return jp, plan_from_numpy(jp), np.array(comp)


@pytest.mark.parametrize("case", sorted(IMPAIRMENTS))
@pytest.mark.parametrize("name", ["ntsc", "pal", "secam"])
def test_impair_matches_jax(name, case):
    jp, tp, comp = _composite(name)
    kw = IMPAIRMENTS[case]
    ref = np.asarray(jc.impair(jp, jnp.asarray(comp), **kw))
    got = channel.impair(tp, t(comp), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ENC_ATOL)
    assert np.abs(ref - comp).max() > 0.01  # the channel really did something


@pytest.mark.parametrize("name", ["ntsc", "pal", "niir"])
def test_impair_rastered_matches_jax(name):
    """Rastered lines (858/864 samples): the burst rides the chroma path."""
    jp, tp, comp = _composite(name, frames=1, rastered=True)
    kw = dict(chroma_phase_deg=25.0, chroma_gain=0.6)
    ref = np.asarray(jc.impair(jp, jnp.asarray(comp), **kw))
    np.testing.assert_allclose(channel.impair(tp, t(comp), **kw).numpy(), ref, atol=ENC_ATOL)


@pytest.mark.parametrize("delay_us", [0.0, 0.4])
@pytest.mark.parametrize("name", ["ntsc", "pal", "secam"])
def test_vhs_playback_matches_jax(name, delay_us):
    jp, tp, comp = _composite(name)
    ref = np.asarray(jc.vhs_playback(jp, jnp.asarray(comp), chroma_delay_us=delay_us))
    got = channel.vhs_playback(tp, t(comp), chroma_delay_us=delay_us)
    np.testing.assert_allclose(got.numpy(), ref, atol=ENC_ATOL)


def test_clean_channel_is_identity():
    _, tp, comp = _composite("ntsc")
    assert torch.equal(channel.impair(tp, t(comp)), t(comp))


def test_band_edges_and_stream_delay_match_jax():
    for name in ("ntsc", "pal", "niir", "secam"):
        jp = get_plan(name)
        assert channel._chroma_band_edges(plan_from_numpy(jp)) == jc._chroma_band_edges(jp)
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 7)).astype(np.float32)
    for d in (1, 7, 9, 34):
        assert np.array_equal(channel._stream_delay(t(x), d).numpy(),
                              np.asarray(jc._stream_delay(jnp.asarray(x), d)))


def test_noise_is_reproducible_with_the_asked_sigma():
    """The noise is JAX's from the same key, with the other impairments
    before it, and has the asked-for sigma (within 2%)."""
    jp, tp, comp = _composite("pal")
    sigma = 0.05
    kw = dict(noise_sigma=sigma, chroma_gain=0.8, ghost_delay_us=1.0, ghost_gain=0.2)
    a = channel.impair(tp, t(comp), key=prng.PRNGKey(7), **kw)
    want = np.asarray(jc.impair(jp, jnp.asarray(comp), key=jax.random.PRNGKey(7), **kw))
    np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=ENC_ATOL)
    b = channel.impair(tp, t(comp), key=prng.PRNGKey(7), **kw)
    c = channel.impair(tp, t(comp), key=prng.PRNGKey(8), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    std = float((a - channel.impair(tp, t(comp), **{**kw, "noise_sigma": 0.0})).std())
    assert abs(std - sigma) <= 0.02 * sigma, std


def test_noise_requires_a_generator():
    """Noise without a key raises, in both packages."""
    jp, tp, comp = _composite("ntsc", frames=1)
    with pytest.raises(ValueError, match="PRNG key"):
        channel.impair(tp, t(comp), noise_sigma=0.1)
    with pytest.raises(ValueError, match="PRNG key"):
        jc.impair(jp, jnp.asarray(comp), noise_sigma=0.1)


def test_ghost_validation_matches_jax():
    jp, tp = get_plan("ntsc"), plan_from_numpy(get_plan("ntsc"))
    comp = np.zeros((2, N), np.float32)
    for kw, msg in ((dict(ghost_gain=0.3), "ghost_delay_us"),
                    (dict(ghost_gain=0.3, ghost_delay_us=1e6), "exceeds")):
        with pytest.raises(ValueError, match=msg):
            channel.impair(tp, t(comp), **kw)
        with pytest.raises(ValueError, match=msg):
            jc.impair(jp, jnp.asarray(comp), **kw)


def test_niir_cancels_gain_and_phase_where_ntsc_does_not():
    """The reason NIIR exists, through the port's own pipeline: a 25-degree,
    0.6x chroma channel costs NIIR under 1.5 dB and NTSC over 8 dB."""
    rgb = smooth_scene(L, N, seed=9)[None].astype(np.float32)
    loss = {}
    for name in ("niir", "ntsc"):
        tp = plan_from_numpy(get_plan(name))
        enc, dec, _ = make_pipeline(tp, "notch", "kernel", device="cpu")
        comp = enc(rgb, 0)
        bad = channel.impair(tp, comp, chroma_phase_deg=25.0, chroma_gain=0.6)
        loss[name] = np_psnr(dec(comp, 0).numpy(), rgb) - np_psnr(dec(bad, 0).numpy(), rgb)
    assert loss["niir"] < 1.5 and loss["ntsc"] > 8.0, loss


def test_channel_filters_upload_once():
    """Each Toeplitz matrix of the channel's FIRs is built and uploaded once
    per (taps, width, device) (``dsp/apply.py::fir_same_taps``, which the
    data services share) and equals toeplitz_same's."""
    from color_modem_tpu_torch.dsp import apply
    from color_modem_tpu_torch.dsp.apply import toeplitz_same

    taps = np.random.default_rng(0).normal(size=63)
    x = torch.tensor(np.random.default_rng(1).normal(size=(2, 3, 97)), dtype=torch.float32)
    first = channel._fir(x, taps)
    hits = apply._toeplitz_on.cache_info().hits
    torch.testing.assert_close(channel._fir(x, taps), first, rtol=0, atol=0)
    assert apply._toeplitz_on.cache_info().hits == hits + 1
    mat = apply._toeplitz_on(taps.tobytes(), 97, torch.device("cpu"))
    np.testing.assert_array_equal(mat.numpy(), toeplitz_same(taps, 97))
