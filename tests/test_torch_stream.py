"""The port's overlap-save stream engine (``color_modem_tpu_torch/dsp/
stream.py``) against the direct 'same' convolution (``np.convolve`` +
zero-stuff / decimate) and against the JAX package's ``dsp/stream.py`` on
the same inputs.

Bounds are tests/test_stream.py's: 2e-4 x max for the real filter, 3e-4 x
max for the rate-changing and complex ones, at r in {1, 2, 4}.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from color_modem_tpu.dsp import stream as jstream
from color_modem_tpu_torch.dsp import apply as tapply
from color_modem_tpu_torch.dsp import stream as tstream
from torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(11)


def _same(x, h):
    lo = (len(h) - 1) // 2
    return np.convolve(x, h)[lo : lo + len(x)]


def _batch_same(x, h):
    return np.stack([_same(row, h) for row in x])


def _stuffed(x, r):
    out = np.zeros((x.shape[0], x.shape[1] * r))
    out[:, ::r] = x
    return out


def _close(got, ref, rel):
    got = np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def x_long():
    return RNG.standard_normal((2, 90_000)).astype(np.float32)


@pytest.fixture(scope="module")
def x_short():
    return RNG.standard_normal((2, 24_000)).astype(np.float32)


def test_fir_stream_overlap_save(x_long):
    h = RNG.standard_normal(513)
    got = tstream.fir_stream(torch.from_numpy(x_long), h).numpy()
    ref = _batch_same(x_long, h)
    _close(got, ref, 2e-4)
    _close(got, np.asarray(jstream.fir_stream(jnp.asarray(x_long), h)), 2e-4)


def test_fir_stream_short_falls_back():
    x = RNG.standard_normal((3, 3_000)).astype(np.float32)
    h = RNG.standard_normal(129)
    got = tstream.fir_stream(torch.from_numpy(x), h)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got.numpy(), _batch_same(x, h), 2e-4)
    _close(got.numpy(), np.asarray(tapply.fir_same_fft(torch.from_numpy(x), h)), 1e-7)


def test_conv_complex_stream(x_long):
    ct = RNG.standard_normal(1033) + 1j * RNG.standard_normal(1033)
    got = tstream.conv_complex_stream(torch.from_numpy(x_long), ct)
    assert got.dtype == torch.complex64
    ref = _batch_same(x_long, ct)
    _close(got.numpy(), ref, 3e-4)
    _close(got.numpy(), np.asarray(jstream.conv_complex_stream(jnp.asarray(x_long), ct)), 3e-4)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_upconv_stream(r, x_short):
    ct = tstream.pad_taps_center(RNG.standard_normal(1033) + 1j * RNG.standard_normal(1033),
                                 2 * r)
    got = tstream.upconv_stream(torch.from_numpy(x_short), ct, r).numpy()
    ref = _batch_same(_stuffed(x_short, r), ct)
    _close(got, ref, 3e-4)
    _close(got, np.asarray(jstream.upconv_stream(jnp.asarray(x_short), ct, r)), 3e-4)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_upsample_fir_stream(r, x_short):
    h = tstream.pad_taps_center(RNG.standard_normal(517), 2 * r)
    got = tstream.upsample_fir_stream(torch.from_numpy(x_short), h, r)
    assert got.dtype == torch.float32
    ref = _batch_same(_stuffed(x_short, r), h)
    _close(got.numpy(), ref, 3e-4)
    _close(got.numpy(), np.asarray(jstream.upsample_fir_stream(jnp.asarray(x_short), h, r)),
           3e-4)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_conv_decim_stream(r, x_long):
    ct = tstream.pad_taps_center(RNG.standard_normal(1033) + 1j * RNG.standard_normal(1033),
                                 2 * r)
    got = tstream.conv_decim_stream(torch.from_numpy(x_long), ct, r).numpy()
    ref = _batch_same(x_long, ct)[:, ::r]
    _close(got, ref, 3e-4)
    _close(got, np.asarray(jstream.conv_decim_stream(jnp.asarray(x_long), ct, r)), 3e-4)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_fir_decim_stream(r, x_long):
    h = tstream.pad_taps_center(RNG.standard_normal(517), 2 * r)
    got = tstream.fir_decim_stream(torch.from_numpy(x_long), h, r)
    assert got.dtype == torch.float32
    ref = _batch_same(x_long, h)[:, ::r]
    _close(got.numpy(), ref, 3e-4)
    _close(got.numpy(), np.asarray(jstream.fir_decim_stream(jnp.asarray(x_long), h, r)), 3e-4)


def test_leading_axes_are_kept():
    x = RNG.standard_normal((2, 3, 8_000)).astype(np.float32)
    ct = tstream.pad_taps_center(RNG.standard_normal(257) + 0j, 8)
    got = tstream.conv_decim_stream(torch.from_numpy(x), ct, 4)
    assert got.shape == (2, 3, 2_000)
    ref = _batch_same(x.reshape(6, -1), ct)[:, ::4].reshape(2, 3, -1)
    _close(got.numpy(), ref, 3e-4)


def test_pad_taps_center_matches_jax():
    for t, m in ((515, 8), (1033, 4), (129, 2), (2049, 8)):
        h = RNG.standard_normal(t)
        hp = tstream.pad_taps_center(h, m)
        assert np.array_equal(hp, jstream.pad_taps_center(h, m))
        assert (len(hp) - 1) % m == 0 and len(hp) % 2 == 1
    assert tstream.pick_nblk(2049) == jstream.pick_nblk(2049) == 32768
    assert tstream.pick_nblk(8193) == jstream.pick_nblk(8193) == 65536
    w = 0.37
    assert np.array_equal(tstream._carrier_taps(h, w), jstream._carrier_taps(h, w))


def test_misaligned_taps_and_non_pow2_rate_rejected():
    z = torch.zeros(1, 256)
    with pytest.raises(ValueError, match="2r = 8 must divide"):
        tstream.upconv_stream(z, np.ones(1031), 4)
    with pytest.raises(ValueError, match="odd"):
        tstream.fir_stream(z, np.ones(10))
    with pytest.raises(ValueError, match="power of two"):
        tstream.conv_decim_stream(torch.zeros(1, 3 * 4096), np.ones(13) + 0j, 3)
    with pytest.raises(ValueError, match="not divisible"):
        tstream.fir_decim_stream(torch.zeros(1, 4097), np.ones(9), 4)


def test_kernel_spectra_upload_once():
    """The host spectra are built once per (taps, block, kind, device)."""
    h = RNG.standard_normal(517)
    x = torch.from_numpy(RNG.standard_normal((1, 70_000)).astype(np.float32))
    tstream.fir_stream(x, h)
    info = tapply._spectrum_cached.cache_info()
    tstream.fir_stream(x, h)
    after = tapply._spectrum_cached.cache_info()
    assert after.misses == info.misses and after.hits == info.hits + 1
