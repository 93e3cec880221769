"""The port's native frame codec (``color_modem_tpu_torch/native``), its Y4M
and image I/O (``frame/y4m.py``, ``frame/image_io.py``), against its own
NumPy path and against the JAX package's codec, on the CPU.

The checks of ``tests/test_native.py``, on the port's codec: the C++ path
equals the NumPy path exactly.  Against the JAX package: the C++ source is
the same file byte for byte, and the PPM bytes, the Y4M decode and the
``write_y4m`` output are equal byte for byte (bit for bit on the decoded
floats).
"""

import os

import numpy as np
import pytest

from color_modem_tpu import native as jnative
from color_modem_tpu.frame import y4m as jy4m
from color_modem_tpu_torch import native
from color_modem_tpu_torch.frame import image_io, y4m
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rgb8():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(2, 17, 33, 3), dtype=np.uint8)


def test_native_library_builds():
    # g++ is on this host: the codec must compile, into the package's build dir
    assert native.available()
    assert any(p.name.startswith("frameio_") for p in native.BUILD_DIR.glob("*.so"))


def test_source_is_the_reference_s():
    with open(os.path.join(REPO, "color_modem_tpu", "native", "frameio.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "color_modem_tpu_torch", "native", "frameio.cpp"), "rb") as f:
        assert f.read() == want


def test_u8_to_f32_matches_numpy(rgb8):
    got = native.rgb8_to_chw_f32(rgb8)
    want = rgb8.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    assert got.shape == (2, 3, 17, 33) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_f32_to_u8_roundtrip(rgb8):
    np.testing.assert_array_equal(native.chw_f32_to_rgb8(native.rgb8_to_chw_f32(rgb8)), rgb8)


def test_f32_to_u8_clamps():
    x = np.array([[[[-0.5, 0.0, 0.5, 1.0, 2.0]]] * 3], dtype=np.float32)
    out = native.chw_f32_to_rgb8(x)
    np.testing.assert_array_equal(out[0, 0, :, 0], [0, 0, 128, 255, 255])


def test_ppm_roundtrip(tmp_path, rgb8):
    p = str(tmp_path / "x.ppm")
    native.write_ppm(p, rgb8[0])
    np.testing.assert_array_equal(native.read_ppm(p), rgb8[0])


def test_ppm_read_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad.ppm")
    with open(p, "wb") as f:
        f.write(b"JUNKJUNKJUNK")
    with pytest.raises((OSError, ValueError)):
        native.read_ppm(p)


def test_numpy_fallback_paths(rgb8, monkeypatch):
    """The NumPy path gives what the native path gives."""
    ref_f = native.rgb8_to_chw_f32(rgb8)
    ref_u = native.chw_f32_to_rgb8(ref_f)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", True)
    np.testing.assert_array_equal(native.rgb8_to_chw_f32(rgb8), ref_f)
    np.testing.assert_array_equal(native.chw_f32_to_rgb8(ref_f), ref_u)


def test_out_parameter_reuse(rgb8):
    out = np.empty((2, 3, 17, 33), np.float32)
    assert native.rgb8_to_chw_f32(rgb8, out) is out
    np.testing.assert_array_equal(out, native.rgb8_to_chw_f32(rgb8))
    back = np.empty((2, 17, 33, 3), np.uint8)
    assert native.chw_f32_to_rgb8(out, back) is back
    np.testing.assert_array_equal(back, rgb8)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.rgb8_to_chw_f32(rgb8, np.empty((2, 3, 17, 66), np.float32)[..., ::2])


def _y4m_chunk(count=3, h=12, w=16, sv=2, sh=2, seed=1):
    """Raw planar frames with FRAME markers, like a .y4m body."""
    rng = np.random.default_rng(seed)
    ch, cw = h // sv, w // sh
    marker = len(b"FRAME\n")
    stride = marker + h * w + 2 * ch * cw
    raw = bytearray()
    for _ in range(count):
        raw += b"FRAME\n"
        raw += rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
        raw += rng.integers(0, 256, 2 * ch * cw, dtype=np.uint8).tobytes()
    return bytes(raw), count, stride, marker, h, w, ch, cw, sv, sh


@pytest.mark.parametrize("sv,sh", [(2, 2), (1, 2), (1, 1)])
def test_y4m_decode_native_matches_fallback(monkeypatch, sv, sh):
    args = _y4m_chunk(sv=sv, sh=sh)
    got = native.y4m_to_rgb(*args)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", True)
    np.testing.assert_array_equal(got, native.y4m_to_rgb(*args))


def test_y4m_decode_range_and_shape():
    out = native.y4m_to_rgb(*_y4m_chunk(count=2, h=8, w=10))
    assert out.shape == (2, 3, 8, 10) and out.dtype == np.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_prefetch_source_equivalence():
    """The double-buffered loader returns exactly what the source would,
    sequential or not, and keeps working past a seek."""
    calls = []

    def source(start, count):
        calls.append((start, count))
        return np.arange(start, start + count, dtype=np.float32)

    wrapped = y4m.prefetch_source(source, n_frames=10)
    np.testing.assert_array_equal(wrapped(0, 4), [0, 1, 2, 3])
    np.testing.assert_array_equal(wrapped(4, 4), [4, 5, 6, 7])   # prefetched
    np.testing.assert_array_equal(wrapped(8, 2), [8, 9])          # tail
    np.testing.assert_array_equal(wrapped(2, 3), [2, 3, 4])       # random seek
    assert (0, 4) in calls and (4, 4) in calls


# --- against the JAX package ---------------------------------------------------------------


@pytest.mark.parametrize("sv,sh", [(2, 2), (1, 2), (1, 1)])
def test_y4m_decode_equals_jax_s(sv, sh):
    args = _y4m_chunk(count=4, h=24, w=40, sv=sv, sh=sh, seed=sv + 3 * sh)
    np.testing.assert_array_equal(native.y4m_to_rgb(*args), jnative.y4m_to_rgb(*args))


def test_ppm_bytes_equal_jax_s(tmp_path, rgb8):
    rgb = native.rgb8_to_chw_f32(rgb8)[0] * 1.1 - 0.05  # past both rails
    image_io.save_rgb(str(tmp_path / "t.ppm"), rgb)
    from color_modem_tpu.frame import image_io as jio

    jio.save_rgb(str(tmp_path / "j.ppm"), rgb)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()
    np.testing.assert_array_equal(image_io.load_rgb(str(tmp_path / "t.ppm")),
                                  jio.load_rgb(str(tmp_path / "j.ppm")))


def _frames(n=5, h=24, w=40, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3, h, w)) * 1.2 - 0.1).astype(np.float32)


def test_write_y4m_bytes_equal_jax_s_and_read_back(tmp_path):
    """``write_y4m`` writes the JAX writer's bytes; ``y4m_source`` reads
    them back as the JAX reader does, within the 8-bit quantisation."""
    frames = _frames()
    pt, pj = str(tmp_path / "t.y4m"), str(tmp_path / "j.y4m")
    assert y4m.write_y4m(pt, (frames[i : i + 2] for i in range(0, 5, 2)), fps=(25, 1)) == 5
    assert jy4m.write_y4m(pj, (frames[i : i + 2] for i in range(0, 5, 2)), fps=(25, 1)) == 5
    assert (tmp_path / "t.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()
    assert y4m.y4m_info(pt) == jy4m.y4m_info(pj) == (40, 24, (25, 1), "444", 5)
    src, n, h, w = y4m.y4m_source(pt)
    jsrc, *_ = jy4m.y4m_source(pj)
    assert (n, h, w) == (5, 24, 40)
    got = src(1, 3)
    assert isinstance(got, np.ndarray) and got.shape == (3, 3, 24, 40)
    np.testing.assert_array_equal(got, jsrc(1, 3))
    # 8-bit studio-range YCbCr: within a few code values of the input
    assert np.abs(got - np.clip(frames[1:4], 0, 1)).max() < 0.03
    with pytest.raises(ValueError, match="out of range"):
        src(4, 2)


def test_prefetched_y4m_reads_host_arrays_on_a_worker(tmp_path):
    """The loader's worker hands back host arrays, equal to a direct read."""
    import threading

    path = str(tmp_path / "c.y4m")
    y4m.write_y4m(path, [_frames(n=6)])
    src, n, _, _ = y4m.y4m_source(path)
    threads = []

    def spy(start, count):
        threads.append(threading.current_thread())
        return src(start, count)

    wrapped = y4m.prefetch_source(spy, n)
    first, second = wrapped(0, 3), wrapped(3, 3)
    assert isinstance(second, np.ndarray)
    np.testing.assert_array_equal(np.concatenate([first, second]), src(0, 6))
    assert threads[0] is threading.main_thread() and threads[1] is not threading.main_thread()


def test_y4m_header_errors(tmp_path):
    p = tmp_path / "bad.y4m"
    p.write_bytes(b"YUV4MPEG2 W4 C444\nFRAME\n" + bytes(48))
    with pytest.raises(ValueError, match="missing W or H"):
        y4m.y4m_info(str(p))
    p.write_bytes(b"YUV4MPEG2 W4 H4 Cmono\nFRAME\n" + bytes(16))
    with pytest.raises(ValueError, match="unsupported y4m colorspace"):
        y4m.y4m_info(str(p))
