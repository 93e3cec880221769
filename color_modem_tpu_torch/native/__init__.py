"""Native (C++) host-side frame codec, with a NumPy path of the same results.

Port of ``color_modem_tpu/native/``: uint8 HWC <-> float32 CHW conversion,
PPM read and write, and the threaded Y4M decode live in ``frameio.cpp``
(the same source as the JAX package's), compiled at first use with the
system ``g++`` into ``color_modem_tpu_torch/build/`` (named by a hash of
the source) and bound with ``ctypes``.  On a host without a compiler the
same API runs vectorised NumPy, with identical results
(``tests/test_torch_native.py``).  This is the host codec that feeds the
video runner, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "frameio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
#: -ffp-contract=off: no FMA fusion; the Y4M decode's bit-for-bit parity
#: with the NumPy path depends on separate multiply-then-add rounding
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17", "-pthread")
_VERSION = 2
_LIB = None
_LIB_TRIED = False

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C signatures of the codec's entry points (restype, argtypes)
_SIGNATURES = {
    "cmt_version": (ctypes.c_int, ()),
    "cmt_y4m_to_chw_f32": (None, (_P, _P) + (_I64,) * 7 + (_I,) * 3),
    "cmt_rgb8_hwc_to_chw_f32": (None, (_P, _P, _I64, _I64, _I64, _I)),
    "cmt_chw_f32_to_rgb8_hwc": (None, (_P, _P, _I64, _I64, _I64, _I)),
    "cmt_write_ppm": (ctypes.c_int, (ctypes.c_char_p, _P, _I64, _I64)),
    "cmt_read_ppm": (ctypes.c_int, (ctypes.c_char_p, _P, _I64,
                                    ctypes.POINTER(_I64), ctypes.POINTER(_I64))),
}


def _load():
    """Compile (once per source digest) and dlopen the codec; None when
    there is no compiler or the build fails."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
        so = BUILD_DIR / f"frameio_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(so.name + f".build{os.getpid()}")
            subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True)
            os.replace(tmp, so)  # atomic: concurrent builds race safely
        lib = ctypes.CDLL(str(so))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        if lib.cmt_version() != _VERSION:
            return None
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _threads() -> int:
    # container cgroup limits can make os.cpu_count() report 1 where 8
    # worker threads are much faster; the environment overrides
    return int(os.environ.get("CMT_NATIVE_THREADS", "8"))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def rgb8_to_chw_f32(rgb8: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """(F, L, N, 3) uint8 -> (F, 3, L, N) float32 in [0, 1].

    Pass a preallocated ``out`` in steady-state loops: first-touch page
    faults on fresh large allocations can dominate the conversion.
    """
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    f, l, n, _ = rgb8.shape
    lib = _load()
    if lib is None:
        res = rgb8.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
        if out is not None:
            out[...] = res
            return out
        return np.ascontiguousarray(res)
    if out is None:
        out = np.empty((f, 3, l, n), dtype=np.float32)
    if out.shape != (f, 3, l, n) or out.dtype != np.float32:
        raise ValueError(f"out must be float32 {(f, 3, l, n)}, got {out.dtype} {out.shape}")
    # the C side writes out as one contiguous run from its base pointer
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be C-contiguous")
    lib.cmt_rgb8_hwc_to_chw_f32(_ptr(rgb8), _ptr(out), f, l, n, _threads())
    return out


def chw_f32_to_rgb8(rgb: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """(F, 3, L, N) float32 in [0, 1] -> (F, L, N, 3) uint8 (round + clamp)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.float32)
    f, _, l, n = rgb.shape
    lib = _load()
    if lib is None:
        x = np.clip(rgb.transpose(0, 2, 3, 1) * 255.0 + 0.5, 0.0, 255.0)
        res = x.astype(np.uint8)
        if out is not None:
            out[...] = res
            return out
        return res
    if out is None:
        out = np.empty((f, l, n, 3), dtype=np.uint8)
    if out.shape != (f, l, n, 3) or out.dtype != np.uint8:
        raise ValueError(f"out must be uint8 {(f, l, n, 3)}, got {out.dtype} {out.shape}")
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be C-contiguous")
    lib.cmt_chw_f32_to_rgb8_hwc(_ptr(rgb), _ptr(out), f, l, n, _threads())
    return out


def write_ppm(path: str, rgb8_hwc: np.ndarray) -> None:
    """(L, N, 3) uint8 -> binary PPM."""
    rgb8_hwc = np.ascontiguousarray(rgb8_hwc, dtype=np.uint8)
    l, n, _ = rgb8_hwc.shape
    lib = _load()
    if lib is None:
        with open(path, "wb") as fh:
            fh.write(b"P6\n%d %d\n255\n" % (n, l))
            fh.write(rgb8_hwc.tobytes())
        return
    rc = lib.cmt_write_ppm(os.fsencode(path), _ptr(rgb8_hwc), l, n)
    if rc != 0:
        raise OSError(f"cmt_write_ppm({path}) failed with code {rc}")


def read_ppm(path: str, max_pixels: int = 64 * 1024 * 1024) -> np.ndarray:
    """Binary PPM -> (L, N, 3) uint8."""
    lib = _load()
    if lib is None:
        with open(path, "rb") as fh:
            magic = fh.readline().strip()
            if magic != b"P6":
                raise ValueError(f"{path}: not a binary PPM")
            dims = fh.readline().split()
            n, l = int(dims[0]), int(dims[1])
            maxval = int(fh.readline().split()[0])
            if maxval != 255:
                # 16-bit samples would be silently misread as 8-bit
                raise ValueError(f"{path}: maxval {maxval} != 255")
            data = fh.read(l * n * 3)
        if len(data) != l * n * 3:
            raise ValueError(f"{path}: truncated pixel data")
        return np.frombuffer(data, np.uint8).reshape(l, n, 3).copy()
    # size the scratch from the file itself (pixel data <= file size): a
    # fixed max_pixels*3 buffer would first-touch ~190 MB of pages per call
    cap = min(max_pixels * 3, os.path.getsize(path))
    buf = np.empty(cap, dtype=np.uint8)
    lines, samples = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.cmt_read_ppm(os.fsencode(path), _ptr(buf), buf.size, ctypes.byref(lines),
                          ctypes.byref(samples))
    if rc != 0:
        raise OSError(f"cmt_read_ppm({path}) failed with code {rc}")
    l, n = lines.value, samples.value
    return buf[: l * n * 3].reshape(l, n, 3).copy()


#: BT.601 luma weights (the Y4M convention), shared by the C++ decoder and
#: the NumPy path below; keep in sync with frameio.cpp y4m_body
_KR, _KB = 0.299, 0.114
_KG = 1.0 - _KR - _KB


def y4m_to_rgb(raw: bytes | np.ndarray, count: int, stride: int, marker: int, h: int, w: int,
               ch: int, cw: int, sv: int, sh: int,
               out: np.ndarray | None = None) -> np.ndarray:
    """Raw planar Y4M frames -> (count, 3, h, w) float32 RGB in [0, 1].

    ``raw`` holds ``count`` frames of ``stride`` bytes each, every frame
    ``marker`` bytes of FRAME line followed by planar Y (h*w), Cb, Cr
    (ch*cw each).  BT.601 studio range, nearest-neighbour chroma upsample,
    threaded in C++ when the codec is available, vectorised NumPy
    otherwise.  Both give the same bits: the C++ side mirrors this float32
    operation order (NEP 50 keeps Python scalars weak, so nothing here
    promotes to double), and the build disables FP contraction, so no FMA
    changes the rounding.
    """
    buf = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) \
        else np.ascontiguousarray(raw, dtype=np.uint8)
    if buf.size < count * stride:
        raise ValueError(f"y4m_to_rgb: {buf.size} bytes < {count} frames * {stride}")
    lib = _load()
    if lib is not None:
        if out is None:
            out = np.empty((count, 3, h, w), dtype=np.float32)
        if out.shape != (count, 3, h, w) or out.dtype != np.float32 \
                or not out.flags["C_CONTIGUOUS"]:
            raise ValueError(f"out must be C-contiguous float32 {(count, 3, h, w)}")
        lib.cmt_y4m_to_chw_f32(_ptr(buf), _ptr(out), count, stride, marker, h, w, ch, cw,
                               sv, sh, _threads())
        return out
    res = np.empty((count, 3, h, w), dtype=np.float32)
    frames = buf[: count * stride].reshape(count, stride)
    y8 = frames[:, marker : marker + h * w].reshape(count, h, w)
    cb8 = frames[:, marker + h * w : marker + h * w + ch * cw].reshape(count, ch, cw)
    cr8 = frames[:, marker + h * w + ch * cw : marker + h * w + 2 * ch * cw].reshape(
        count, ch, cw)
    if (sv, sh) != (1, 1):
        cb8 = np.repeat(np.repeat(cb8, sv, 1), sh, 2)[:, :h, :w]
        cr8 = np.repeat(np.repeat(cr8, sv, 1), sh, 2)[:, :h, :w]
    y = (y8.astype(np.float32) - 16.0) / 219.0
    cb = (cb8.astype(np.float32) - 128.0) / 224.0
    cr = (cr8.astype(np.float32) - 128.0) / 224.0
    r = y + 2.0 * (1.0 - _KR) * cr
    b = y + 2.0 * (1.0 - _KB) * cb
    g = (y - _KR * r - _KB * b) / _KG
    res[:] = np.clip(np.stack([r, g, b], axis=1), 0.0, 1.0)
    if out is not None:
        out[...] = res
        return out
    return res
