"""Plain FIR application: a 'same' linear convolution as a Toeplitz matmul.

``x @ M`` with the ``(N, N)`` banded Toeplitz matrix of the taps equals
``np.convolve(line, taps, 'same')`` per line, with zero-padded edges.  The
held-edge variant folds ``np.pad(mode='edge')`` into the matrix.  These are
the plain versions the CUDA kernels are held against; the kernels compute
the same sums directly over the taps (``csrc/fir.cuh``) or as products of
8x8 Toeplitz tiles on the tensor cores (``csrc/band_fir.cuh``, tiles from
``kernels/tiles.py``).  Port of
``color_modem_tpu/dsp/apply.py`` (``toeplitz_same``, ``toeplitz_same_held``,
``fir_same``, ``fir_same_held``).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.utils.tracing import span


def _frozen_f32(mat: np.ndarray) -> np.ndarray:
    mat = mat.astype(np.float32)
    mat.flags.writeable = False  # the cache hands the same array to every caller
    return mat


@lru_cache(maxsize=64)
def _toeplitz_cached(taps_bytes: bytes, t: int, n: int) -> np.ndarray:
    taps = np.frombuffer(taps_bytes, dtype=np.float64)
    half = (t - 1) // 2
    mat = np.zeros((n, n), dtype=np.float64)
    # out[j] = sum_k taps[k] * x[j + half - k]  (np.convolve 'same'); the
    # orientation matters for asymmetric taps
    for k in range(t):
        d = half - k  # x index offset
        col = np.arange(max(0, -d), min(n, n - d))
        mat[col + d, col] = taps[k]
    return _frozen_f32(mat)


def toeplitz_same(taps, n: int) -> np.ndarray:
    """(N, N) float32 matrix M with ``x @ M == np.convolve(x, taps, 'same')``."""
    taps = np.asarray(taps, dtype=np.float64)
    return _toeplitz_cached(taps.tobytes(), len(taps), n)


@lru_cache(maxsize=64)
def _toeplitz_held_cached(taps_bytes: bytes, t: int, n: int, nv: int) -> np.ndarray:
    taps = np.frombuffer(taps_bytes, dtype=np.float64)
    half = (t - 1) // 2
    mat = np.zeros((n, n), dtype=np.float64)
    j = np.arange(nv)
    # out[j] = sum_k taps[k] * x[clip(j + half - k, 0, nv-1)]
    for k in range(t):
        src = np.clip(j + half - k, 0, nv - 1)
        np.add.at(mat, (src, j), taps[k])
    return _frozen_f32(mat)


def toeplitz_same_held(taps, n: int, n_valid: int | None = None) -> np.ndarray:
    """(N, N) float32 matrix M with ``x @ M`` the held-edge 'same'
    convolution: taps that fall outside the line read the edge sample
    instead of zero.  ``n_valid`` < n restricts the outputs and the held
    edge to the first ``n_valid`` columns."""
    taps = np.asarray(taps, dtype=np.float64)
    return _toeplitz_held_cached(taps.tobytes(), len(taps), n, n_valid or n)


#: the per-backend float32 matmul precision flags of PyTorch >= 2.9
_FP32_FLAGS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextmanager
def full_float32():
    """Run float32 matrix products in full float32 inside the block, whatever
    the process-wide setting (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32``, or the per-backend
    ``fp32_precision`` flags where PyTorch has them), and restore the
    caller's setting on the way out.  The JAX package pins each product's
    precision the same way (``Precision.HIGH``/``HIGHEST``).  The setting is
    process-wide, so two threads must not race through this block."""
    if all(hasattr(f, "fp32_precision") for f in _FP32_FLAGS):
        saved = [f.fp32_precision for f in _FP32_FLAGS]
        try:
            for f in _FP32_FLAGS:
                f.fp32_precision = "ieee"
            yield
        finally:
            for f, v in zip(_FP32_FLAGS, saved):
                f.fp32_precision = v
        return
    saved = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def matmul_f32(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``x @ mat`` in full float32 (:func:`full_float32`)."""
    with full_float32():
        return torch.matmul(x, mat)


def fir_same(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Convolve the last axis of ``x`` (..., N) with the filter whose
    :func:`toeplitz_same` matrix is ``mat``, in full float32."""
    return matmul_f32(x, mat)


@lru_cache(maxsize=64)
def _toeplitz_on(taps_bytes: bytes, n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(toeplitz_same(np.frombuffer(taps_bytes, np.float64), n), device=device)


def fir_same_taps(x: torch.Tensor, taps) -> torch.Tensor:
    """:func:`fir_same` for host ``taps``: the taps' (N, N) Toeplitz matrix
    is built and uploaded once per (taps, width, device), and shared by
    every caller, who must not write to it."""
    taps = np.asarray(taps, np.float64).tobytes()
    return fir_same(x, _toeplitz_on(taps, x.shape[-1], x.device))


def fir_same_held(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Held-edge 'same' convolution, ``mat`` from :func:`toeplitz_same_held`.

    The boundary rule of baseband signals: the analog line continues
    through blanking at about its edge value, so a zero edge would put a
    full-scale step through the long SECAM emphasis filters.  Carrier-band
    filters keep the zero edge of :func:`fir_same`.
    """
    return matmul_f32(x, mat)


@lru_cache(maxsize=128)
def _spectrum_cached(taps_bytes: bytes, dtype: str, n: int, real: bool,
                     device: torch.device) -> torch.Tensor:
    with span("cm.build.spectrum"):
        taps = np.frombuffer(taps_bytes, dtype=dtype)
        if real:
            spec = np.fft.rfft(np.pad(taps.astype(np.float64), (0, n - len(taps))))
        else:
            spec = np.fft.fft(np.pad(taps.astype(np.complex128), (0, n - len(taps))))
        return torch.tensor(spec.astype(np.complex64), device=device)


def kernel_spectrum(taps, n: int, real: bool, device: torch.device) -> torch.Tensor:
    """complex64 spectrum of ``taps`` zero-padded to ``n``: the float64
    ``rfft`` (``real``) or the complex128 ``fft``, computed on the host and
    uploaded once per (taps, n, kind, device)."""
    taps = np.ascontiguousarray(taps)
    return _spectrum_cached(taps.tobytes(), taps.dtype.str, int(n), bool(real),
                            torch.device(device))


def fir_same_fft(x: torch.Tensor, taps) -> torch.Tensor:
    """FFT form of :func:`fir_same` for host ``taps``: one zero-padded
    power-of-two ``rfft``/``irfft`` pair per line, with the same 'same'
    centring and zero edges as ``np.convolve(mode='same')``."""
    taps = np.asarray(taps)
    (t,) = taps.shape
    n = x.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + t - 1)))
    spec = kernel_spectrum(taps, nfft, True, x.device)
    y = torch.fft.irfft(torch.fft.rfft(x, n=nfft, dim=-1) * spec, n=nfft, dim=-1)
    lo = (t - 1) // 2
    return y[..., lo : lo + n].to(x.dtype)
