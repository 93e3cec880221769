"""Band tiles of the tensor-core FIR (``csrc/band_fir.cuh``), built on the
host from the float64 taps and split into TF32 hi and lo parts.

Two products use them.  The QAM kernels put 16 lines on the rows of
``mma.m16n8k8`` and 8 outputs on its columns: their tiles are the 8x8
Toeplitz B operands (:func:`band_tiles`).  The SECAM kernels put 16
outputs on the rows and 8 lines on the columns: their tiles are 16x8
Toeplitz A operands, read from a table of the reversed taps
(:func:`band_tiles16`).  The fragment orders live here
and in ``band_fir.cuh`` alone; the plans keep the tiles as buffers and
``kernels/fir.py`` builds them for the FIR check."""

from __future__ import annotations

import numpy as np

#: outputs (and input samples) per tile of the banded product
BAND_TILE = 8


def band_steps(ntaps: int) -> int:
    """S, the number of 8x8 Toeplitz tiles that cover ``ntaps`` taps for one
    tile of 8 outputs: ``(T + 6) // 8 + 1``."""
    return (ntaps + 6) // BAND_TILE + 1


def round_tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds: the low 13 bits cleared."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32_host(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 -> (hi, lo) TF32 values with hi + lo = v to about 2^-22
    relative: the Hopper counterpart of the JAX package's
    ``kernels/common.py::split_bf16_host``."""
    v = np.asarray(v, np.float64)
    hi = round_tf32(v.astype(np.float32))
    lo = round_tf32((v - hi.astype(np.float64)).astype(np.float32))
    return hi, lo


def band_tile_matrices(taps) -> np.ndarray:
    """(S, 8, 8) float64 tiles ``B_s[u, r] = tr[8s + u - r]`` (0 outside
    ``[0, T)``), ``tr`` the taps reversed: ``out[8t + r] = sum_s sum_u
    x~[8(t + s) + u] B_s[u, r]`` with ``x~[i] = x[i - (T - 1) / 2]``."""
    taps = np.asarray(taps, np.float64)
    t = len(taps)
    m = (BAND_TILE * np.arange(band_steps(t))[:, None, None]
         + np.arange(BAND_TILE)[None, :, None] - np.arange(BAND_TILE)[None, None, :])
    inside = (m >= 0) & (m < t)
    return np.where(inside, taps[::-1][np.clip(m, 0, t - 1)], 0.0)


def band_tiles(taps) -> np.ndarray:
    """(S, 32, 4) float32 B fragments of ``mma.m16n8k8`` for the taps' band
    tiles, split into TF32 hi and lo parts: tile ``s``, lane ``(g, q) =
    (lane // 4, lane % 4)`` -> ``(b0_hi, b1_hi, b0_lo, b1_lo)`` with ``b0 =
    B_s[q, g]``, ``b1 = B_s[q + 4, g]``."""
    mats = band_tile_matrices(taps)
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    b0, b1 = mats[:, q, g], mats[:, q + 4, g]
    (h0, l0), (h1, l1) = split_tf32_host(b0), split_tf32_host(b1)
    return np.ascontiguousarray(np.stack([h0, h1, l0, l1], axis=-1), dtype=np.float32)


def band_steps16(ntaps: int) -> int:
    """S, the number of 16x8 Toeplitz tiles that cover ``ntaps`` taps for one
    tile of 16 outputs: ``(T + 14) // 8 + 1``."""
    return (ntaps + 14) // BAND_TILE + 1


def band_tiles16(taps) -> np.ndarray:
    """(8S + 24, 2) float32 table of the reversed taps, split into TF32 hi
    and lo parts: row ``m + 16`` is ``(hi, lo)`` of ``tr[m]`` (0 outside
    ``[0, T)``).  The 16x8 tiles' A fragments are read from it: lane ``(g,
    q) = (lane // 4, lane % 4)`` of step ``s`` takes ``a0 = A_s[g, q]``,
    ``a1 = A_s[g + 8, q]``, ``a2 = A_s[g, q + 4]``, ``a3 = A_s[g + 8, q +
    4]``, that is ``tr`` at ``d``, ``d - 8``, ``d + 4``, ``d - 4`` with ``d =
    8s + q - g``, so a step reuses half of the previous step's values."""
    taps = np.asarray(taps, np.float64)
    t = len(taps)
    m = np.arange(BAND_TILE * band_steps16(t) + 24) - 16
    inside = (m >= 0) & (m < t)
    hi, lo = split_tf32_host(np.where(inside, taps[::-1][np.clip(m, 0, t - 1)], 0.0))
    return np.ascontiguousarray(np.stack([hi, lo], axis=-1), dtype=np.float32)
