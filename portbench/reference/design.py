"""Filter design of the reference, NumPy float64: windowed-sinc low- and
band-passes, frequency-sampled designs (the SECAM emphasis pair, cloche and
anti-cloche, the band mask, the differentiator, the VSB filters).

A frozen copy of the system's published design rules (the windows, the
design grid, the Tukey taper), so the reference works every tap out again
from a configuration's parameters and takes none from the program.
"""

from __future__ import annotations

import numpy as np

DESIGN_NFFT = 8192


def _check_odd(ntaps: int) -> None:
    if ntaps % 2 != 1:
        raise ValueError(f"ntaps must be odd for 'same' centering, got {ntaps}")


def odd_taps(x: float) -> int:
    """The odd tap count nearest ``x`` from above, at least 3."""
    v = max(3, int(round(x)))
    return v if v % 2 == 1 else v + 1


def lowpass_taps(fs: float, cutoff: float, ntaps: int) -> np.ndarray:
    """Hann-windowed sinc low-pass with unit DC gain."""
    _check_odd(ntaps)
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * cutoff / fs * np.sinc(2.0 * cutoff / fs * m)
    h *= np.hanning(ntaps)
    return h / np.sum(h)


def bandpass_taps(fs: float, f_lo: float, f_hi: float, ntaps: int) -> np.ndarray:
    """Difference of two Hann-windowed sincs, unit gain at the band centre."""
    _check_odd(ntaps)
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = (2.0 * f_hi / fs * np.sinc(2.0 * f_hi / fs * m)
         - 2.0 * f_lo / fs * np.sinc(2.0 * f_lo / fs * m))
    h *= np.hanning(ntaps)
    w = 2.0 * np.pi * 0.5 * (f_lo + f_hi) / fs
    return h / np.abs(np.sum(h * np.exp(-1j * w * np.arange(ntaps))))


def tukey(ntaps: int, alpha: float = 0.7) -> np.ndarray:
    x = np.abs(np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0)
    x /= (ntaps - 1) / 2.0
    w = np.ones(ntaps)
    edge = x > alpha
    w[edge] = 0.5 * (1.0 + np.cos(np.pi * (x[edge] - alpha) / (1.0 - alpha)))
    return w


def freq_sampled_taps(fs: float, response, ntaps: int) -> np.ndarray:
    """A Hermitian response sampled on the rfft grid (widened while it has
    fewer than 4 points per tap), inverse-transformed, centred, Tukey
    windowed and cut to ``ntaps``."""
    _check_odd(ntaps)
    nfft = DESIGN_NFFT
    while nfft < 4 * ntaps:
        nfft *= 2
    H = np.asarray(response(np.fft.rfftfreq(nfft, d=1.0 / fs)), dtype=np.complex128)
    h_full = np.fft.irfft(H, n=nfft)
    half = (ntaps - 1) // 2
    return np.concatenate([h_full[-half:], h_full[: half + 1]]) * tukey(ntaps)


def differentiator_taps(fs: float, ntaps: int, taper_start: float = 0.65) -> np.ndarray:
    """d/dn with a raised-cosine taper from ``taper_start`` x Nyquist."""

    def resp(f):
        f0 = taper_start * fs / 2.0
        ramp = np.clip((f - f0) / (fs / 2.0 - f0), 0.0, 1.0)
        taper = np.where(f > f0, 0.5 * (1.0 + np.cos(np.pi * ramp)), 1.0)
        return 1j * (2.0 * np.pi * f / fs) * taper

    return freq_sampled_taps(fs, resp, ntaps)


def raised_cosine_bandpass_response(f, f_lo, f_hi, transition):
    """0/1 band mask with raised-cosine edges of width ``transition``."""
    f = np.abs(np.asarray(f, dtype=np.float64))

    def edge(x):
        return 0.5 * (1.0 - np.cos(np.pi * np.clip(x, 0.0, 1.0)))

    return edge((f - (f_lo - transition)) / transition) * (1.0 - edge((f - f_hi) / transition))


def secam_preemph_response(f, f1: float):
    f = np.asarray(f, dtype=np.float64)
    return (1.0 + 1j * f / f1) / (1.0 + 1j * f / (3.0 * f1))


def secam_deemph_response(f, f1: float):
    f = np.asarray(f, dtype=np.float64)
    return (1.0 + 1j * f / (3.0 * f1)) / (1.0 + 1j * f / f1)


def _bell_F(f, f0: float):
    f = np.asarray(f, dtype=np.float64)
    fsafe = np.where(np.abs(f) < 1.0, 1.0, f)
    return np.where(np.abs(f) < 1.0, -1e9, fsafe / f0 - f0 / fsafe)


def secam_anticloche_response(f, f0, m0, k_num, k_den):
    F = _bell_F(f, f0)
    return m0 * (1.0 + 1j * k_num * F) / (1.0 + 1j * k_den * F)


def secam_cloche_response(f, f0, m0, k_num, k_den):
    F = _bell_F(f, f0)
    return (1.0 + 1j * k_den * F) / (1.0 + 1j * k_num * F)


def phase_ramp(f: float, fs: float, n: int, offset: float = 0.0) -> np.ndarray:
    """2 pi frac(f/fs * (k + offset)) for k = 0 .. n-1."""
    return 2.0 * np.pi * np.mod(f / fs * (np.arange(n, dtype=np.float64) + offset), 1.0)
