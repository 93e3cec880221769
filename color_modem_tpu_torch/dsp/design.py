"""Config-time FIR design — NumPy float64, runs once per plan.

Port of ``color_modem_tpu/dsp/design.py``: the windowed-sinc low/band-pass
designs of the QAM family, and the frequency-sampled designs of SECAM
(pre-/de-emphasis, anti-cloche and cloche, the band mask, the
differentiator), and the band-limited Hilbert FIR of the channel model.  The SECAM responses have intrinsic phase, so their taps
are asymmetric (the differentiator's antisymmetric).  The Kaiser-windowed
sinc resampling matrix of ``dsp/resample.py`` is designed here too.  The
arithmetic is the same NumPy code, so the taps are bit-identical to the JAX
package's (tests/test_torch_plan.py, tests/test_torch_frame.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

DEFAULT_NTAPS = 129
DESIGN_NFFT = 8192


def _check_odd(ntaps: int) -> None:
    if ntaps % 2 != 1:
        raise ValueError(f"ntaps must be odd for 'same' centering, got {ntaps}")


def lowpass_taps(fs: float, cutoff: float, ntaps: int = DEFAULT_NTAPS) -> np.ndarray:
    """Windowed-sinc (Hann) linear-phase low-pass, unity DC gain."""
    _check_odd(ntaps)
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * cutoff / fs * np.sinc(2.0 * cutoff / fs * m)
    h *= np.hanning(ntaps)
    h /= np.sum(h)  # exact unity DC gain
    return h


def bandpass_taps(
    fs: float, f_lo: float, f_hi: float, ntaps: int = DEFAULT_NTAPS
) -> np.ndarray:
    """Linear-phase band-pass as the difference of two windowed-sinc LPFs."""
    _check_odd(ntaps)
    m = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    h = 2.0 * f_hi / fs * np.sinc(2.0 * f_hi / fs * m) - 2.0 * f_lo / fs * np.sinc(
        2.0 * f_lo / fs * m
    )
    h *= np.hanning(ntaps)
    # normalize gain to exactly 1 at band center
    fc = 0.5 * (f_lo + f_hi)
    w = 2.0 * np.pi * fc / fs
    gain = np.abs(np.sum(h * np.exp(-1j * w * np.arange(ntaps))))
    return h / gain


def tukey(ntaps: int, alpha: float = 0.7) -> np.ndarray:
    """Tukey window: flat over the central ``alpha`` fraction, cosine edges.

    The SECAM pre-emphasis shelf has an exponential tail about 40 samples
    long at 13.5 MHz; a Hann window would attenuate it enough to shift the
    DC gain by about 15%, the flat centre leaves it untouched.
    """
    x = np.abs(np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0)
    x /= (ntaps - 1) / 2.0
    w = np.ones(ntaps)
    edge = x > alpha
    w[edge] = 0.5 * (1.0 + np.cos(np.pi * (x[edge] - alpha) / (1.0 - alpha)))
    return w


def freq_sampled_taps(
    fs: float,
    response,
    ntaps: int = DEFAULT_NTAPS,
    nfft: int = DESIGN_NFFT,
) -> np.ndarray:
    """FIR approximation of an arbitrary Hermitian response ``H(f)``.

    ``response(f_hz) -> complex`` is sampled on the dense rfft grid,
    inverse-transformed, centred at ``(ntaps-1)//2`` (so the 'same'
    application is delay-free), Tukey-windowed and truncated.  Only
    Hermitian symmetry is assumed, not linear phase.  The grid widens while
    ``nfft < 4 * ntaps``: a long FIR exists to realise structure finer than
    the default grid's fs/8192, and a coarse grid would alias its tail.
    """
    _check_odd(ntaps)
    while nfft < 4 * ntaps:
        nfft *= 2
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    H = np.asarray(response(freqs), dtype=np.complex128)
    h_full = np.fft.irfft(H, n=nfft)
    # roll the negative-time half to the front, cut a centred window
    half = (ntaps - 1) // 2
    h = np.concatenate([h_full[-half:], h_full[: half + 1]])
    h *= tukey(ntaps)
    return h


def differentiator_taps(
    fs: float, ntaps: int = 31, taper_start: float = 0.65
) -> np.ndarray:
    """FIR d/dn: frequency-sampled ``H(w) = j*w`` with a raised-cosine taper
    from ``taper_start`` x Nyquist to Nyquist against HF noise gain.  The
    SECAM quadrature discriminator's derivative."""

    def resp(f):
        w = 2.0 * np.pi * f / fs
        taper = np.ones_like(f)
        f_nyq = fs / 2.0
        f0 = taper_start * f_nyq
        ramp = (f - f0) / (f_nyq - f0)
        taper = np.where(
            f > f0, 0.5 * (1.0 + np.cos(np.pi * np.clip(ramp, 0.0, 1.0))), taper
        )
        return 1j * w * taper

    return freq_sampled_taps(fs, resp, ntaps=ntaps)


def hilbert_taps(
    fs: float,
    f_lo: float,
    f_hi: float,
    ntaps: int = DEFAULT_NTAPS,
) -> np.ndarray:
    """FIR 90-degree phase shifter over [f_lo, f_hi] (band-limited Hilbert).

    ``cos(t)*x + sin(t)*H(x)`` rotates a band-pass signal's phase by ``t``
    (``frame/channel.py``).  Frequency-sampled ``-j*sign(f)``, masked to
    the band; the taps are antisymmetric, so a mirrored FIR would flip the
    rotation's sign.
    """

    def resp(f):
        mask = raised_cosine_bandpass_response(f, f_lo, f_hi, 0.2e6)
        return -1j * mask  # f >= 0 half; Hermitian extension handles f < 0

    return freq_sampled_taps(fs, resp, ntaps)


def freqz(taps: np.ndarray, fs: float, freqs: np.ndarray) -> np.ndarray:
    """Complex response of ``taps`` at ``freqs`` Hz, **after** 'same' centering.

    The (ntaps-1)/2 group delay of the centered application is divided out, so
    a symmetric (linear-phase) filter reads as purely real here.
    """
    n = np.arange(len(taps), dtype=np.float64) - (len(taps) - 1) / 2.0
    w = 2.0 * np.pi * np.asarray(freqs, dtype=np.float64) / fs
    return (taps[None, :] * np.exp(-1j * np.outer(w, n))).sum(axis=1)


# --- SECAM transfer functions ------------------------------------------------


def secam_preemph_response(f, f1: float):
    """LF video pre-emphasis A(f) = (1 + jf/f1) / (1 + jf/(3 f1))."""
    f = np.asarray(f, dtype=np.float64)
    return (1.0 + 1j * f / f1) / (1.0 + 1j * f / (3.0 * f1))


def secam_deemph_response(f, f1: float):
    """Decoder de-emphasis: exact inverse of :func:`secam_preemph_response`."""
    f = np.asarray(f, dtype=np.float64)
    return (1.0 + 1j * f / (3.0 * f1)) / (1.0 + 1j * f / f1)


def _bell_F(f, f0: float):
    f = np.asarray(f, dtype=np.float64)
    fsafe = np.where(np.abs(f) < 1.0, 1.0, f)  # F(0) limit handled below
    F = fsafe / f0 - f0 / fsafe
    return np.where(np.abs(f) < 1.0, -1e9, F)  # f->0+ => F -> -inf


def secam_anticloche_response(f, f0: float, m0: float, k_num: float, k_den: float):
    """HF amplitude pre-emphasis G(f) = M0 (1 + j k_num F)/(1 + j k_den F)."""
    F = _bell_F(f, f0)
    return m0 * (1.0 + 1j * k_num * F) / (1.0 + 1j * k_den * F)


def secam_cloche_response(f, f0: float, m0: float, k_num: float, k_den: float):
    """Decoder bell ("cloche"): the anti-cloche's inverse shape, unity gain
    at f0: H = (1 + j k_den F)/(1 + j k_num F)."""
    F = _bell_F(f, f0)
    return (1.0 + 1j * k_den * F) / (1.0 + 1j * k_num * F)


def raised_cosine_bandpass_response(f, f_lo, f_hi, transition):
    """Smooth 0/1 band-pass mask with raised-cosine edges (real, zero-phase)."""
    f = np.abs(np.asarray(f, dtype=np.float64))

    def edge(x):  # 0 below 0, 1 above 1, smooth in between
        x = np.clip(x, 0.0, 1.0)
        return 0.5 * (1.0 - np.cos(np.pi * x))

    lo = edge((f - (f_lo - transition)) / transition)
    hi = 1.0 - edge((f - f_hi) / transition)
    return lo * hi


# --- resampling ----------------------------------------------------------------


@lru_cache(maxsize=32)
def resample_matrix(n_in: int, n_out: int, taps_per_output: int = 17) -> np.ndarray:
    """(n_in, n_out) float32 M with ``row @ M`` = windowed-sinc resample.

    Sample i covers [i, i+1)/n of the active line (pixel centres at
    (i + 0.5)/n).  Kaiser-windowed sinc (beta 8), cutoff at min(n_in, n_out)
    so decimation is anti-aliased; each column is renormalised to unity DC
    gain, so flat fields stay exactly flat.
    """
    ratio = n_in / n_out                      # input samples per output sample
    cutoff = min(1.0, 1.0 / ratio)            # in units of the input Nyquist
    half = taps_per_output / 2.0 * max(1.0, ratio)
    mat = np.zeros((n_in, n_out), dtype=np.float64)
    j = np.arange(n_in)
    for o in range(n_out):
        center = (o + 0.5) * ratio - 0.5      # input-sample position
        x = j - center
        keep = np.abs(x) <= half
        xk = x[keep]
        w = np.i0(8.0 * np.sqrt(np.maximum(0.0, 1.0 - (xk / half) ** 2)))
        w /= np.i0(8.0)
        kern = cutoff * np.sinc(cutoff * xk) * w
        s = kern.sum()
        mat[keep, o] = kern / (s if abs(s) > 1e-12 else 1.0)
    mat = mat.astype(np.float32)
    mat.flags.writeable = False  # the cache hands the same array to every caller
    return mat
