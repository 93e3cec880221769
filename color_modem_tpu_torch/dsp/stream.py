"""Overlap-save FFT convolution for long contiguous streams.

Port of ``color_modem_tpu/dsp/stream.py`` on ``torch.fft`` with native
``complex64`` tensors.  The RF and satellite hops (``frame/rf.py``,
``frame/satellite.py``) filter streams of a million samples and more (the
rows of a frame joined into one broadcast-time signal) with FIRs of 500 to
8193 taps.  Each function cuts the stream into overlapping power-of-two
blocks, multiplies each block's spectrum by the filter's, and keeps the
part of each block that the circular wrap does not touch:

* :func:`fir_stream`: real 'same' convolution;
* :func:`upconv_stream`: zero-stuff by ``r`` and a complex 'same' filter
  in one pass (the forward transform runs at the low rate: a zero-stuffed
  block's spectrum is the periodic replication of the dense block's);
* :func:`conv_complex_stream`: real stream, complex taps, full rate;
* :func:`upsample_fir_stream`: zero-stuff by ``r`` and a real filter;
* :func:`fir_decim_stream` / :func:`conv_decim_stream`: real or complex
  filter, then keep every ``r``-th sample; the spectrum is alias-folded
  before a low-rate inverse transform.

Same-centering contract: with odd tap count ``t``, ``out[n] = sum_k
taps[k] * x[n + (t-1)//2 - k]``, i.e. ``np.convolve(mode='same')``.
Taps are host NumPy arrays; their zero-padded spectra are computed in
float64/complex128 and uploaded once per (taps, block size, device)
(``dsp/apply.py::kernel_spectrum``).  The block size rule and the order
of the fold's segments are the JAX package's, so the port computes what
the reference computes; the blocks are ``Tensor.unfold`` views of the
padded stream.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from color_modem_tpu_torch.dsp.apply import fir_same_fft, kernel_spectrum
from color_modem_tpu_torch.utils.tracing import span

#: the block size floor of the JAX package (chosen there for the TPU)
_NBLK_FLOOR = 32768


def pick_nblk(t: int) -> int:
    """Smallest power of two >= 8*(t-1), floored at 32768: keeps the
    overlap-save overhead <= 14%."""
    nblk = _NBLK_FLOOR
    while nblk < 8 * (t - 1):
        nblk *= 2
    return nblk


def _check_rate(r: int, nblk: int) -> None:
    """The rate-changing functions partition the power-of-two block into
    ``r`` dense sub-blocks, so ``r`` must divide it: a power of two."""
    if r < 1 or nblk % r:
        raise ValueError(
            f"rate factor r={r} must be a power of two (it has to divide "
            f"the power-of-two FFT block size {nblk})"
        )


def _carrier_taps(taps: np.ndarray, w: float) -> np.ndarray:
    """``taps[k] * e^{jw(k - lo)}`` at the 'same' origin ``lo = (t-1)/2``:
    the complex-modulated FIR of the identity ``h * (y e^{jwn}) =
    e^{jwn} ((h e^{-jw.}) * y)``, with which the RF and satellite hops
    compose a filter-mix-filter cascade into one filter (host float64)."""
    t = len(taps)
    k = np.arange(t, dtype=np.float64) - (t - 1) / 2
    return np.asarray(taps, np.float64) * np.exp(1j * w * k)


def _check_taps(taps) -> np.ndarray:
    taps = np.asarray(taps)
    if taps.ndim != 1 or taps.shape[0] % 2 == 0:
        raise ValueError(f"stream filters need odd 1-D taps, got shape {taps.shape}")
    return taps


def pad_taps_center(taps, multiple: int) -> np.ndarray:
    """Zero-pad odd-length taps symmetrically until ``(len-1) % multiple ==
    0``: the 'same' centre stays exact and the overlap-save geometry lines
    up with a resampling factor."""
    taps = _check_taps(taps)
    t = taps.shape[0]
    extra = (-(t - 1)) % multiple
    if extra:
        half = extra // 2
        if extra % 2:  # keep the length odd: grow by a further `multiple`
            extra = extra + multiple
            half = extra // 2
        taps = np.pad(taps, (half, half))
    return taps


def _blocks(x: torch.Tensor, lo: int, step: int, nb: int, nblk: int) -> torch.Tensor:
    """(B, T) -> (B, nb, nblk) overlapping blocks of ``[lo zeros ++ x ++
    zeros]``: block j is ``padded[j*step : j*step + nblk]`` (a view)."""
    t_in = x.shape[-1]
    total = (nb - 1) * step + nblk
    return F.pad(x, (lo, total - lo - t_in)).unfold(-1, nblk, step)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def fir_stream(x: torch.Tensor, taps) -> torch.Tensor:
    """Real 'same' convolution of (..., T) along the last axis by
    overlap-save; a short stream takes one padded transform instead
    (:func:`~color_modem_tpu_torch.dsp.apply.fir_same_fft`)."""
    taps = _check_taps(taps)
    t = taps.shape[0]
    x2 = _rows(x)
    t_in = x2.shape[-1]
    nblk = pick_nblk(t)
    if 2 ** int(np.ceil(np.log2(t_in + t - 1))) <= 2 * nblk:
        return fir_same_fft(x, taps)
    step = nblk - (t - 1)
    nb = -(-t_in // step)
    spec = kernel_spectrum(taps, nblk, True, x.device)
    blocks = _blocks(x2, (t - 1) // 2, step, nb, nblk)
    y = torch.fft.irfft(torch.fft.rfft(blocks, dim=-1) * spec, n=nblk, dim=-1)
    y = y[..., t - 1:].reshape(x2.shape[0], nb * step)[:, :t_in]
    return y.to(x.dtype).reshape(x.shape)


def _hermitian_base(spec_c: torch.Tensor, nsrc: int) -> torch.Tensor:
    """rfft half spectrum (.., nsrc//2+1) -> the full length-``nsrc``
    spectrum (even ``nsrc`` only)."""
    if nsrc % 2:
        raise ValueError(f"hermitian base: nsrc={nsrc} must be even")
    tail = torch.flip(spec_c[..., 1 : nsrc // 2], [-1]).conj()
    return torch.cat([spec_c, tail.resolve_conj()], dim=-1)


def _expand_full(spec: torch.Tensor, nsrc: int, nfull: int) -> torch.Tensor:
    """rfft spectrum of a real length-``nsrc`` block -> the full
    length-``nfull`` spectrum of the same block zero-stuffed: the periodic
    replication ``X_full[k] = X[k mod nsrc]`` of its hermitian expansion."""
    if nsrc % 2:
        raise ValueError(f"expand: nsrc={nsrc} must be even")
    if nfull % nsrc:
        raise ValueError(f"expand: {nsrc} must divide {nfull}")
    base = _hermitian_base(spec, nsrc)
    reps = nfull // nsrc
    return base if reps == 1 else torch.cat([base] * reps, dim=-1)


def _fold_product_half(X: torch.Tensor, K: torch.Tensor, nblk: int, r: int,
                       out_bins: int | None = None) -> torch.Tensor:
    """Alias-folded kernel product from the rfft half spectrum ``X``:
    ``W[k] = (1/r) sum_i Z[k + i nblk/r] K[k + i nblk/r]`` with ``Z`` the
    full hermitian spectrum (``X[j]`` for ``j <= nblk/2``, ``conj(X[nblk -
    j])`` above), summed in the order i = 0..r-1 from slices of ``X``
    without building ``Z``.  ``out_bins`` keeps the first bins only (the
    real-taps decimation feeds a half-spectrum irfft)."""
    nblk_c = nblk // r
    half = nblk // 2
    m = nblk_c if out_bins is None else out_bins
    if r == 1:
        return _hermitian_base(X, nblk)[..., :m] * K[:m]
    W = None
    for i in range(r):
        j0 = i * nblk_c
        Ki = K[j0 : j0 + m]
        if j0 + m - 1 <= half:
            Zi = X[..., j0 : j0 + m]
        elif j0 == half:
            # the segment starts on the Nyquist bin: that bin is X[half]
            # itself, the rest the usual conj-flip
            flip = torch.flip(X[..., half - m + 1 : half], [-1]).conj()
            Zi = torch.cat([X[..., half : half + 1], flip.resolve_conj()], dim=-1)
        elif j0 > half:
            hi = nblk - j0          # bin j0 maps to conj(X[hi])
            Zi = torch.flip(X[..., hi - m + 1 : hi + 1], [-1]).conj()
        else:  # unreachable for power-of-two r > 1 (m <= nblk_c <= half)
            raise ValueError(f"fold segment {i} straddles the Nyquist bin")
        W = Zi * Ki if W is None else W + Zi * Ki
    return W * (1.0 / r)


def _check_rate_taps(name: str, t: int, r: int) -> None:
    if (t - 1) % (2 * r):
        raise ValueError(
            f"{name} taps: 2r = {2*r} must divide (len-1), got len {t} — "
            "use pad_taps_center"
        )


def upconv_stream(x: torch.Tensor, taps_c, r: int) -> torch.Tensor:
    """Zero-stuff real (..., Tc) by ``r`` and 'same'-filter with complex
    ``taps_c`` (odd length, ``(len-1) % (2r) == 0``) in one pass; returns
    complex64 (..., Tc*r).  The stuffing gain ``r`` belongs in the taps."""
    taps_c = _check_taps(taps_c)
    t = taps_c.shape[0]
    _check_rate_taps("upconv", t, r)
    x2 = _rows(x)
    tc_in = x2.shape[-1]
    nblk = pick_nblk(t)
    _check_rate(r, nblk)
    nblk_c = nblk // r
    step = nblk - (t - 1)
    step_c = step // r
    nb = -(-tc_in // step_c)
    # low-rate blocks; (t-1)//(2r) leading zeros are the same-centering
    # lead at the stuffed rate
    blocks_c = _blocks(x2, (t - 1) // (2 * r), step_c, nb, nblk_c)
    base = _hermitian_base(torch.fft.rfft(blocks_c, dim=-1), nblk_c)
    K = kernel_spectrum(taps_c, nblk, False, x.device)
    # the stuffed block's spectrum is `base` repeated r times: segment i
    # multiplies K[i*nblk_c : (i+1)*nblk_c]
    W = (base.unsqueeze(-2) * K.view(r, nblk_c)).reshape(*base.shape[:-1], nblk)
    w = torch.fft.ifft(W, dim=-1)
    w = w[..., t - 1:].reshape(x2.shape[0], nb * step)[:, : tc_in * r]
    return w.reshape(*x.shape[:-1], tc_in * r)


def conv_complex_stream(x: torch.Tensor, taps_c) -> torch.Tensor:
    """'Same'-filter real (..., T) with complex ``taps_c`` at full rate;
    returns complex64 (..., T)."""
    taps_c = _check_taps(taps_c)
    t = taps_c.shape[0]
    x2 = _rows(x)
    t_in = x2.shape[-1]
    nblk = pick_nblk(t)
    step = nblk - (t - 1)
    nb = -(-t_in // step)
    blocks = _blocks(x2, (t - 1) // 2, step, nb, nblk)
    Z = _expand_full(torch.fft.rfft(blocks, dim=-1), nblk, nblk)
    w = torch.fft.ifft(Z * kernel_spectrum(taps_c, nblk, False, x.device), dim=-1)
    w = w[..., t - 1:].reshape(x2.shape[0], nb * step)[:, :t_in]
    return w.reshape(x.shape)


def upsample_fir_stream(x: torch.Tensor, taps, r: int) -> torch.Tensor:
    """Zero-stuff real (..., Tc) by ``r`` and 'same'-filter with REAL taps
    in one pass (rfft at the low rate, irfft at the high rate); returns
    real (..., Tc*r).  The stuffing gain ``r`` belongs in the taps."""
    taps = _check_taps(np.asarray(taps, np.float64))
    t = taps.shape[0]
    _check_rate_taps("upsample", t, r)
    x2 = _rows(x)
    tc_in = x2.shape[-1]
    nblk = pick_nblk(t)
    _check_rate(r, nblk)
    nblk_c = nblk // r
    step = nblk - (t - 1)
    step_c = step // r
    nb = -(-tc_in // step_c)
    spec_c = torch.fft.rfft(_blocks(x2, (t - 1) // (2 * r), step_c, nb, nblk_c), dim=-1)
    K = kernel_spectrum(taps, nblk, True, x.device)
    if r == 1:
        W = spec_c * K
    else:
        # the first nblk//2 + 1 bins of the stuffed block's rfft: r/2
        # replicas of the hermitian base, then the Nyquist bin alone
        base = _hermitian_base(spec_c, nblk_c)
        half = nblk // 2
        segs = (base.unsqueeze(-2) * K[:half].view(r // 2, nblk_c)).reshape(
            *base.shape[:-1], half)
        W = torch.cat([segs, base[..., :1] * K[half : half + 1]], dim=-1)
    y = torch.fft.irfft(W, n=nblk, dim=-1)
    y = y[..., t - 1:].reshape(x2.shape[0], nb * step)[:, : tc_in * r]
    return y.to(x.dtype).reshape(*x.shape[:-1], tc_in * r)


def _decim_geometry(name: str, x: torch.Tensor, t: int, r: int):
    _check_rate_taps(name, t, r)
    t_in = x.shape[-1]
    if t_in % r:
        raise ValueError(f"stream length {t_in} not divisible by r={r}")
    nblk = pick_nblk(t)
    _check_rate(r, nblk)
    step = nblk - (t - 1)
    nb = -(-(t_in // r) // (step // r))
    return t_in, nblk, step, nb


def fir_decim_stream(x: torch.Tensor, taps, r: int) -> torch.Tensor:
    """REAL 'same' filter + keep every ``r``-th sample, in one pass (the
    half spectrum is alias-folded before a low-rate irfft); returns real
    (..., T//r)."""
    taps = _check_taps(np.asarray(taps, np.float64))
    t = taps.shape[0]
    x2 = _rows(x)
    t_in, nblk, step, nb = _decim_geometry("fir_decim", x2, t, r)
    nblk_c, step_c = nblk // r, step // r
    X = torch.fft.rfft(_blocks(x2, (t - 1) // 2, step, nb, nblk), dim=-1)
    K = kernel_spectrum(taps, nblk, False, x.device)
    W = _fold_product_half(X, K, nblk, r, out_bins=nblk_c // 2 + 1)
    w = torch.fft.irfft(W, n=nblk_c, dim=-1)
    w = w[..., (t - 1) // r:].reshape(x2.shape[0], nb * step_c)[:, : t_in // r]
    return w.to(x.dtype).reshape(*x.shape[:-1], t_in // r)


def conv_decim_stream(x: torch.Tensor, taps_c, r: int) -> torch.Tensor:
    """'Same'-filter real (..., T) with complex ``taps_c`` and keep every
    ``r``-th sample, in one pass; returns complex64 (..., T//r).  Needs
    ``(len(taps)-1) % (2r) == 0`` and ``T % r == 0``."""
    taps_c = _check_taps(taps_c)
    t = taps_c.shape[0]
    x2 = _rows(x)
    t_in, nblk, step, nb = _decim_geometry("conv_decim", x2, t, r)
    step_c = step // r
    X = torch.fft.rfft(_blocks(x2, (t - 1) // 2, step, nb, nblk), dim=-1)
    W = _fold_product_half(X, kernel_spectrum(taps_c, nblk, False, x.device), nblk, r)
    w = torch.fft.ifft(W, dim=-1)
    w = w[..., (t - 1) // r:].reshape(x2.shape[0], nb * step_c)[:, : t_in // r]
    return w.reshape(*x.shape[:-1], t_in // r)


def plan_memo(plan, key, build):
    """``build()`` once per (plan, key): the composed taps of a hop's plan
    are host float64 work (tap convolutions, padding) that a call must not
    repeat.  The plans are frozen dataclasses; the memo lives in the
    instance's ``__dict__`` beside the fields."""
    memo = plan.__dict__.setdefault("_memo", {})
    if key not in memo:
        with span("cm.build.memo"):
            memo[key] = build()
    return memo[key]
