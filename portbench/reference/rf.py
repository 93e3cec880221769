"""Plain reference of the VSB picture hop: composite -> negative-AM VSB RF
at ``r`` times the composite rate -> Nyquist-flank receiver with
synchronous detection -> composite.

The system's hop (BT.470 levels: blanking at 75% of peak carrier, peak
white at 12.5%) composes each direction's filter-mix-filter cascade into
one complex FIR by the modulation identity ``h * (y cos wn) = Re{e^{jwn}
((h e^{-jw.}) * y)}``, and applies it to each frame's rows joined into one
stream, with zero edges.  This module designs the same filters again from
the plan's sample rate, composes them in float64, and filters each frame's
stream with one transform of the whole stream.  The picture carrier sits
on a half-integer number of cycles per row, so a row starts at phase 0 or
pi: ``(-1)^row`` on the absolute row ``frame * lines + line``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import design
from portbench.reference.common import TWO_PI, Precision, fft_fir

ENV_BLANK, ENV_WHITE = 0.75, 0.125
#: band-edge transition of the VSB filters, Hz
TRANSITION = 0.3e6


def _nyquist_flank(f, fc, f_vestige, f_video):
    """Receiver response: a raised-cosine flank through 0.5 at the carrier
    over +-f_vestige, flat over the upper sideband, rolled off after
    ``fc + f_video``."""
    f = np.asarray(f, dtype=np.float64)
    lo, hi = fc - f_vestige, fc + f_vestige
    flank = np.where(f <= lo, 0.0, np.where(
        f >= hi, 1.0, 0.5 * (1 - np.cos(np.pi * (f - lo) / (hi - lo)))))
    top = fc + f_video
    roll = np.where(f <= top, 1.0, np.where(
        f >= top + TRANSITION, 0.0, 0.5 * (1 + np.cos(np.pi * (f - top) / TRANSITION))))
    return flank * roll


def _modulated(taps: np.ndarray, w: float) -> np.ndarray:
    """``taps[k] e^{jw(k - (t-1)/2)}``: the taps that move a mix at ``-w``
    through the filter."""
    k = np.arange(len(taps), dtype=np.float64) - (len(taps) - 1) / 2
    return taps * np.exp(1j * w * k)


def make(plan, hop: dict) -> SimpleNamespace:
    """The hop's filters for a round-trip plan (its ``fs``, ``n`` and
    ``total_lines``) and the traffic's ``hop`` parameters: ``r`` and
    ``ntaps``.  The video band is 0.46 fs (0.49 fs for FM chroma), the
    carrier 2 MHz above it snapped to a half-integer number of cycles per
    row, the vestige 0.75 MHz on 525 lines and 1.25 MHz otherwise."""
    r, ntaps = int(hop["r"]), int(hop["ntaps"])
    fs, n = plan.fs, plan.n
    fs_rf = r * fs
    f_video = (0.49 if plan.fm else 0.46) * fs
    f_vestige = 0.75e6 if plan.total_lines == 525 else 1.25e6
    fc = (2 * int(round((f_video + 2.0e6) * n / fs - 0.5)) + 1) / 2 * fs / n
    tx = design.freq_sampled_taps(fs_rf, lambda f: design.raised_cosine_bandpass_response(
        f, fc - f_vestige, fc + f_video, TRANSITION), ntaps)
    rx = design.freq_sampled_taps(fs_rf, lambda f: _nyquist_flank(f, fc, f_vestige, f_video),
                                  ntaps)
    det = design.lowpass_taps(fs_rf, f_video + TRANSITION, ntaps)
    w = TWO_PI * fc / fs_rf
    return SimpleNamespace(
        r=r, n=n,
        # anti-image low-pass (stuffing gain r), mix, VSB shaping
        mod=r * np.convolve(_modulated(tx, -w), det),
        # Nyquist flank, mix, post-detection low-pass
        dem=np.convolve(_modulated(det, -w), rx),
        ramp=design.phase_ramp(fc, fs_rf, n * r),
        ramp_comp=design.phase_ramp(fc, fs, n),
    )


def _row_sign(frames, n_lines: int, device, dtype) -> torch.Tensor:
    f = torch.as_tensor(np.asarray(frames, np.int64), device=device)
    rows = f[:, None] * n_lines + torch.arange(n_lines, device=device)[None, :]
    return (1 - 2 * torch.remainder(rows, 2)).to(dtype)[..., None]


def roundtrip(rp, comp: torch.Tensor, frames, prec: Precision) -> torch.Tensor:
    """(B, L, N) composite of frames ``frames`` through the hop and back."""
    b, n_lines, n = comp.shape
    dev, dt, r = comp.device, prec.dtype, rp.r
    sign = _row_sign(frames, n_lines, dev, dt)
    env = ENV_BLANK - (ENV_BLANK - ENV_WHITE) * comp.to(dt)
    stuffed = torch.zeros(b, n_lines * n * r, dtype=dt, device=dev)
    stuffed[:, ::r] = env.reshape(b, -1)
    v = fft_fir(stuffed, rp.mod, prec).reshape(b, n_lines, n * r)
    ramp = torch.from_numpy(rp.ramp).to(dev, dt)
    rf = (v.real * torch.cos(ramp) - v.imag * torch.sin(ramp)) * sign
    z = fft_fir(rf.reshape(b, -1), rp.dem, prec)[:, ::r].reshape(b, n_lines, n)
    ramp_c = torch.from_numpy(rp.ramp_comp).to(dev, dt)
    env_rx = 4.0 * (z.real * torch.cos(ramp_c) - z.imag * torch.sin(ramp_c)) * sign
    return (ENV_BLANK - env_rx) / (ENV_BLANK - ENV_WHITE)
