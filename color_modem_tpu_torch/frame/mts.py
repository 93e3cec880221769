"""MTS/BTSC-style stereo sound multiplex.

Port of ``color_modem_tpu/frame/mts.py``.  A stereo pair becomes one
baseband that rides the intercarrier FM sound channel (``frame/rf.py``):

    a(t) = (L+R)/2  +  P * sin(2*pi*fh*t)  +  (L-R)/2 * 2*cos(2*pi*2fh*t)

(simplified BTSC: no dbx companding, no SAP).  The pilot sits exactly at
the line frequency fh and the difference channel is DSB suppressed-carrier
at 2 fh.  fh is one cycle per row, so the phase is ``2*pi*(t mod N)/N`` in
integer arithmetic: no oscillator state, and the decoder demodulates the
difference coherently with no PLL.  The pilot is still sent, and its
correlated level is the stereo presence check.

Band plan at the composite rate: sum 0-13.5 kHz, pilot at fh (15.734 kHz
for 525/30) in the stopband of a 16385-tap low-pass (transition ~3 kHz at
13.5 MHz), difference sidebands 2 fh +- 13.5 kHz.  The baseband reaches
~45 kHz, so carry it with ``make_rf_plan(..., audio_bw=50e3)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_fft
from color_modem_tpu_torch.dsp.nco import f32

#: pilot amplitude (kept small so program audio dominates the FM budget)
PILOT_AMP = 0.1

#: sum/difference audio bandwidth, Hz — content must stay below this
AUDIO_BW = 13.5e3


@lru_cache(maxsize=8)
def _channel_lpf(fs: float) -> np.ndarray:
    """Steep audio-channel low-pass: passband to AUDIO_BW, the pilot (fh ~
    15.7 kHz) in the stopband; 16385 taps at ~13.5 MHz."""
    return design.lowpass_taps(fs, AUDIO_BW, 16385)


def _phase(plan, n_t: int, device, row_samples: int | None = None) -> torch.Tensor:
    """2*pi*fh*t on the composite sample grid, exact: fh is one cycle per
    row, so the phase is 2*pi*(t mod N)/N with integer arithmetic.  Pass
    ``row_samples`` (e.g. ``raster.n_total``) when rows are not
    ``plan.n_samples`` long."""
    n = plan.n_samples if row_samples is None else int(row_samples)
    t = torch.arange(n_t, dtype=torch.int32, device=device)
    return f32(2.0 * np.pi / n) * torch.remainder(t, n).to(torch.float32)


def mts_encode(plan, left, right, row_samples: int | None = None) -> torch.Tensor:
    """Stereo pair (B, T) at the composite rate -> MTS baseband (B, T).

    Send it as :func:`frame.rf.rf_modulate`'s ``audio`` with an
    ``audio_bw=50e3`` RF plan."""
    left = torch.as_tensor(left, dtype=torch.float32)
    right = torch.as_tensor(right, dtype=torch.float32, device=left.device)
    ph = _phase(plan, left.shape[-1], left.device, row_samples)[None, :]
    s = 0.5 * (left + right)
    d = 0.5 * (left - right)
    return s + PILOT_AMP * torch.sin(ph) + d * (2.0 * torch.cos(2.0 * ph))


def mts_decode(plan, a, row_samples: int | None = None):
    """MTS baseband (B, T) -> ``(left, right, pilot_level)``.

    Sum = the low-pass; difference = coherent DSB-SC demodulation against
    the exact 2 fh carrier; ``pilot_level`` (B,) is the correlated pilot
    amplitude (~PILOT_AMP when stereo is sent, ~0 on mono)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    ph = _phase(plan, a.shape[-1], a.device, row_samples)[None, :]
    taps = _channel_lpf(plan.fs)
    s = fir_same_fft(a, taps)
    d = fir_same_fft(a * torch.cos(2.0 * ph), taps)
    pilot = 2.0 * torch.mean(a * torch.sin(ph), dim=-1)
    return s + d, s - d, pilot
