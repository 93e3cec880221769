"""Transmission-channel impairments between encode and decode.

Port of ``color_modem_tpu/frame/channel.py``:

* additive white noise, drawn from a JAX key (``utils/prng.py``): the
  JAX package's noise on every device;
* static chroma gain and phase errors (the errors NIIR's reference line
  and SECAM's FM are immune to, and that PAL's delay line averages away);
* differential gain and phase: the chroma error scales with the local luma
  level, as transmitter amplifiers compress near white;
* a multipath ghost, a delayed, attenuated copy riding the continuous line
  stream;
* ``vhs_playback``, the colour-under tape signature.

Phase rotation of the chroma band uses a band-limited Hilbert FIR,
``rot(x, t) = cos(t) x + sin(t) H(x)``; luma passes untouched.  The
filters have fixed tap counts (129, 193, 63), not the plan's, and run as
the plain Toeplitz FIR; each matrix is built and uploaded once per
(taps, width, device).
"""

from __future__ import annotations

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_taps as _fir
from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.modem.plan import SECAM_TAKEOFF_HALFWIDTH, FmPlan, QamPlan
from color_modem_tpu_torch.utils import prng

#: tap counts of the channel's filters (the JAX package's)
BAND_NTAPS, VHS_CHROMA_NTAPS, LUMA_EST_NTAPS = 129, 193, 63
#: the luma estimate of the differential errors is smoothed to this cutoff
LUMA_EST_CUTOFF = 0.5e6


def _chroma_band_edges(plan: QamPlan | FmPlan) -> tuple[float, float]:
    ch = plan.cfg.chroma
    if not plan.cfg.is_fm:
        return ch.fsc - ch.chroma_band, ch.fsc + ch.chroma_band
    return (ch.bell_f0 - SECAM_TAKEOFF_HALFWIDTH,
            ch.bell_f0 + SECAM_TAKEOFF_HALFWIDTH)


def _stream_delay(x: torch.Tensor, d: int) -> torch.Tensor:
    """Delay a (..., L, N) block ``d`` samples along the concatenated line
    stream: content crosses line boundaries like a real raster; only the
    block's first ``d`` samples lack a predecessor (zero-filled)."""
    lead, (l, n) = x.shape[:-2], x.shape[-2:]
    stream = x.reshape(*lead, l * n)
    return torch.cat(
        [x.new_zeros(*lead, d), stream[..., :-d]], dim=-1
    ).reshape(*lead, l, n)


def vhs_playback(
    plan: QamPlan | FmPlan,
    comp: torch.Tensor,
    *,
    luma_bw: float = 3.0e6,
    chroma_bw: float = 0.4e6,
    chroma_delay_us: float = 0.4,
) -> torch.Tensor:
    """VHS colour-under playback on a (..., L, N) composite: luma low-passed
    to ``luma_bw``, chroma re-band-limited to ``fc +- chroma_bw`` and its
    envelope delayed by ``chroma_delay_us`` (on QAM the playback
    up-converter re-locks the carrier phase, so the raw delay's carrier
    rotation is undone)."""
    comp = comp.to(torch.float32)
    fs = plan.fs
    f_lo, f_hi = _chroma_band_edges(plan)
    cb = _fir(comp, design.bandpass_taps(fs, f_lo, f_hi, BAND_NTAPS))
    luma = _fir(comp - cb, design.lowpass_taps(fs, luma_bw, BAND_NTAPS))
    ch = plan.cfg.chroma
    fc = ch.bell_f0 if plan.cfg.is_fm else ch.fsc
    cb = _fir(cb, design.bandpass_taps(fs, fc - chroma_bw, fc + chroma_bw,
                                       VHS_CHROMA_NTAPS))
    d = int(round(chroma_delay_us * 1e-6 * fs))
    if d:
        cb = _stream_delay(cb, d)
        if not plan.cfg.is_fm:
            theta = 2.0 * np.pi * fc * d / fs
            hil = design.hilbert_taps(fs, fc - chroma_bw, fc + chroma_bw, BAND_NTAPS)
            cb = f32(np.cos(theta)) * cb - f32(np.sin(theta)) * _fir(cb, hil)
    return luma + cb


def impair(
    plan: QamPlan | FmPlan,
    comp: torch.Tensor,
    *,
    noise_sigma: float = 0.0,
    chroma_gain: float = 1.0,
    chroma_phase_deg: float = 0.0,
    diff_gain: float = 0.0,
    diff_phase_deg: float = 0.0,
    ghost_delay_us: float = 0.0,
    ghost_gain: float = 0.0,
    key: prng.Key | None = None,
) -> torch.Tensor:
    """Apply channel impairments to a ``(..., L, N)`` composite block.

    In the physical order: multipath ghost, then the chroma-path gain and
    phase errors, static and luma-tracking (``diff_*`` is the full error at
    100% luma), then additive noise, ``normal(key, comp.shape)``.
    """
    comp = comp.to(torch.float32)
    fs = plan.fs
    if ghost_gain != 0.0:
        if ghost_delay_us <= 0.0:
            raise ValueError("ghost_gain needs ghost_delay_us > 0")
        d = max(1, int(round(ghost_delay_us * 1e-6 * fs)))
        l, n = comp.shape[-2:]
        if d >= l * n:
            raise ValueError(
                f"ghost delay {ghost_delay_us} us = {d} samples exceeds the "
                f"block's {l * n}-sample line stream"
            )
        comp = comp + f32(ghost_gain) * _stream_delay(comp, d)
    if (chroma_gain != 1.0 or chroma_phase_deg != 0.0
            or diff_gain != 0.0 or diff_phase_deg != 0.0):
        f_lo, f_hi = _chroma_band_edges(plan)
        cb = _fir(comp, design.bandpass_taps(fs, f_lo, f_hi, BAND_NTAPS))
        rest = comp - cb  # about the luma path (plus sync/burst if rastered)
        if diff_gain != 0.0 or diff_phase_deg != 0.0:
            # the local luma: the chroma-free remainder, smoothed so carrier
            # leakage does not modulate the error at fsc
            luma = _fir(rest, design.lowpass_taps(fs, LUMA_EST_CUTOFF, LUMA_EST_NTAPS))
            luma = torch.clamp(luma, 0.0, 1.0)
        else:
            luma = torch.zeros((), dtype=torch.float32, device=comp.device)
        t = f32(np.deg2rad(chroma_phase_deg)) + f32(np.deg2rad(diff_phase_deg)) * luma
        g = f32(chroma_gain) * (1.0 + f32(diff_gain) * luma)
        if chroma_phase_deg != 0.0 or diff_phase_deg != 0.0:
            hil = design.hilbert_taps(fs, f_lo, f_hi, BAND_NTAPS)
            cb = torch.cos(t) * cb + torch.sin(t) * _fir(cb, hil)
        comp = rest + g * cb
    if noise_sigma > 0.0:
        if key is None:
            raise ValueError("noise_sigma > 0 requires a PRNG key")
        comp = prng.add_normal(comp, noise_sigma, key)
    return comp
