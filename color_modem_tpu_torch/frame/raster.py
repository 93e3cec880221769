"""Horizontal raster structure: sync pulses and colour burst.

Port of ``color_modem_tpu/frame/raster.py``.  A rastered line is
``[blanking | active]``; the blanking interval holds the front porch, the
sync pulse and (QAM standards) the colour burst, at the BT.1700 timings
mapped to the sample grid (858 samples per NTSC line, 864 per 625-line one,
at 720 active samples).  The burst rides the active chroma's closed-form
phase law, so a burst-locked decoder sees a phase-consistent reference:

    NTSC:  9 cycles at 180 deg on the U axis
    PAL:  10 cycles swinging +-135 deg with the V-switch
    SECAM: sync only (lines are identified by FM, not by a burst)

``measure_burst_phase`` correlates the burst window against the phase law;
``decode_burst_locked`` counter-rotates (and with ``acc`` rescales) the
demodulated chroma by what it measures; ``identify_vswitch`` recovers the
PAL V-switch parity from the swinging burst.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp.nco import TWO_PI, f32, line_phase0
from color_modem_tpu_torch.modem.plan import FmPlan, QamPlan
from color_modem_tpu_torch.modem.qam import v_sign

#: analog blanking timings in seconds: (front porch, sync width, burst start
#: after the leading sync edge, burst cycles); BT.1700 values
_TIMING_525 = (1.5e-6, 4.7e-6, 5.3e-6, 9)
_TIMING_625 = (1.65e-6, 4.7e-6, 5.6e-6, 10)

SYNC_LEVEL = -0.4   # sync tip; blanking = 0, white = 1
BURST_AMP = 0.15    # burst envelope amplitude around blanking level


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    """Sample-grid raster geometry of one (standard, line width) pair."""

    n_active: int
    n_total: int
    sync_start: int      # line-start-relative sample indices
    sync_len: int
    burst_start: int
    burst_len: int       # 0 = no burst (SECAM)
    burst_phase: float   # burst angle on the (un-rotated) U axis, rad
    swinging: bool       # PAL: the burst angle's sign follows the V-switch

    @property
    def n_blank(self) -> int:
        return self.n_total - self.n_active


def make_raster(plan: QamPlan | FmPlan) -> RasterPlan:
    cfg = plan.cfg
    fs = plan.fs
    n_total = int(round(fs / cfg.fh))
    front, sync_w, burst_t0, burst_cycles = (
        _TIMING_525 if cfg.total_lines == 525 else _TIMING_625
    )
    sync_start = int(round(front * fs))
    sync_len = int(round(sync_w * fs))
    if not cfg.is_fm:
        fsc = cfg.chroma.fsc
        burst_start = sync_start + int(round(burst_t0 * fs))
        burst_len = int(round(burst_cycles / fsc * fs))
        swinging = cfg.chroma.v_switch
        burst_phase = 0.75 * np.pi if swinging else np.pi  # PAL 135 / NTSC 180
    else:
        burst_start, burst_len, burst_phase, swinging = 0, 0, 0.0, False
    n_blank = n_total - plan.n_samples
    if burst_start + burst_len > n_blank:
        raise ValueError(
            f"{cfg.name}: burst does not fit the {n_blank}-sample blanking "
            f"interval at fs={fs/1e6:.2f} MHz"
        )
    return RasterPlan(
        n_active=plan.n_samples,
        n_total=n_total,
        sync_start=sync_start,
        sync_len=sync_len,
        burst_start=burst_start,
        burst_len=burst_len,
        burst_phase=float(burst_phase),
        swinging=swinging,
    )


def _burst_sign(plan: QamPlan, rp: RasterPlan, gline: torch.Tensor) -> torch.Tensor:
    """Per-line burst angle sign: PAL swings with the modem's V-switch."""
    if not rp.swinging:
        return torch.ones(gline.shape, dtype=torch.float32, device=gline.device)
    return v_sign(plan, gline)


def _expected_angle(plan: QamPlan, rp: RasterPlan, gline: torch.Tensor) -> torch.Tensor:
    return _burst_sign(plan, rp, gline) * f32(rp.burst_phase)


@lru_cache(maxsize=32)
def _blank_ramp(k: float, n_blank: int, device: torch.device) -> torch.Tensor:
    """(n_blank,) float32 ``(k*m) mod 2*pi`` at ``m = -n_blank .. -1``,
    reduced in float64 on the host and uploaded once per (k, width, device)."""
    m = np.arange(n_blank, dtype=np.float64) - n_blank
    return torch.tensor((k * m) % (2.0 * np.pi), dtype=torch.float32, device=device)


def _blank_phase(plan: QamPlan, rp: RasterPlan, gline: torch.Tensor) -> torch.Tensor:
    """(..., L, n_blank) carrier phase over the blanking interval.

    Blanking sample ``m`` sits at active-relative index ``m - n_blank``:
    the per-line start phase (exact int32 law) plus a ramp ``(k*m) mod
    2*pi`` built on the host in float64 at negative ``m``.  No ``theta``:
    the burst angle is on the un-rotated U axis.
    """
    k = TWO_PI * plan.cfg.chroma.fsc / plan.fs
    phi0 = line_phase0(plan.cfg.cpl_num, plan.cfg.cpl_den, gline)
    return phi0[..., None] + _blank_ramp(k, rp.n_blank, gline.device)


def _window(rp: RasterPlan, start: int, length: int, device) -> torch.Tensor:
    """(n_blank,) bool mask of ``[start, start + length)``, built on the device."""
    idx = torch.arange(rp.n_blank, device=device)
    return (idx >= start) & (idx < start + length)


def add_raster(plan: QamPlan | FmPlan, rp: RasterPlan, comp: torch.Tensor,
               gline: torch.Tensor) -> torch.Tensor:
    """(..., L, n_active) active composite -> (..., L, n_total) rastered."""
    dev = comp.device
    sync = _window(rp, rp.sync_start, rp.sync_len, dev)
    blank = torch.where(sync, f32(SYNC_LEVEL), 0.0).to(torch.float32)
    blank = blank.expand(*comp.shape[:-1], rp.n_blank)
    if rp.burst_len:
        burst_mask = _window(rp, rp.burst_start, rp.burst_len, dev)
        phi = _blank_phase(plan, rp, gline)
        sgn = _burst_sign(plan, rp, gline)[..., None]
        burst = f32(BURST_AMP) * torch.sin(phi + sgn * f32(rp.burst_phase))
        blank = blank + torch.where(burst_mask, burst, 0.0)
    return torch.cat([blank, comp.to(torch.float32)], dim=-1)


def strip_raster(rp: RasterPlan, rastered: torch.Tensor) -> torch.Tensor:
    """(..., L, n_total) -> (..., L, n_active): drop the blanking interval
    (a contiguous copy, so the decode sees the same memory layout as an
    un-rastered composite)."""
    if rastered.shape[-1] != rp.n_total:
        raise ValueError(
            f"expected {rp.n_total}-sample rastered lines, got "
            f"{rastered.shape[-1]}; was this composite encoded with raster=True?"
        )
    return rastered[..., rp.n_blank:].contiguous()


def measure_burst_phase(plan: QamPlan | FmPlan, rp: RasterPlan,
                        rastered: torch.Tensor, gline: torch.Tensor):
    """Quadrature-correlate the burst window -> per-line (amplitude, phase).

    ``phase`` is the burst angle on the U axis in (-pi, pi]; undistorted it
    is ``+-rp.burst_phase`` (sign per V-switch).  A channel phase error adds
    to it directly.
    """
    if not rp.burst_len:
        raise ValueError(f"{plan.cfg.name} has no color burst")
    sl = slice(rp.burst_start, rp.burst_start + rp.burst_len)
    win = rastered[..., sl]
    phi = _blank_phase(plan, rp, gline)[..., sl]
    i = torch.mean(2.0 * win * torch.sin(phi), dim=-1)
    q = torch.mean(2.0 * win * torch.cos(phi), dim=-1)
    return torch.hypot(i, q), torch.atan2(q, i)


def decode_burst_locked(plan: QamPlan, rp: RasterPlan, rastered: torch.Tensor,
                        gline: torch.Tensor, decoder: str = "notch",
                        backend: str = "kernel", acc: bool = False,
                        color_kill: float = 0.0) -> torch.Tensor:
    """Decode a rastered block with the burst-measured subcarrier phase.

    The per-line phase error (measured burst angle minus the spec angle,
    wrapped to (-pi, pi]) goes to ``decode_block``'s ``phase_err``.
    ``acc``: automatic chroma control, a chroma gain of spec over measured
    burst amplitude, clipped to [1/4, 4].  ``color_kill``: lines whose burst
    reads below this fraction of the spec amplitude decode with chroma gain
    0 (typical 0.3-0.5).  QAM standards only.
    """
    from color_modem_tpu_torch.frame.pipeline import decode_block

    amp, phase = measure_burst_phase(plan, rp, rastered, gline)
    delta = phase - _expected_angle(plan, rp, gline)
    delta = torch.atan2(torch.sin(delta), torch.cos(delta))
    cg = None
    ref = f32(BURST_AMP)
    if acc:
        cg = torch.clamp(ref / torch.clamp_min(amp, f32(f32(0.05) * ref)), 0.25, 4.0)
    if color_kill > 0.0:
        base = cg if cg is not None else torch.ones_like(amp)
        cg = torch.where(amp < f32(f32(color_kill) * ref), 0.0, base)
    comp = strip_raster(rp, rastered)
    return decode_block(plan, comp, gline, decoder, backend,
                        phase_err=delta, chroma_gain=cg)


def identify_vswitch(plan: QamPlan, rp: RasterPlan, rastered: torch.Tensor,
                     gline: torch.Tensor) -> torch.Tensor:
    """PAL ident: the V-switch parity from the swinging burst.

    Under the right parity hypothesis the residual ``measured -
    v_sign*135deg`` is one constant over the frame (a static channel phase
    error or an even counter slip rotates every line alike); under the
    flipped one it alternates by 180 deg and its mean resultant collapses.
    Returns int32 slip per frame (``gline.shape[:-1]``): 0 = the counter's
    parity is right, 1 = decode with ``gline + 1``.
    """
    if not rp.swinging:
        raise ValueError(
            f"{plan.cfg.name} has no swinging burst; V-switch "
            "identification is a PAL-family feature"
        )
    _, phase = measure_burst_phase(plan, rp, rastered, gline)
    expected = _expected_angle(plan, rp, gline)

    def coherence(exp):
        e = phase - exp
        return torch.hypot(torch.mean(torch.cos(e), dim=-1),
                           torch.mean(torch.sin(e), dim=-1))

    return (coherence(-expected) > coherence(expected)).to(torch.int32)


def decode_identified(plan: QamPlan, rp: RasterPlan, rastered: torch.Tensor,
                      gline: torch.Tensor, decoder: str = "notch",
                      backend: str = "kernel"):
    """Burst-locked decode that does not trust the line counter's parity:
    the ident sets the V-switch, then the burst lock cancels the residual
    phase.  Returns ``(rgb, slip)``."""
    slip = identify_vswitch(plan, rp, rastered, gline)
    g = gline + slip[..., None]
    return decode_burst_locked(plan, rp, rastered, g, decoder, backend), slip
