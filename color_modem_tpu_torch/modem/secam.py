"""SECAM FM chroma modem as plain PyTorch on ``(..., L, N)`` blocks.

Port of ``color_modem_tpu/modem/secam.py``.  Each line carries D'R (odd
absolute lines) or D'B (even) as a frequency deviation of its own rest
carrier.

* Encode: the FM phase integral restarts every line, so it is a cumsum
  along the sample axis.  It is taken as the float64-built carrier ramp
  plus ``cumsum(df) - df/2`` (midpoint rule) of the small deviation term, so
  the float32 scan never sees the raw integral.
* Decode: the blanking-extended line goes through a quadrature
  discriminator, ``fc + (I*dQ - Q*dI) / (2*pi*(I^2+Q^2))``; dividing by the
  squared amplitude is the limiter.  Line pairing (the missing component
  comes from the opposite-parity neighbour) is a shifted-tensor select.
* Line identification: decide blindly, or from the ident "bottles", whether
  the assumed D'R/D'B parity is right.

These are the plain twins of the CUDA kernels in ``kernels/secam.py``: the
``plain`` pipeline backend runs them, and the tests hold them against the
JAX package's ``xla`` path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp.apply import fir_same, fir_same_held
from color_modem_tpu_torch.dsp.nco import TWO_PI, f32
from color_modem_tpu_torch.modem.plan import FmPlan
from color_modem_tpu_torch.separate.stencil import next_reflect, prev_reflect


def is_r_line(gline: torch.Tensor) -> torch.Tensor:
    """Odd absolute lines carry D'R."""
    return torch.remainder(gline, 2) == 1


def _per_line_f0_dev(plan: FmPlan, gline: torch.Tensor):
    """float32 (..., L) rest frequency and deviation of each line, in Hz."""
    p = plan.chroma
    r = is_r_line(gline)
    f0 = torch.where(r, f32(p.f0r), f32(p.f0b)).to(torch.float32)
    dev = torch.where(r, f32(p.dev_r), f32(p.dev_b)).to(torch.float32)
    return f0, dev


def encode(plan: FmPlan, ycc: torch.Tensor, gline: torch.Tensor) -> torch.Tensor:
    """(..., 3, L, N) (Y, D'R, D'B) + (..., L) -> (..., L, N) composite."""
    y, dr, db = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    d = torch.where(is_r_line(gline)[..., None], dr, db)
    # held edges on the baseband filters; the carrier-band anti-cloche keeps
    # the zero edge
    d = fir_same_held(d, plan.comp_lpf_held)
    d = fir_same_held(d, plan.preemph_held)
    f0, dev = _per_line_f0_dev(plan, gline)
    df = (f0[..., None] - f32(plan.f_center)) + dev[..., None] * d
    dfr = df * f32(TWO_PI / plan.fs)
    dphi = torch.cumsum(dfr, dim=-1) - 0.5 * dfr
    carrier = torch.cos(plan.fm_carrier_ramp + dphi)
    return y + fir_same(carrier, plan.anticloche_mat)


def extend_blanking(plan: FmPlan, comp: torch.Tensor,
                    gline: torch.Tensor) -> torch.Tensor:
    """(..., L, N) -> (..., L, N + 2M): rebuild the blanking neighbourhood.

    Both margins hold the line's luma pedestal, the mean of its first and
    last ``fm_luma_est`` samples; the left margin adds the rest carrier,
    whose phase at sample 0 is a modem convention.
    """
    return extend_blanking_parity(plan, comp, is_r_line(gline))


def extend_blanking_parity(plan: FmPlan, comp: torch.Tensor,
                           r: torch.Tensor) -> torch.Tensor:
    """:func:`extend_blanking` with the parity given as a bool (..., L)
    tensor, True on D'R lines."""
    m, k = plan.fm_margin, plan.fm_luma_est
    lum_l = comp[..., :k].mean(dim=-1, keepdim=True)
    lum_r = comp[..., -k:].mean(dim=-1, keepdim=True)
    left = lum_l + plan.fm_margin_carrier[r.long()]
    right = lum_r.expand(*comp.shape[:-1], m)
    return torch.cat([left, comp, right], dim=-1)


def _instantaneous_frequency(plan: FmPlan, ext: torch.Tensor) -> torch.Tensor:
    """Quadrature discriminator on a blanking-extended block: (..., L, N+2M)
    -> instantaneous frequency in Hz.  Parity-free."""
    takeoff = fir_same(ext, plan.bell_takeoff_mat)
    mix = plan.mix_ramp_ext
    i = fir_same(2.0 * takeoff * torch.cos(mix), plan.mix_lpf_mat)
    q = fir_same(-2.0 * takeoff * torch.sin(mix), plan.mix_lpf_mat)
    di = fir_same(i, plan.diff_mat)
    dq = fir_same(q, plan.diff_mat)
    a2 = torch.clamp_min(i * i + q * q, 1e-9)  # limiter: amplitude cancels
    return f32(plan.f_center) + (i * dq - q * di) / (f32(TWO_PI) * a2) * f32(plan.fs)


def demodulate_lines(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor):
    """(..., L, N) composite -> (luma, v), v = this line's D'R or D'B."""
    m, n = plan.fm_margin, comp.shape[-1]
    ext = extend_blanking(plan, comp, gline)
    luma = ext - fir_same(ext, plan.luma_notch_mat)
    f_inst = _instantaneous_frequency(plan, ext)
    f0, dev = _per_line_f0_dev(plan, gline)
    d_hat = (f_inst - f0[..., None]) / dev[..., None]
    d_hat = fir_same(d_hat, plan.deemph_mat)
    d_hat = fir_same(d_hat, plan.demod_lpf_mat)
    return luma[..., m : m + n], d_hat[..., m : m + n]


def pair_components(v: torch.Tensor, gline: torch.Tensor):
    """(D'R, D'B) from the per-line component stream: the missing component
    is the previous line's (the first line of the block takes the next)."""
    v_other = prev_reflect(v, 1)
    r = is_r_line(gline)[..., None]
    return torch.where(r, v, v_other), torch.where(r, v_other, v)


def pair_components_interp(v: torch.Tensor, gline: torch.Tensor):
    """Interpolated pairing (the 'interp' decoder): the missing component is
    the mean of both adjacent lines, which both carry it."""
    o = 0.5 * (prev_reflect(v, 1) + next_reflect(v, 1))
    r = is_r_line(gline)[..., None]
    return torch.where(r, v, o), torch.where(r, o, v)


def pair(v: torch.Tensor, gline: torch.Tensor, pairing: str = "copy"):
    """Dispatch on ``pairing``: ``"interp"`` or the copy rule."""
    fn = pair_components_interp if pairing == "interp" else pair_components
    return fn(v, gline)


def decode(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor,
           pairing: str = "copy") -> torch.Tensor:
    """Full SECAM decode to (..., 3, L, N) (Y, D'R, D'B) components."""
    luma, v = demodulate_lines(plan, comp, gline)
    dr, db = pair(v, gline, pairing)
    return torch.stack([luma, dr, db], dim=-3)


def _central(plan: FmPlan, n: int) -> slice:
    """The central 60% of the extended line: clear of the margins and the
    filters' edge smear."""
    m = plan.fm_margin
    return slice(m + n // 5, m + (4 * n) // 5)


def identify_parity(plan: FmPlan, comp: torch.Tensor,
                    gline: torch.Tensor) -> torch.Tensor:
    """Blind SECAM line identification: is the assumed D'R/D'B parity right?

    Each line's mean instantaneous frequency estimates its rest carrier;
    the hypothesis (as given, or swapped) with the smaller squared residual
    against the (f0r, f0b) line pattern wins, one decision per frame.
    Returns (...,) int32: 0 = ``gline``'s parity is right, 1 = swapped.  A
    frame of one solid, fully saturated colour can defeat it; ident lines
    (:func:`ident_lines`) decide that case.
    """
    ext = extend_blanking(plan, comp, gline)
    f = _instantaneous_frequency(plan, ext)
    mean_f = f[..., _central(plan, comp.shape[-1])].mean(dim=-1)   # (..., L)
    f0_given, _ = _per_line_f0_dev(plan, gline)
    f0_swap, _ = _per_line_f0_dev(plan, gline + 1)
    s_given = ((mean_f - f0_given) ** 2).sum(dim=-1)
    s_swap = ((mean_f - f0_swap) ** 2).sum(dim=-1)
    return (s_swap < s_given).to(torch.int32)


#: ident-line sawtooth peak, in component units
_IDENT_PEAK = 1.0


@lru_cache(maxsize=16)
def _ident_ramp(n: int, device: torch.device) -> torch.Tensor:
    """The bottles' sawtooth (N,), uploaded once per width and device."""
    return torch.tensor(np.linspace(0.0, _IDENT_PEAK, n, dtype=np.float32), device=device)


def ident_lines(plan: FmPlan, gline: torch.Tensor) -> torch.Tensor:
    """Content-free identification lines, the SECAM "bottles": D'R lines
    sweep up from rest, D'B lines down.  ``gline`` (..., R) -> (..., R, N)
    composite rows (zero luma plus the swept carrier)."""
    ramp = _ident_ramp(plan.n_samples, gline.device)
    r = is_r_line(gline)[..., None]
    d = torch.where(r, ramp, -ramp)
    y = torch.zeros_like(d)
    ycc = torch.stack([y, torch.where(r, d, y), torch.where(r, y, d)], dim=-3)
    return encode(plan, ycc, gline)


def identify_from_ident(plan: FmPlan, ident_rows: torch.Tensor,
                        gline: torch.Tensor) -> torch.Tensor:
    """Read the parity off received ident rows (..., R, N): the slope of
    the instantaneous frequency is + on D'R bottles and - on D'B ones,
    whatever parity is assumed.  Returns (...,) int32 like
    :func:`identify_parity`."""
    ext = extend_blanking(plan, ident_rows, gline)
    f = _instantaneous_frequency(plan, ext)
    fw = f[..., _central(plan, ident_rows.shape[-1])]
    t = torch.arange(fw.shape[-1], dtype=torch.float32, device=fw.device)
    t = t - t.mean()
    slope = (fw * t).sum(dim=-1)                   # regression numerator
    want_up = is_r_line(gline).to(torch.float32) * 2.0 - 1.0
    agree = (slope * want_up).sum(dim=-1)          # + if the parity is right
    return (agree < 0.0).to(torch.int32)


def decode_identified(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor,
                      pairing: str = "copy", ident_rows: int = 0):
    """SECAM decode without trusting the line parity.  With ``ident_rows``
    > 0 the top rows are ident lines and decide; otherwise
    :func:`identify_parity` does.  Returns (components, swap)."""
    if ident_rows > 0:
        swap = identify_from_ident(
            plan, comp[..., :ident_rows, :], gline[..., :ident_rows]
        )
    else:
        swap = identify_parity(plan, comp, gline)
    return decode(plan, comp, gline + swap[..., None], pairing), swap
