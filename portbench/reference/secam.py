"""Plain reference of SECAM's round trip: colour matrix, line-alternate FM
of D'R (odd absolute lines) and D'B (even), with LF pre-emphasis and the
HF anti-cloche; the decoder's blanking-extended bell takeoff, quadrature
discriminator, de-emphasis and low-pass; the ``interp`` pairing, which
takes the missing component as the mean of the two adjacent lines.

Vectorised over lines; the taps come from the configuration's parameters
through :mod:`portbench.reference.design`.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import design
from portbench.reference.common import (
    TWO_PI,
    Precision,
    fir,
    fir_held,
    line_index,
    mat3,
    reflect,
)
from portbench.reference.qam import REF_FS, matrices

#: the system's SECAM design constants, at REF_FS: mix low-pass cutoff,
#: decode blanking margin and pedestal length (samples), takeoff half-width
#: and band transition (Hz), and the tap counts of the carrier-band
#: filters, the differentiator and the emphasis pair
MIX_LPF, MARGIN, LUMA_EST = 1.4e6, 48, 27
TAKEOFF_HALFWIDTH, BAND_TRANSITION = 2.0e6, 0.4e6
BELL_NTAPS, DIFF_NTAPS, EMPH_NTAPS = 193, 31, 257
DECODERS = ("interp",)


def make(cfg: dict) -> SimpleNamespace:
    """Everything the round trip needs, from the configuration file."""
    p = cfg["params"]
    n = int(cfg["samples"])
    fs = n / p["t_active"]
    k = fs / REF_FS
    ntaps = design.odd_taps(p["ntaps"] * k)
    bell_n, diff_n, emph_n = (design.odd_taps(t * k) for t in (BELL_NTAPS, DIFF_NTAPS, EMPH_NTAPS))
    margin = int(round(MARGIN * k))
    f_center = 0.5 * (p["f0r"] + p["f0b"])
    band_lo, band_hi = p["bell_f0"] - TAKEOFF_HALFWIDTH, p["bell_f0"] + TAKEOFF_HALFWIDTH
    bell = (p["bell_f0"], p["bell_m0"], p["bell_k_num"], p["bell_k_den"])

    def band(f):
        return design.raised_cosine_bandpass_response(f, band_lo, band_hi, BAND_TRANSITION)

    fwd, inv = matrices(p)
    return SimpleNamespace(
        n=n, fs=fs, fm=True, total_lines=int(p["total_lines"]), margin=margin,
        luma_est=max(3, int(round(LUMA_EST * k))), f_center=f_center,
        f0r=p["f0r"], f0b=p["f0b"], dev_r=p["dev_r"], dev_b=p["dev_b"],
        comp_lpf=design.lowpass_taps(fs, p["component_bandwidth"], ntaps),
        preemph=design.freq_sampled_taps(
            fs, lambda f: design.secam_preemph_response(f, p["preemph_f1"]), emph_n),
        deemph=design.freq_sampled_taps(
            fs, lambda f: design.secam_deemph_response(f, p["preemph_f1"]), emph_n),
        anticloche=design.freq_sampled_taps(
            fs, lambda f: design.secam_anticloche_response(f, *bell) * band(f), bell_n),
        bell_takeoff=design.freq_sampled_taps(
            fs, lambda f: design.secam_cloche_response(f, *bell) * band(f), bell_n),
        luma_notch=design.freq_sampled_taps(fs, band, bell_n),
        mix_lpf=design.lowpass_taps(fs, MIX_LPF, ntaps),
        diff=design.differentiator_taps(fs, diff_n),
        demod_lpf=design.lowpass_taps(fs, p["demod_lpf"], ntaps),
        # the left blanking's rest carrier of a D'B (row 0) and a D'R line
        margin_carrier=np.stack([
            p["bell_m0"] * np.cos(TWO_PI * f0 / fs * (np.arange(-margin, 0) + 0.5))
            for f0 in (p["f0b"], p["f0r"])]),
        mix_ramp=design.phase_ramp(f_center, fs, n + 2 * margin, offset=-margin),
        rgb_to_ycc=fwd, ycc_to_rgb=inv,
    )


def _rest(plan, is_r: torch.Tensor, dtype):
    """Rest frequency and deviation per line, (B, L, 1)."""
    f0 = torch.where(is_r, plan.f0r, plan.f0b).to(dtype)[..., None]
    dev = torch.where(is_r, plan.dev_r, plan.dev_b).to(dtype)[..., None]
    return f0, dev


def encode(plan, rgb: torch.Tensor, frames, prec: Precision) -> torch.Tensor:
    """(B, 3, L, N) RGB of frames ``frames`` -> (B, L, N) composite."""
    g = line_index(frames, rgb.shape[-2], plan.total_lines, rgb.device)
    is_r = torch.remainder(g, 2) == 1
    ycc = mat3(plan.rgb_to_ycc, rgb, prec)
    d = torch.where(is_r[..., None], ycc[:, 1], ycc[:, 2])
    d = fir_held(fir_held(d, plan.comp_lpf, prec), plan.preemph, prec)
    f0, dev = _rest(plan, is_r, prec.dtype)
    f_inst = f0 + dev * d
    # the phase integral restarts each line; the midpoint rule puts the
    # instantaneous frequency of sample n at sample n
    phi = TWO_PI * (torch.cumsum(f_inst, dim=-1) - 0.5 * f_inst) / plan.fs
    return ycc[:, 0] + fir(torch.cos(phi), plan.anticloche, prec)


def decode(plan, comp: torch.Tensor, frames, decoder: str, prec: Precision) -> torch.Tensor:
    """(B, L, N) composite -> (B, 3, L, N) RGB clamped to [0, 1]."""
    if decoder not in DECODERS:
        raise NotImplementedError(f"the SECAM reference decodes {DECODERS}, not {decoder!r}")
    b, n_lines, n = comp.shape
    m, k = plan.margin, plan.luma_est
    comp = comp.to(prec.dtype)
    g = line_index(frames, n_lines, plan.total_lines, comp.device)
    is_r = torch.remainder(g, 2) == 1
    # the blanking neighbourhoods: the line's luma pedestal on both sides,
    # the rest carrier on the left
    carrier = torch.from_numpy(plan.margin_carrier).to(comp.device, prec.dtype)
    left = comp[..., :k].mean(-1, keepdim=True) + carrier[is_r.long()]
    right = comp[..., -k:].mean(-1, keepdim=True).expand(b, n_lines, m)
    ext = torch.cat([left, comp, right], dim=-1)
    takeoff = fir(ext, plan.bell_takeoff, prec)
    luma = (ext - fir(ext, plan.luma_notch, prec))[..., m:m + n]
    mix = torch.from_numpy(plan.mix_ramp).to(comp.device, prec.dtype)
    i = fir(2.0 * takeoff * torch.cos(mix), plan.mix_lpf, prec)
    q = fir(-2.0 * takeoff * torch.sin(mix), plan.mix_lpf, prec)
    di, dq = fir(i, plan.diff, prec), fir(q, plan.diff, prec)
    a2 = torch.clamp_min(i * i + q * q, 1e-9)
    f_inst = plan.f_center + (i * dq - q * di) / (TWO_PI * a2) * plan.fs
    f0, dev = _rest(plan, is_r, prec.dtype)
    v = fir(fir((f_inst - f0) / dev, plan.deemph, prec), plan.demod_lpf, prec)[..., m:m + n]
    rows = np.arange(n_lines)
    other = 0.5 * (v[:, reflect(rows - 1, n_lines)] + v[:, reflect(rows + 1, n_lines)])
    r = is_r[..., None]
    ycc = torch.stack([luma, torch.where(r, v, other), torch.where(r, other, v)], dim=1)
    return torch.clamp(mat3(plan.ycc_to_rgb, ycc, prec), 0.0, 1.0)
