"""Plain reference of a QAM standard's round trip (NTSC, PAL): colour
matrix, quadrature modulation on the closed-form subcarrier, three-line comb
separation, product detection, inverse matrix and clamp.

Vectorised over lines: each line ``l`` of frame ``f`` is absolute line
``g = f * total_lines + l``, whose line-start phase ``2 pi frac(g * cpl)``
is worked out in exact integers.  The taps come from the configuration's
parameters through :mod:`portbench.reference.design`.
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
    line_index,
    mat3,
    reflect,
)

#: the sample rate the tap counts are tuned at (the 720-sample BT.601 line)
REF_FS = 13.5e6
DECODERS = ("comb3",)


def matrices(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """RGB -> (Y, C1, C2) from the published rows, and its exact inverse."""
    fwd = np.array([p["luma_row"], p["c1_row"], p["c2_row"]], dtype=np.float64)
    return fwd, np.linalg.inv(fwd)


def make(cfg: dict) -> SimpleNamespace:
    """Everything the round trip needs, from the configuration file."""
    p = cfg["params"]
    n = int(cfg["samples"])
    fs = n / p["t_active"]
    ntaps = design.odd_taps(p["ntaps"] * fs / REF_FS)
    fwd, inv = matrices(p)
    cpl = p["cpl_num"] / p["cpl_den"]
    # the comb's line spacing: where the subcarrier flips nearest 180 degrees
    spacing = min((1, 2), key=lambda s: abs((s * cpl) % 1.0 - 0.5))
    return SimpleNamespace(
        n=n, fs=fs, fm=False, total_lines=int(p["total_lines"]),
        cpl_num=int(p["cpl_num"]), cpl_den=int(p["cpl_den"]),
        v_switch=bool(p["v_switch"]), spacing=spacing,
        theta=float(np.deg2rad(p["phase_offset_deg"])),
        ramp=design.phase_ramp(p["fsc"], fs, n),
        c1_lpf=design.lowpass_taps(fs, p["c1_bandwidth"], ntaps),
        c2_lpf=design.lowpass_taps(fs, p["c2_bandwidth"], ntaps),
        chroma_bpf=design.bandpass_taps(fs, p["fsc"] - p["chroma_band"],
                                        p["fsc"] + p["chroma_band"], ntaps),
        rgb_to_ycc=fwd, ycc_to_rgb=inv,
    )


def _carrier(plan, g: torch.Tensor, prec: Precision):
    """sin and cos of the subcarrier on lines ``g`` (B, L), and the
    V-switch sign (B, L, 1)."""
    phi0 = TWO_PI * torch.remainder(g * plan.cpl_num, plan.cpl_den).to(torch.float64) / plan.cpl_den
    ramp = torch.from_numpy(plan.ramp).to(g.device)
    phi = (phi0[..., None] + (ramp + plan.theta)).to(prec.dtype)
    sign = torch.ones_like(phi0, dtype=prec.dtype)
    if plan.v_switch:
        sign = torch.where(torch.remainder(g, 2) == 0, 1.0, -1.0).to(prec.dtype)
    return torch.sin(phi), torch.cos(phi), sign[..., None]


def encode(plan, rgb: torch.Tensor, frames, prec: Precision) -> torch.Tensor:
    """(B, 3, L, N) RGB of frames ``frames`` -> (B, L, N) composite."""
    g = line_index(frames, rgb.shape[-2], plan.total_lines, rgb.device)
    ycc = mat3(plan.rgb_to_ycc, rgb, prec)
    s, c, sign = _carrier(plan, g, prec)
    c1 = fir(ycc[:, 1], plan.c1_lpf, prec)
    c2 = fir(ycc[:, 2], plan.c2_lpf, prec)
    return ycc[:, 0] + c1 * s + sign * c2 * c


def decode(plan, comp: torch.Tensor, frames, decoder: str, prec: Precision) -> torch.Tensor:
    """(B, L, N) composite -> (B, 3, L, N) RGB clamped to [0, 1]: the
    three-line comb's separation, with reflected edge lines, then the
    product detector."""
    if decoder not in DECODERS:
        raise NotImplementedError(f"the QAM reference decodes {DECODERS}, not {decoder!r}")
    n_lines = comp.shape[-2]
    comp = comp.to(prec.dtype)
    rows = np.arange(n_lines)
    prev = comp[:, reflect(rows - plan.spacing, n_lines)]
    nxt = comp[:, reflect(rows + plan.spacing, n_lines)]
    band = fir((2.0 * comp - prev - nxt) / 4.0, plan.chroma_bpf, prec)
    g = line_index(frames, n_lines, plan.total_lines, comp.device)
    s, c, sign = _carrier(plan, g, prec)
    c1 = fir(2.0 * band * s, plan.c1_lpf, prec)
    c2 = sign * fir(2.0 * band * c, plan.c2_lpf, prec)
    rgb = mat3(plan.ycc_to_rgb, torch.stack([comp - band, c1, c2], dim=1), prec)
    return torch.clamp(rgb, 0.0, 1.0)
