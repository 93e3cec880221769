"""VIR: the NTSC line-19 Vertical Interval Reference (EIA-516 shape).

Port of ``color_modem_tpu/frame/vir.py``.  The reference line carries a
chroma reference riding a 70-IRE luma pedestal, a 50-IRE luma reference
and a black reference.  The chroma reference sits at picture level, where
a differential (luma-tracking) gain or phase error shows that the burst at
blanking level cannot see; the receiver measures it and corrects the
whole picture through ``decode_block``'s ``phase_err`` and
``chroma_gain`` hooks.

The line is a closed-form waveform on the subcarrier phase law, and the
measurement two masked projections onto sin/cos of the same phase.
Layout, as fractions of the active line: [0.10, 0.50) chroma reference
(``CHROMA_AMP`` on the +U (sin) axis over ``PEDESTAL_LUMA``), [0.50, 0.75)
luma reference ``LUMA_REF``, [0.75, 0.95) black reference ``BLACK_REF``.

The plan's buffers must lie on the data's device (``plan_on(plan, dev)``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.frame.pipeline import decode_block
from color_modem_tpu_torch.modem.plan import QamPlan
from color_modem_tpu_torch.modem.qam import carrier_phase

#: composite units (1.0 = 100 IRE, no setup)
PEDESTAL_LUMA = 0.70
CHROMA_AMP = 0.20  # 40 IRE peak-to-peak
LUMA_REF = 0.50
BLACK_REF = 0.075

_SEGS = ((0.10, 0.50), (0.50, 0.75), (0.75, 0.95))


def _check(plan) -> None:
    if plan.cfg.is_fm:
        raise ValueError(f"VIR needs a QAM subcarrier; {plan.cfg.name} is FM")


def _masks(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float32 (N,) masks of the chroma, luma-reference and black segments,
    each trimmed 8 samples per side so FIR and channel transients at the
    steps never enter a measurement window."""
    idx = np.arange(n)
    out = []
    for lo, hi in _SEGS:
        a, b = int(lo * n) + 8, int(hi * n) - 8
        out.append(((idx >= a) & (idx < b)).astype(np.float32))
    return tuple(out)


@lru_cache(maxsize=16)
def _masks_on(n: int, device: torch.device) -> tuple:
    """The three masks and the line's fixed levels on ``device``, and the
    masks' sample counts (host floats, exact in float32)."""
    masks = _masks(n)
    m_ch, m_lu, m_bk = masks
    base = (PEDESTAL_LUMA * m_ch + LUMA_REF * m_lu + BLACK_REF * m_bk).astype(np.float32)
    return (tuple(torch.tensor(a, device=device) for a in (m_ch, m_lu, m_bk, base)),
            tuple(float(m.sum()) for m in masks))


def vir_lines(plan: QamPlan, gline: torch.Tensor) -> torch.Tensor:
    """(..., L) absolute line indices -> (..., L, N) VIR reference lines."""
    _check(plan)
    (m_ch, _, _, base), _ = _masks_on(plan.n_samples, gline.device)
    return base + m_ch * f32(CHROMA_AMP) * torch.sin(carrier_phase(plan, gline))


def measure_vir(plan: QamPlan, vir: torch.Tensor, gline: torch.Tensor) -> dict:
    """Measure received VIR rows (..., L, N) against the spec, averaged over
    the rows; every value a tensor on the device (no host sync):

    * ``chroma_gain_corr``: spec over measured reference amplitude, the
      multiplicative chroma correction, within [1/4, 4] like the ACC loop;
    * ``phase_err``: the phase error at picture level, rad (feed it to
      ``decode_block(phase_err=...)``);
    * ``luma_ref`` / ``black_ref``: the measured pedestal levels.
    """
    _check(plan)
    vir = vir.to(torch.float32)
    n, rows = vir.shape[-1], vir.shape[-2]
    (m_ch, m_lu, m_bk, _), (n_ch, n_lu, n_bk) = _masks_on(n, vir.device)
    phi = carrier_phase(plan, gline)
    w = m_ch / n_ch
    # sin carries the reference, cos reads the quadrature leak; the pedestal
    # is DC and integrates out of both
    i = 2.0 * (w * vir * torch.sin(phi)).sum(dim=(-2, -1)) / rows
    q = 2.0 * (w * vir * torch.cos(phi)).sum(dim=(-2, -1)) / rows
    amp = torch.sqrt(i * i + q * q)
    return {
        "chroma_gain_corr": torch.clamp(
            f32(CHROMA_AMP) / torch.clamp_min(amp, 0.05 * CHROMA_AMP), 0.25, 4.0),
        "phase_err": torch.atan2(q, i),
        "luma_ref": (m_lu * vir).sum(dim=(-2, -1)) / (n_lu * rows),
        "black_ref": (m_bk * vir).sum(dim=(-2, -1)) / (n_bk * rows),
    }


def decode_vir_corrected(plan: QamPlan, comp: torch.Tensor, gline: torch.Tensor, n_vir: int,
                         decoder: str = "notch", backend: str = "kernel") -> torch.Tensor:
    """Decode a composite whose FIRST ``n_vir`` rows are VIR lines: measure
    the references, then decode the picture rows with the measured phase and
    gain corrections on every line.  Returns the picture RGB (rows
    ``n_vir:``)."""
    rep = measure_vir(plan, comp[..., :n_vir, :], gline[..., :n_vir])
    g_pic = gline[..., n_vir:]
    ones = torch.ones(g_pic.shape, dtype=torch.float32, device=comp.device)
    return decode_block(plan, comp[..., n_vir:, :], g_pic, decoder, backend,
                        phase_err=rep["phase_err"][..., None] * ones,
                        chroma_gain=rep["chroma_gain_corr"][..., None] * ones)
