"""NIIR ("SECAM IV") reference-line normalisation.

Port of ``color_modem_tpu/modem/niir.py``.  Even absolute lines carry QAM
chroma, odd lines an unmodulated reference carrier ``(A_ref, 0)``
(``modem/qam.py`` injects it).  The decoder divides each chroma
measurement ``z = c1 + j*c2`` by its neighbouring reference measurement
and multiplies by ``A_ref``, which cancels the channel's chroma gain and
phase.  Real-pair arithmetic, no complex dtype, in the JAX package's order.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.modem.plan import QamPlan
from color_modem_tpu_torch.separate.stencil import prev_reflect

#: below this |z_ref|^2 the reference is taken as missing: no correction
WEAK_REFERENCE = 1e-12


def is_chroma_line(gline: torch.Tensor) -> torch.Tensor:
    return torch.remainder(gline, 2) == 0


def normalize(plan: QamPlan, c1: torch.Tensor, c2: torch.Tensor,
              gline: torch.Tensor):
    """(..., L, N) demodulated (c1, c2) -> gain/phase-normalised (u, v)."""
    a_ref = f32(plan.chroma.reference_amplitude)
    chroma = is_chroma_line(gline)[..., None]
    o1, o2 = prev_reflect(c1, 1), prev_reflect(c2, 1)
    # route this line's and the neighbour's measurements to (chroma, reference)
    zc1 = torch.where(chroma, c1, o1)
    zc2 = torch.where(chroma, c2, o2)
    zr1 = torch.where(chroma, o1, c1)
    zr2 = torch.where(chroma, o2, c2)
    # a vanishing reference falls back to the nominal (A_ref, 0)
    weak = (zr1 * zr1 + zr2 * zr2) < f32(WEAK_REFERENCE)
    zr1 = torch.where(weak, a_ref, zr1)
    zr2 = torch.where(weak, 0.0, zr2)
    den = zr1 * zr1 + zr2 * zr2
    # zc * A_ref / zr  =  A_ref * zc * conj(zr) / |zr|^2
    u = a_ref * (zc1 * zr1 + zc2 * zr2) / den
    v = a_ref * (zc2 * zr1 - zc1 * zr2) / den
    return u, v
