"""Plain reference of PAL's round trip with the delay-line decoder (PAL-D):
the encoder and carrier of :mod:`portbench.reference.qam` (colour matrix,
quadrature modulation with the V-switch on the closed-form subcarrier),
then the notch separation (the chroma band-pass of the composite itself,
luma what is left), the product detector with the V-switch sign, U and V
of each line averaged with those of the line before, the inverse matrix
and the clamp.

Where it departs from a hardware PAL-D receiver, as the system it checks
does (``standards/decoders.py``): the receiver sums the subcarrier of two
lines through a 64 us glass delay line before it demodulates, and gets U
and V apart from the sum and the difference; here, as in the system, the
demodulated baseband U and V are averaged, which equals it under ideal
demodulation.  The first line of a frame, which has no line before it,
takes the line after it (the system's reflection), where a receiver would
take the last line of the field before.  Nothing of the receiver's burst
lock, ACC or ident runs: the carrier's phase is the transmitter's, worked
out exactly from the absolute line index.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.common import Precision, fir, line_index, mat3, reflect
from portbench.reference.qam import _carrier, encode, make  # noqa: F401

DECODERS = ("delayline",)


def decode(plan, comp: torch.Tensor, frames, decoder: str, prec: Precision) -> torch.Tensor:
    """(B, L, N) composite -> (B, 3, L, N) RGB clamped to [0, 1]."""
    if decoder not in DECODERS:
        raise NotImplementedError(f"the PAL reference decodes {DECODERS}, not {decoder!r}")
    n_lines = comp.shape[-2]
    if n_lines < 2:
        raise ValueError("the delay line needs 2 or more lines a frame")
    comp = comp.to(prec.dtype)
    band = fir(comp, plan.chroma_bpf, prec)
    g = line_index(frames, n_lines, plan.total_lines, comp.device)
    s, c, sign = _carrier(plan, g, prec)
    u = fir(2.0 * band * s, plan.c1_lpf, prec)
    v = sign * fir(2.0 * band * c, plan.c2_lpf, prec)
    before = reflect(np.arange(n_lines) - 1, n_lines)
    u = (u + u[:, before]) / 2.0
    v = (v + v[:, before]) / 2.0
    rgb = mat3(plan.ycc_to_rgb, torch.stack([comp - band, u, v], dim=1), prec)
    return torch.clamp(rgb, 0.0, 1.0)
