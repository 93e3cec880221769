"""Chroma averaging over adjacent lines (the 'delayline' and 'avg'
decoders).

Port of ``color_modem_tpu/separate/delayline.py``.  The first line pairs
with the next one, as in the golden oracle's ``_neighbor``.  The QAM
'delayline'/'avg' decoders apply it to the demodulated (c1, c2) planes
(NIIR 'avg' after the reference normalisation), SECAM 'avg' to the
assembled D'R/D'B planes, each as the first step of
``dsp/colorimetry.py::delayline_mat3``.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.separate.stencil import prev_reflect


def average_with_neighbor(c: torch.Tensor) -> torch.Tensor:
    """c'[..., l, :] = (c[l] + c[neighbor(l)]) / 2 along the line axis."""
    return 0.5 * (c + prev_reflect(c, 1))
