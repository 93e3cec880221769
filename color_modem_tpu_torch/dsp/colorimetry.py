"""Colorimetry: RGB <-> (Y, C1, C2) 3x3 matrices on ``(..., 3, L, N)``.

Port of ``color_modem_tpu/dsp/colorimetry.py``.  The JAX version asks for
``Precision.HIGHEST`` (full float32).  Here each output plane is three
scaled adds of the input planes, in float32 elementwise arithmetic: no
matrix product, so no process-wide matmul precision setting (TF32, bf16)
can change it.
"""

from __future__ import annotations

import torch


def apply_mat3(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[..., d, l, n] = sum_c mat[d, c] * x[..., c, l, n]``, summed in the
    order c = 0, 1, 2.  ``mat`` stays on the device (no host readback)."""
    m = mat.to(device=x.device, dtype=x.dtype).reshape(3, 3, 1, 1)
    y = x[..., 0:1, :, :] * m[:, 0]
    y.addcmul_(x[..., 1:2, :, :], m[:, 1])
    return y.addcmul_(x[..., 2:3, :, :], m[:, 2])


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)
