"""Colorimetry: RGB <-> (Y, C1, C2) 3x3 matrices on ``(..., 3, L, N)``.

Port of ``color_modem_tpu/dsp/colorimetry.py``.  The JAX version asks for
``Precision.HIGHEST`` (full float32).  Here each output plane is three
scaled adds of the input planes, in float32 arithmetic, in the order
c = 0, 1, 2: no matrix product, so no process-wide matmul precision setting
(TF32, bf16) can change it.  On a CUDA tensor one pass of the hand-written
kernel ``csrc/colour_matrix.cu`` computes them, with the decoder's clamp
inside it (``kernels/colorimetry.py``); on the CPU, and on every device under
the pipelines' ``"plain"`` backend, its plain version does, so that the plain
backend on the card stays a witness of the kernel.  :func:`delayline_mat3`
is the delay-line decoders' last step, dispatched the same way.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.kernels.colorimetry import (
    colour_matrix,
    colour_matrix_plain,
    delayline_matrix,
    delayline_matrix_plain,
)


def apply_mat3(mat: torch.Tensor, x: torch.Tensor, clamp: bool = False,
               backend: str = "kernel") -> torch.Tensor:
    """``y[..., d, l, n] = sum_c mat[d, c] * x[..., c, l, n]``, summed in the
    order c = 0, 1, 2, then with ``clamp`` clamped to [0, 1] as
    :func:`clamp01` does.  ``mat`` stays on the device (no host readback).
    ``backend="plain"`` takes the plain version on a CUDA tensor too."""
    if backend == "kernel" and x.device.type == "cuda":
        return colour_matrix(mat, x, clamp)
    return colour_matrix_plain(mat, x, clamp)


def delayline_mat3(mat: torch.Tensor, x: torch.Tensor, backend: str = "kernel") -> torch.Tensor:
    """``(..., 3, L, N)`` ``(Y, C1, C2)`` with C1 and C2 of each line averaged
    with the line before (line 0 with line 1), then ``mat`` applied and the
    result clamped as :func:`apply_mat3` does: one pass of the CUDA kernel on
    a CUDA tensor with ``backend="kernel"``, else the plain composition."""
    if backend == "kernel" and x.device.type == "cuda":
        return delayline_matrix(mat, x)
    return delayline_matrix_plain(mat, x)


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)
