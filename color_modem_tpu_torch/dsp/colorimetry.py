"""Colorimetry: RGB <-> (Y, C1, C2) 3x3 matrices on ``(..., 3, L, N)``.

Port of ``color_modem_tpu/dsp/colorimetry.py``.  The JAX version asks for
``Precision.HIGHEST`` (full float32).  Here each output plane is three
scaled adds of the input planes, in float32 arithmetic, in the order
c = 0, 1, 2: no matrix product, so no process-wide matmul precision setting
(TF32, bf16) can change it.  These are the plain versions: on a CUDA tensor
``kernels/colorimetry.py`` computes each in one pass of the hand-written
kernel ``csrc/colour_matrix.cu``, and the pipelines' backend table
(``frame/pipeline.py::STAGES``) picks which of the two runs.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.separate.delayline import average_with_neighbor


def apply_mat3(mat: torch.Tensor, x: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """``y[..., d, l, n] = sum_c mat[d, c] * x[..., c, l, n]``: three scaled
    adds of the input planes in the order c = 0, 1, 2, in elementwise
    arithmetic (no matrix product, so no process-wide matmul precision
    setting can change it), then with ``clamp`` clamped to [0, 1] as
    :func:`clamp01` does.  ``mat`` stays on the device (no host readback)."""
    m = mat.to(device=x.device, dtype=x.dtype).reshape(3, 3, 1, 1)
    y = x[..., 0:1, :, :] * m[:, 0]
    y.addcmul_(x[..., 1:2, :, :], m[:, 1])
    y.addcmul_(x[..., 2:3, :, :], m[:, 2])
    return torch.clamp(y, 0.0, 1.0) if clamp else y


def check_delay_lines(x: torch.Tensor) -> None:
    """A frame of one line has no neighbour for the delay line."""
    if x.shape[-2] < 2:
        raise ValueError(f"x: the delay line needs 2 or more lines a frame, got {x.shape[-2]}")


def delayline_mat3(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The delay-line decoders' last step over ``(..., 3, L, N)``
    ``(Y, C1, C2)``: ``average_with_neighbor`` on C1 and on C2 (line 0
    with line 1, every other line with the one before), the stack, and
    :func:`apply_mat3` with the clamp.  Fewer than 2 lines a frame:
    ``ValueError``."""
    check_delay_lines(x)
    y, c1, c2 = x.unbind(-3)
    ycc = torch.stack([y, average_with_neighbor(c1), average_with_neighbor(c2)], dim=-3)
    return apply_mat3(mat, ycc, clamp=True)


def clamp01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)
