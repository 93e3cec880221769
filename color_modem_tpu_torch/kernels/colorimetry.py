"""The round trip's colour matrices: wrappers of ``csrc/colour_matrix.cu``.

No Pallas kernel stands behind this: the JAX package's
``dsp/colorimetry.py::apply_mat3`` is an einsum that XLA fuses with the
decoder's clamp.  The port's plain version (``dsp/colorimetry.py::apply_mat3``)
is a product and two strided ``addcmul_`` (the non-contiguous single-plane
slices fall to PyTorch's non-vectorised elementwise kernel), then a
separate ``clamp``: 18 planes of device traffic per matrix and 6 more for
the clamp.  The kernel reads the three planes once and writes three, the
clamp inside the same pass.

:func:`delayline_matrix` is the decoder's pass of the delay-line decoders
(``frame/pipeline.py::AVERAGING``): C1 and C2 averaged with the line before
(``separate/delayline.py::average_with_neighbor``), then the decoder's
matrix and clamp.  Its plain version is that composition
(``dsp/colorimetry.py::delayline_mat3``): two averages, a ``torch.stack``
and the matrix, some 20 planes of traffic in nine launches before the
matrix's; the kernel reads three planes and writes three, bit for bit the
same result.

They are CUDA C++ and not Triton: they are built into the one ``nvcc``
library the port already loads (``kernels/build.py``), so they add no JIT
compile to a run's set-up.

Each wrapper checks dtype, shape and device.  A CPU tensor runs the plain
version; a CUDA tensor launches the kernel (a non-contiguous input made
contiguous first); anything else raises.  A launch goes through
``kernels/build.py::launch_counted``, which counts it.  The C arguments of
a launch come from :func:`colour_matrix_call` and
:func:`delayline_matrix_call`, which ``kernels/sanitize.py`` launches from
too.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, check_delay_lines, delayline_mat3
from color_modem_tpu_torch.kernels.build import launch_counted


def colour_matrix_call(mat: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                       clamp: bool) -> tuple[list, tuple]:
    """The C arguments of ``colour_matrix`` but its stream: the tensors
    passed by pointer, in order, then the groups of three planes, the
    samples per plane and whether to clamp."""
    plane = x.shape[-2] * x.shape[-1]
    return [x, mat, out], (x.numel() // (3 * plane) if plane else 0, plane, int(clamp))


def _check(mat: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected float32, got {x.dtype}")
    if x.dim() < 3 or x.shape[-3] != 3:
        raise ValueError(f"x: expected (..., 3, L, N), got {tuple(x.shape)}")
    if tuple(mat.shape) != (3, 3):
        raise ValueError(f"mat: expected (3, 3), got {tuple(mat.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no colour-matrix kernel or plain version for device {x.device}")


def colour_matrix(mat: torch.Tensor, x: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """``y[..., d, l, n] = sum_c mat[d, c] * x[..., c, l, n]`` over
    ``(..., 3, L, N)`` float32, then clamped to [0, 1] with ``clamp`` (a NaN
    stays a NaN)."""
    _check(mat, x)
    dev = x.device
    if dev.type == "cpu":
        return apply_mat3(mat, x, clamp)
    x = x.contiguous()
    mat = mat.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel():
        launch_counted("colour_matrix", dev, colour_matrix_call(mat, x, out, clamp), out)
    return out


def delayline_matrix_call(mat: torch.Tensor, x: torch.Tensor,
                          out: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``delayline_matrix`` but its stream: the tensors
    passed by pointer, in order, then the groups of three planes, the lines
    and the samples per line."""
    lines, samples = x.shape[-2], x.shape[-1]
    plane = lines * samples
    return [x, mat, out], (x.numel() // (3 * plane) if plane else 0, lines, samples)


def delayline_matrix(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The delay-line decoders' last step over ``(..., 3, L, N)`` float32
    ``(Y, C1, C2)``: C1 and C2 of line ``l`` averaged with line ``l - 1``
    (line 0 with line 1), then ``mat`` applied and the result clamped to
    [0, 1] (a NaN stays a NaN).  A frame of one line has no neighbour:
    ``ValueError``."""
    _check(mat, x)
    dev = x.device
    if dev.type == "cpu":
        return delayline_mat3(mat, x)
    check_delay_lines(x)
    x = x.contiguous()
    mat = mat.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel():
        launch_counted("delayline_matrix", dev, delayline_matrix_call(mat, x, out), out)
    return out
