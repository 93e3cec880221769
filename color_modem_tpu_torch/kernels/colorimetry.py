"""The round trip's colour matrices: wrappers of ``csrc/colour_matrix.cu``
and their plain versions.

No Pallas kernel stands behind this: the JAX package's
``dsp/colorimetry.py::apply_mat3`` is an einsum that XLA fuses with the
decoder's clamp.  The plain version is a product and two strided
``addcmul_`` (the non-contiguous single-plane slices fall to PyTorch's
non-vectorised elementwise kernel), then a separate ``clamp``: 18 planes
of device traffic per matrix and 6 more for the clamp.  The kernel reads
the three planes once and writes three, the clamp inside the same pass.

:func:`delayline_matrix` is the decoder's pass of the delay-line decoders
(``frame/pipeline.py::AVERAGING``): C1 and C2 averaged with the line before
(``separate/delayline.py::average_with_neighbor``), then the decoder's
matrix and clamp.  Its plain version is that composition: two averages, a
``torch.stack`` and :func:`colour_matrix_plain`, some 20 planes of traffic
in nine launches before the matrix's; the kernel reads three planes and
writes three, bit for bit the same result.

They are CUDA C++ and not Triton: they are built into the one ``nvcc``
library the port already loads (``kernels/build.py``), so they add no JIT
compile to a run's set-up.

Each wrapper checks dtype, shape and device.  A CPU tensor runs the plain
version; a CUDA tensor launches the kernel (a non-contiguous input made
contiguous first); anything else raises.  ``LAUNCHES`` counts kernel
launches, and only those.  The C arguments of a launch come from
:func:`colour_matrix_call` and :func:`delayline_matrix_call`, which
``kernels/sanitize.py`` launches from too.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.kernels.build import launch_counted
from color_modem_tpu_torch.separate.delayline import average_with_neighbor

#: launches of the CUDA kernels in this process (not of the plain versions)
LAUNCHES = {"colour_matrix": 0, "delayline_matrix": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def colour_matrix_plain(mat: torch.Tensor, x: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """Plain version of :func:`colour_matrix`: three scaled adds of the
    input planes in the order c = 0, 1, 2, in elementwise arithmetic (no
    matrix product, so no process-wide matmul precision setting can change
    it), then ``torch.clamp(y, 0, 1)`` with ``clamp``."""
    m = mat.to(device=x.device, dtype=x.dtype).reshape(3, 3, 1, 1)
    y = x[..., 0:1, :, :] * m[:, 0]
    y.addcmul_(x[..., 1:2, :, :], m[:, 1])
    y.addcmul_(x[..., 2:3, :, :], m[:, 2])
    return torch.clamp(y, 0.0, 1.0) if clamp else y


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
        return colour_matrix_plain(mat, x, clamp)
    x = x.contiguous()
    mat = mat.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel():
        launch_counted(LAUNCHES, "colour_matrix", dev, colour_matrix_call(mat, x, out, clamp),
                       out)
    return out


def _check_lines(x: torch.Tensor) -> None:
    if x.shape[-2] < 2:
        raise ValueError(f"x: the delay line needs 2 or more lines a frame, got {x.shape[-2]}")


def delayline_matrix_plain(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`delayline_matrix`: the composition the
    pipeline ran, ``average_with_neighbor`` on C1 and on C2, the stack, and
    :func:`colour_matrix_plain` with the clamp."""
    _check_lines(x)
    y, c1, c2 = x.unbind(-3)
    ycc = torch.stack([y, average_with_neighbor(c1), average_with_neighbor(c2)], dim=-3)
    return colour_matrix_plain(mat, ycc, clamp=True)


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
        return delayline_matrix_plain(mat, x)
    _check_lines(x)
    x = x.contiguous()
    mat = mat.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel():
        launch_counted(LAUNCHES, "delayline_matrix", dev, delayline_matrix_call(mat, x, out),
                       out)
    return out
