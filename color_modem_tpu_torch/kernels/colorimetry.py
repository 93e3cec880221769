"""The round trip's colour matrices: a wrapper of ``csrc/colour_matrix.cu``
and its plain version.

No Pallas kernel stands behind this: the JAX package's
``dsp/colorimetry.py::apply_mat3`` is an einsum that XLA fuses with the
decoder's clamp.  The plain version is a product and two strided
``addcmul_`` (the non-contiguous single-plane slices fall to PyTorch's
non-vectorised elementwise kernel), then a separate ``clamp``: 18 planes
of device traffic per matrix and 6 more for the clamp.  The kernel reads
the three planes once and writes three, the clamp inside the same pass.

It is CUDA C++ and not Triton: it is built into the one ``nvcc`` library
the port already loads (``kernels/build.py``), so it adds no JIT compile
to a run's set-up.

:func:`colour_matrix` checks dtype, shape and device.  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel (a non-contiguous
input made contiguous first); anything else raises.  ``LAUNCHES`` counts
kernel launches, and only those.  The C arguments of a launch come from
:func:`colour_matrix_call`, which ``kernels/sanitize.py`` launches from
too.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.kernels.build import launch_counted

#: launches of the CUDA kernel in this process (not of the plain version)
LAUNCHES = {"colour_matrix": 0}


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


def colour_matrix(mat: torch.Tensor, x: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """``y[..., d, l, n] = sum_c mat[d, c] * x[..., c, l, n]`` over
    ``(..., 3, L, N)`` float32, then clamped to [0, 1] with ``clamp`` (a NaN
    stays a NaN)."""
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected float32, got {x.dtype}")
    if x.dim() < 3 or x.shape[-3] != 3:
        raise ValueError(f"x: expected (..., 3, L, N), got {tuple(x.shape)}")
    if tuple(mat.shape) != (3, 3):
        raise ValueError(f"mat: expected (3, 3), got {tuple(mat.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return colour_matrix_plain(mat, x, clamp)
    if dev.type != "cuda":
        raise ValueError(f"no colour-matrix kernel or plain version for device {dev}")
    x = x.contiguous()
    mat = mat.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    if out.numel():
        launch_counted(LAUNCHES, "colour_matrix", dev, colour_matrix_call(mat, x, out, clamp),
                       out)
    return out
