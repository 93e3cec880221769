"""The line-axis comb stencil of the decoders 'comb2' and 'comb3': a wrapper of
``csrc/comb_stencil.cu``.

No Pallas kernel stands behind this: the JAX package computes the stencil
outside the decode kernel (``separate/comb.py::stencil_signal``), as plain
array code that XLA fuses.  The port's plain version,
``separate/comb.py::line_stencil``, is that composition on
``separate/stencil.py``'s shifts, whose flips and ``torch.cat`` copies, a
scale, two subtractions and a division make eight launches and some 14
planes of device traffic; the kernel reads the composite once and writes
the stencil signal once, bit for bit the same result.

It is CUDA C++ and not Triton: it is built into the one ``nvcc`` library
the port already loads (``kernels/build.py``), so it adds no JIT compile to
a run's set-up.

:func:`comb_stencil` checks dtype, shape and device.  A CPU tensor runs the
plain version; a CUDA tensor launches the kernel (a non-contiguous input
made contiguous first); anything else raises.  A launch goes through
``kernels/build.py::launch_counted``, which counts it.  The C arguments of
a launch come from :func:`comb_stencil_call`, which ``kernels/sanitize.py``
launches from too.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.kernels.build import launch_counted
from color_modem_tpu_torch.separate.comb import line_stencil

#: the decoders whose separation is this stencil, and the form the kernel takes
FORMS = {"comb2": 2, "comb3": 3}
#: the comb spacings the kernel takes (``standards/decoders.py::comb_spacing``)
SPACINGS = (1, 2)


def comb_stencil_call(x: torch.Tensor, out: torch.Tensor, p: int,
                      decoder: str) -> tuple[list, tuple]:
    """The C arguments of ``comb_stencil`` but its stream: the tensors passed
    by pointer, in order, then the frames, the lines, the samples per line,
    the spacing and the form (2 or 3)."""
    lines, samples = x.shape[-2], x.shape[-1]
    plane = lines * samples
    return [x, out], (x.numel() // plane if plane else 0, lines, samples, p, FORMS[decoder])


def _check(x: torch.Tensor, p: int, decoder: str) -> None:
    if decoder not in FORMS:
        raise ValueError(f"decoder: expected one of {tuple(FORMS)}, got {decoder!r}")
    if p not in SPACINGS:
        raise ValueError(f"p: expected one of {SPACINGS}, got {p}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"x: expected (..., L, N), got {tuple(x.shape)}")
    if x.shape[-2] < p + 1:
        raise ValueError(f"x: a comb at spacing {p} needs {p + 1} or more lines a frame, "
                         f"got {x.shape[-2]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no comb-stencil kernel or plain version for device {x.device}")


def comb_stencil(x: torch.Tensor, p: int, decoder: str) -> torch.Tensor:
    """The stencil signal of ``decoder`` ('comb2' or 'comb3') over the line
    axis of an ``(..., L, N)`` float32 composite at comb spacing ``p`` (1 or
    2), the edges reflected: ``(x[l] - x[l-p]) / 2`` or ``(2 x[l] - x[l-p] -
    x[l+p]) / 4``.  Fewer than ``p + 1`` lines a frame: ``ValueError``."""
    _check(x, p, decoder)
    dev = x.device
    if dev.type == "cpu":
        return line_stencil(x, p, decoder)
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        launch_counted("comb_stencil", dev, comb_stencil_call(x, out, p, decoder), out)
    return out
