"""Resampling along the sample axis: image width <-> composite sample grid.

Port of ``color_modem_tpu/dsp/resample.py``.  Resampling is a linear map,
so it is one float32 matmul against the host-designed ``(n_in, n_out)``
windowed-sinc matrix of :func:`design.resample_matrix`; anti-aliasing for
decimation is built into the matrix.  The JAX package runs this product
outside any Pallas kernel, and so does the port, in full float32 whatever
the process-wide matmul precision (``dsp/apply.py::matmul_f32``).  The
matrix is dense although only 17 taps per output are non-zero.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from color_modem_tpu_torch.dsp.apply import matmul_f32
from color_modem_tpu_torch.dsp.design import resample_matrix


@lru_cache(maxsize=32)
def _matrix(n_in: int, n_out: int, taps_per_output: int,
            device: torch.device) -> torch.Tensor:
    """The resampling matrix on ``device``, uploaded once per shape."""
    return torch.tensor(resample_matrix(n_in, n_out, taps_per_output), device=device)


def resample_width(x: torch.Tensor, n_out: int, taps_per_output: int = 17) -> torch.Tensor:
    """Resample the last (sample) axis of ``x`` to ``n_out`` points; ``x``
    itself when the width already is ``n_out``."""
    n_in = x.shape[-1]
    if n_in == n_out:
        return x
    mat = _matrix(n_in, n_out, taps_per_output, x.device)
    return matmul_f32(x.to(torch.float32), mat)
