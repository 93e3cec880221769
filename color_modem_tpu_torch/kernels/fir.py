"""FIRs on their own: the SIMT FIR of ``csrc/fir.cuh``
(``csrc/fir_check.cu``; its zero and held edges are the ones the SECAM
kernels' staging matches) and the tensor-core FIR of ``csrc/band_fir.cuh``
(the QAM kernels' form; ``csrc/band_fir_check.cu``).

No pipeline path calls these: they exist so that a card test can hold each
FIR against ``np.convolve(mode='same')`` on asymmetric taps (zero and held
edges for the first, zero edges, spans and ragged tiles of lines for the
second).  A CPU tensor runs the plain version (the Toeplitz matmul); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from color_modem_tpu_torch.dsp.apply import matmul_f32, toeplitz_same, toeplitz_same_held
from color_modem_tpu_torch.kernels.build import launch_counted
from color_modem_tpu_torch.kernels.tiles import band_tiles


def fir_lines_plain(x: torch.Tensor, taps: torch.Tensor, held: bool) -> torch.Tensor:
    """Plain version of :func:`fir_lines`."""
    build = toeplitz_same_held if held else toeplitz_same
    mat = build(taps.detach().cpu().numpy().astype(np.float64), x.shape[-1])
    return matmul_f32(x, torch.tensor(mat, device=x.device))


def _check(x: torch.Tensor, taps: torch.Tensor) -> None:
    if x.dim() != 2 or taps.dim() != 1 or taps.numel() % 2 != 1:
        raise ValueError(
            f"x (lines, N) and odd taps (T,) expected, got {tuple(x.shape)}, "
            f"{tuple(taps.shape)}"
        )
    for name, t in (("x", x), ("taps", taps)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: expected contiguous float32 on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no FIR kernel or plain version for device {x.device}")


def fir_lines(x: torch.Tensor, taps: torch.Tensor, held: bool = False) -> torch.Tensor:
    """(lines, N) float32 -> each line convolved 'same' with ``taps`` (T,),
    T odd, by ``csrc/fir.cuh``; ``held`` repeats the edge samples instead of
    zero padding."""
    _check(x, taps)
    if x.device.type == "cpu":
        return fir_lines_plain(x, taps, held)
    out = torch.empty_like(x)
    launch_counted("fir_check", x.device,
                   ([x, taps, out], (*x.shape, taps.numel(), int(held))), out)
    return out


def band_fir_lines(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(lines, N) float32 -> each line convolved 'same' (zero edges) with
    ``taps`` (T,), T odd, by the tensor-core FIR of ``csrc/band_fir.cuh``;
    its band tiles are built here on the host from the float32 taps."""
    _check(x, taps)
    if x.device.type == "cpu":
        return fir_lines_plain(x, taps, False)
    tiles = torch.tensor(band_tiles(taps.detach().cpu().numpy()), device=x.device)
    out = torch.empty_like(x)
    launch_counted("band_fir_check", x.device,
                   ([x, tiles, out], (*x.shape, taps.numel())), out)
    return out
