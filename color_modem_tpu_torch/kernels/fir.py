"""The shared FIR of ``csrc/fir.cuh`` on its own (``csrc/fir_check.cu``).

No pipeline path calls this: it exists so that a card test can hold the
FIR every kernel is built from against ``np.convolve(mode='same')`` on
asymmetric taps, with zero and with held edges.  A CPU tensor runs the
plain version (the Toeplitz matmul); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from color_modem_tpu_torch.dsp.apply import toeplitz_same, toeplitz_same_held

#: launches of the CUDA kernel in this process
LAUNCHES = {"fir_check": 0}


def fir_lines_plain(x: torch.Tensor, taps: torch.Tensor, held: bool) -> torch.Tensor:
    """Plain version of :func:`fir_lines`."""
    build = toeplitz_same_held if held else toeplitz_same
    mat = build(taps.detach().cpu().numpy().astype(np.float64), x.shape[-1])
    return torch.matmul(x, torch.tensor(mat, device=x.device))


def fir_lines(x: torch.Tensor, taps: torch.Tensor, held: bool = False) -> torch.Tensor:
    """(lines, N) float32 -> each line convolved 'same' with ``taps`` (T,),
    T odd; ``held`` repeats the edge samples instead of zero padding."""
    if x.dim() != 2 or taps.dim() != 1 or taps.numel() % 2 != 1:
        raise ValueError(
            f"x (lines, N) and odd taps (T,) expected, got {tuple(x.shape)}, "
            f"{tuple(taps.shape)}"
        )
    for name, t in (("x", x), ("taps", taps)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: expected contiguous float32 on {x.device}")
    if x.device.type == "cpu":
        return fir_lines_plain(x, taps, held)
    if x.device.type != "cuda":
        raise ValueError(f"no FIR kernel or plain version for device {x.device}")
    from color_modem_tpu_torch.kernels.build import load_library

    out = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fir_check(x.data_ptr(), taps.data_ptr(), out.data_ptr(),
                            x.shape[0], x.shape[1], taps.numel(), int(held), stream)
    if err != 0:
        raise RuntimeError(f"fir_check: CUDA launch failed with cudaError_t {err}")
    LAUNCHES["fir_check"] += 1
    return out
