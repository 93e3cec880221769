"""Closed-form subcarrier NCO: the phase is a function of the absolute line
index, so lines need no sequential state.

    phi[g, n] = phi0(g) + ramp[n]
    phi0(g)   = 2*pi * frac(cpl * g)          (line-start phase)
    ramp[n]   = 2*pi * frac(fsc/fs * n)       (within-line ramp)

``cpl = cpl_num / cpl_den`` is exact, so ``frac(cpl * g)`` is computed in
int32 modular arithmetic.  Float32 phase accumulation would lose the phase
after about 1e5 lines.  Port of ``color_modem_tpu/dsp/nco.py``; results are
bit-equal to it (tests/test_torch_plan.py).
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


def f32(v: float) -> float:
    """A Python float holding the float32 rounding of ``v``: adding it to a
    float32 tensor matches JAX's ``+ jnp.float32(v)`` bit for bit."""
    return float(np.float32(v))


def line_phase0(cpl_num: int, cpl_den: int, gline: torch.Tensor) -> torch.Tensor:
    """Line-start subcarrier phase in radians (float32) for int line indices.

    With ``cpl_den`` <= 46340 the product ``(num % den) * (g % den)`` stays
    below 2^31, so int32 is exact.  ``torch.remainder`` is a floor modulo,
    like ``jnp.mod``.
    """
    den = int(cpl_den)
    num_mod = int(cpl_num) % den
    g_mod = torch.remainder(gline.to(torch.int32), den)
    r = torch.remainder(g_mod * num_mod, den)
    return r.to(torch.float32) * f32(TWO_PI / den)


def sample_phase_ramp(fsc: float, fs: float, n_samples: int) -> np.ndarray:
    """Within-line phase ramp 2*pi*frac(fsc/fs * n) — float64 host constant."""
    n = np.arange(n_samples, dtype=np.float64)
    frac = np.mod(fsc / fs * n, 1.0)
    return TWO_PI * frac


def frame_indices(frame0, n_frames: int, device: torch.device | str) -> torch.Tensor:
    """(n_frames,) int32 frame numbers frame0, frame0 + 1, ...  ``frame0`` is
    an int or a tensor; an int is not copied to the device (a blocking copy
    that would stall the host on every batch)."""
    if isinstance(frame0, torch.Tensor):
        return (torch.arange(n_frames, dtype=torch.int32, device=device)
                + frame0.to(device=device, dtype=torch.int32))
    return torch.arange(int(frame0), int(frame0) + n_frames, dtype=torch.int32, device=device)


def global_line_index(
    frame0, n_frames: int, n_lines: int, total_lines: int,
    device: torch.device | str,
) -> torch.Tensor:
    """Absolute line index g[b, l] = (frame0 + b) * total_lines + l, int32."""
    b = frame_indices(frame0, n_frames, device)
    l = torch.arange(n_lines, dtype=torch.int32, device=device)
    return b[:, None] * int(total_lines) + l[None, :]
