"""PSNR and content fingerprints on tensors, on the device that holds them.

Same definitions as ``color_modem_tpu/utils/metrics.py``: :func:`psnr`
takes the mean squared error in float64, so a device run reads the same dB
as a NumPy run of the same arrays to rounding; :func:`fingerprint` is the
torch form of ``fingerprint_jnp``.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

# the serial first call of each MKL-backed function (``dsp/__init__.py``)
# before the fingerprint's ``torch.cos``
import color_modem_tpu_torch.dsp  # noqa: F401


def mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.mean((a.to(torch.float64) - b.to(torch.float64)) ** 2))


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> float:
    """Peak SNR in dB; +inf for identical inputs."""
    m = mse(a, b)
    if m == 0.0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / m)


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """(2,) float32 content fingerprint, computed on ``x``'s device.

    Two pseudo-random-weighted sums, enough to tell a corrupted or mixed-up
    chunk in the resume manifest without moving the output to the host.
    Not cryptographic.  The weight phase comes from an int32 index reduced
    mod a prime: a float32 index would collapse neighbouring elements above
    2^24 (a 16-frame 576x720 chunk has 19.9M), while ``i % 7919`` stays
    exact and the coarse ``i // 7919`` term keeps distant segments apart.
    """
    f = x.to(torch.float32).reshape(-1)
    ii = torch.arange(f.numel(), dtype=torch.int32, device=f.device)
    lo = (ii % 7919).to(torch.float32)
    hi = torch.div(ii, 7919, rounding_mode="floor").to(torch.float32)
    s1 = torch.dot(f, torch.cos(lo * 1.7e-3 + hi * 0.61))
    s2 = torch.dot(f * f, torch.cos(lo * 0.9e-3 + hi * 1.13 + 1.0))
    return torch.stack([s1, s2])


def fingerprint_hex(fp) -> str:
    """Host side: (2,) float32 fingerprint -> stable 16-character hex."""
    a, b = (float(v) for v in np.asarray(fp))
    return struct.pack("<ff", a, b).hex()
