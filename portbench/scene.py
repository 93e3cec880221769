"""The benchmark's frames: a band-limited scene from the seed, and frames
made from it on the device by roll and gain.

Copies of the program's generators (``utils/testimages.py::smooth_scene``
and ``frame/video.py::synthetic_device_source``), so the traffic cannot
change with the program: frame ``h`` is the scene rolled by ``(37 h) mod
N`` samples, times ``0.85 + 0.1 cos(0.37 h)`` in float32, plus 0.05,
clipped to [0, 1].  Every seed gives frames of the same size and range,
so a seed changes the content and never the work.
"""

from __future__ import annotations

import numpy as np
import torch


def smooth_scene(n_lines: int, n_samples: int, seed: int) -> np.ndarray:
    """(3, L, N) float64 random field low-passed well inside the chroma
    bands, scaled to [0.1, 0.9]."""
    img = np.random.default_rng(seed).random((3, n_lines, n_samples))
    for axis, keep in ((1, max(2, n_lines // 16)), (2, max(2, n_samples // 32))):
        spec = np.fft.rfft(img, axis=axis)
        sl = [slice(None)] * 3
        sl[axis] = slice(keep, None)
        spec[tuple(sl)] = 0.0
        img = np.fft.irfft(spec, n=img.shape[axis], axis=axis)
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return 0.1 + 0.8 * img


class Scene:
    """Frames of one seed's scene on ``device``."""

    def __init__(self, n_lines: int, n_samples: int, seed: int, device):
        self.device = torch.device(device)
        self.base = torch.tensor(smooth_scene(n_lines, n_samples, seed),
                                 dtype=torch.float32, device=self.device)
        self.cols = torch.arange(n_samples, device=self.device)

    def frames(self, first: int, count: int) -> torch.Tensor:
        """(count, 3, L, N) float32 frames ``first .. first + count``, made
        by one gather, with no copy from the host."""
        n = self.cols.numel()
        h = torch.arange(first, first + count, device=self.device)
        src = torch.remainder(self.cols[None, :] - (h[:, None] * 37) % n, n)
        rolled = self.base[:, :, src].permute(2, 0, 1, 3)
        gain = 0.85 + 0.1 * torch.cos(0.37 * h.to(torch.float32))
        return torch.clamp(rolled * gain[:, None, None, None] + 0.05, 0.0, 1.0)
