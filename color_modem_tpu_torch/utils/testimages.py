"""Synthetic test images: the port's copy of ``smooth_scene`` from
``color_modem_tpu/utils/testimages.py`` (the same NumPy code, so the same
seed gives the same image, ``tests/test_torch_standards.py``)."""

from __future__ import annotations

import numpy as np


def smooth_scene(n_lines: int, n_samples: int, seed: int = 0) -> np.ndarray:
    """(3, L, N) band-limited pseudo-natural scene.

    Random field low-passed well inside the chroma bandwidths, so round-trip
    loss is dominated by the modem, not by unrepresentable detail.
    """
    rng = np.random.default_rng(seed)
    img = rng.random((3, n_lines, n_samples))
    # separable box-ish smoothing via FFT low-pass
    for axis, keep in ((1, max(2, n_lines // 16)), (2, max(2, n_samples // 32))):
        spec = np.fft.rfft(img, axis=axis)
        sl = [slice(None)] * 3
        sl[axis] = slice(keep, None)
        spec[tuple(sl)] = 0.0
        img = np.fft.irfft(spec, n=img.shape[axis], axis=axis)
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return 0.1 + 0.8 * img  # stay away from clamp rails
