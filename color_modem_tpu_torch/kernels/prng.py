"""The threefry2x32 generator: wrappers of ``csrc/threefry.cu`` and their
plain versions (``utils/prng.py``).

No Pallas kernel stands behind these: the JAX package draws its noise
through ``jax.random``, which XLA lowers to elementwise threefry2x32.  A
plain PyTorch threefry is some 150 elementwise passes over int64 tensors;
the kernel hashes, converts and adds in one pass.

* ``threefry_bits``: ``jax.random.bits(key, shape)``, uint32 words written
  into an int32 tensor; ``uniform``, ``bernoulli`` and ``randint`` build on
  it.
* ``threefry_add_normal``: ``x + sigma * normal(key_i, item shape)`` over
  the leading axis of ``shape``, ``key_i`` the key itself (one item: the
  whole shape) or ``fold_in(key, g0 + i)``, hashed once per block in the
  kernel; with ``x`` None, ``normal`` alone.

A CPU device runs the plain version; a CUDA device launches the kernel or
raises; anything else raises.  A launch goes through
``kernels/build.py::launch_counted``, which counts it.  The C arguments
come from :func:`bits_call` and :func:`normal_call`, which
``kernels/sanitize.py`` launches from too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from color_modem_tpu_torch.kernels.build import launch_counted
from color_modem_tpu_torch.utils.prng import M32, Key, add_normal_plain, random_bits_plain

#: the kernel's grid has one row of blocks per item
MAX_ITEMS = 65535


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no threefry kernel or plain version for device {device}")
    return device


def bits_call(key: Key, out: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``threefry_bits`` but its stream: the output's
    pointer, then the key's words and the number of words."""
    return [out], (key.k0, key.k1, out.numel())


def threefry_bits(key: Key, shape: tuple, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as int32 of the same bits."""
    device = _device(device)
    if device.type == "cpu":
        return random_bits_plain(key, shape, device)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if out.numel():
        launch_counted("threefry_bits", device, bits_call(key, out), out)
    return out


def normal_call(x: torch.Tensor | None, sigma: float, key: Key, g0: int | None,
                out: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``threefry_add_normal`` but its stream: ``x``
    (None: no addend) and the output, then the key's words, whether to
    fold, ``g0`` mod 2^32, ``sigma``, the words per item and the items."""
    items = 1 if g0 is None else out.shape[0]
    return [x, out], (key.k0, key.k1, int(g0 is not None), (g0 or 0) & M32,
                      float(np.float32(sigma)), out.numel() // max(items, 1), items)


def threefry_add_normal(x: torch.Tensor | None, sigma: float, key: Key, shape: tuple,
                        device, g0: int | None = None) -> torch.Tensor:
    """``x + float32(sigma) * normal`` over ``shape`` (``x`` None: the
    normal alone), the normal keyed by ``key`` or, with ``g0``, item ``i``
    of the leading axis by ``fold_in(key, g0 + i)``."""
    device = _device(device)
    if x is not None:
        if x.dtype != torch.float32:
            raise TypeError(f"x: expected float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape) or x.device != device:
            raise ValueError(f"x: {tuple(x.shape)} on {x.device}, expected {shape} on {device}")
    if g0 is not None and len(shape) == 0:
        raise ValueError("per-item keys need a leading axis of items")
    if device.type == "cpu":
        return add_normal_plain(x, sigma, key, shape, device, g0)
    if g0 is not None and shape[0] > MAX_ITEMS:
        raise ValueError(f"{shape[0]} items: the kernel takes at most {MAX_ITEMS}")
    if x is not None:
        x = x.contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if math.prod(shape):
        launch_counted("threefry_add_normal", device,
                       normal_call(x, sigma, key, g0, out), out)
    return out
