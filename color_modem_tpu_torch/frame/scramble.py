"""Analog pay-TV scrambling of the composite: three keyed, invertible systems.

Port of ``color_modem_tpu/frame/scramble.py``:

* **cut-and-rotate** (Videocrypt): each line is cut at a keyed point and
  the two segments swapped (a circular rotation of the line);
* **line delay** (Discret 11): each line is delayed by one of three keyed
  delays (0 / 902 / 1804 ns), circularly within the line;
* **line shuffle** (Nagravision Syster): lines are permuted within windows
  of 32 by a keyed permutation.

Each system is one gather per block, keyed by a closed-form integer hash of
``(key, absolute line index)``: no sequential state, so chunks are
independent, and descrambling is bit-exact (gathers move samples, they
never touch their values).

The hash is the JAX package's uint32 arithmetic, carried in int64: CUDA
has no ``*``, ``>>`` or ``%`` for ``torch.uint32``.  A 32-bit by 32-bit
product would overflow int64, so :func:`_mul32` multiplies by the
constant's two 16-bit halves and keeps the low 32 bits; no intermediate
reaches 2^49.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.frame.pipeline import Plan

MODES = ("cutrotate", "linedelay", "shuffle")

#: Discret 11's three delay taps, nanoseconds
DELAY_TAPS_NS = (0.0, 902.0, 1804.0)
#: Nagravision-style permutation window, lines
SHUFFLE_WINDOW = 32

_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit
    constant ``c``, without overflowing int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(gline: torch.Tensor, key: int) -> torch.Tensor:
    """Keyed integer hash of absolute line indices -> int64 in [0, 2^32):
    two rounds of multiply-xorshift (Murmur3's finalizer structure), the
    same value as the JAX package's uint32 hash on every device."""
    h = _mul32(gline.to(torch.int64) & _MASK32, 2654435761)
    h = h ^ (key & _MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _rotate_lines(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Per-line circular rotation: ``out[..., l, i] = x[..., l, (i + shift[l])
    mod N]`` (a floor modulo, so a negative shift rotates the other way)."""
    n = x.shape[-1]
    idx = torch.remainder(torch.arange(n, device=x.device) + shift[..., None], n)
    return torch.gather(x, -1, idx.expand(x.shape))


def _cut_points(plan: Plan, gline: torch.Tensor, key: int) -> torch.Tensor:
    """Keyed cut points in [N/8, 7N/8): the cut stays away from the line
    edges, as the real system's did."""
    n = plan.n_samples
    return n // 8 + torch.remainder(_hash32(gline, key), 3 * n // 4)


@lru_cache(maxsize=32)
def _delay_taps(fs: float, device: torch.device) -> torch.Tensor:
    taps = np.round(np.asarray(DELAY_TAPS_NS) * 1e-9 * fs).astype(np.int64)
    return torch.tensor(taps, device=device)


def _delay_samples(plan: Plan, gline: torch.Tensor, key: int) -> torch.Tensor:
    return _delay_taps(plan.fs, gline.device)[torch.remainder(_hash32(gline, key), 3)]


def _shuffle_perm(gline: torch.Tensor, key: int) -> torch.Tensor:
    """(..., L) keyed permutation within windows of SHUFFLE_WINDOW lines:
    the stable argsort of the line hash inside each window (ties keep the
    index order, the same everywhere, so the permutation inverts exactly)."""
    l = gline.shape[-1]
    if l % SHUFFLE_WINDOW:
        raise ValueError(f"shuffle needs the line count divisible by {SHUFFLE_WINDOW}, got {l}")
    win = _hash32(gline, key).reshape(gline.shape[:-1] + (l // SHUFFLE_WINDOW, SHUFFLE_WINDOW))
    perm = torch.argsort(win, dim=-1, stable=True)
    base = torch.arange(0, l, SHUFFLE_WINDOW, device=gline.device)[:, None]
    return (perm + base).reshape(gline.shape)


def _invert_perm(perm: torch.Tensor) -> torch.Tensor:
    return torch.argsort(perm, dim=-1, stable=True)


def _permute_lines(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[..., l, :] = x[..., perm[l], :]``."""
    return torch.gather(x, -2, perm[..., None].expand(x.shape))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def scramble(plan: Plan, comp: torch.Tensor, gline: torch.Tensor, mode: str, key: int,
             active_start: int = 0) -> torch.Tensor:
    """Scramble a (..., L, N) composite block (keyed, exactly invertible).

    ``active_start``: the first active sample of each row (the raster's
    ``n_blank`` for rastered lines): the picture region scrambles while sync
    and burst stay in the clear, so a receiver still locks.  Rotation and
    delay then act circularly within the active region; shuffle permutes
    the active parts between lines while each line keeps its blanking."""
    _check_mode(mode)
    comp = comp.to(torch.float32)
    if active_start:
        act = scramble(plan, comp[..., active_start:], gline, mode, key)
        return torch.cat([comp[..., :active_start], act], dim=-1)
    if mode == "cutrotate":
        return _rotate_lines(comp, _cut_points(plan, gline, key))
    if mode == "linedelay":
        return _rotate_lines(comp, -_delay_samples(plan, gline, key))
    return _permute_lines(comp, _shuffle_perm(gline, key))


def descramble(plan: Plan, comp: torch.Tensor, gline: torch.Tensor, mode: str, key: int,
               active_start: int = 0) -> torch.Tensor:
    """Exact inverse of :func:`scramble` under the same key."""
    _check_mode(mode)
    comp = comp.to(torch.float32)
    if active_start:
        act = descramble(plan, comp[..., active_start:], gline, mode, key)
        return torch.cat([comp[..., :active_start], act], dim=-1)
    if mode == "cutrotate":
        return _rotate_lines(comp, -_cut_points(plan, gline, key))
    if mode == "linedelay":
        return _rotate_lines(comp, _delay_samples(plan, gline, key))
    return _permute_lines(comp, _invert_perm(_shuffle_perm(gline, key)))
