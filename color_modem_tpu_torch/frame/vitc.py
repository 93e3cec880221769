"""VITC: vertical interval timecode (SMPTE 12M-shaped).

Port of ``color_modem_tpu/frame/vitc.py``.  A 90-bit NRZ word: 9 groups of
10 bits, each a "1 0" sync pair then 8 payload bits; groups 0-7 carry 4
BCD timecode bits and 4 user bits, group 8 the CRC.  The CRC-8 has the
generator x^8 + 1, so its remainder is the message folded into 8 columns
by XOR.  Bits run at 115 fh.

There is no clock run-in: the decoder slices the line at 24 candidate
clock phases in one gather, scores each phase by its matched sync-pair
bits and keeps the first best phase (scores tie often, and the JAX package's
``argmax`` takes the first maximum, as ``torch.argmax`` does).  The
sampling indices of every phase are a host table, equal to the JAX
package's (``jnp.linspace`` phases in float32, rounded half to even).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_taps
from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.frame.pipeline import Plan

N_BITS = 90
N_GROUPS = 9
#: bit positions of the "1 0" sync pairs (start of each group)
SYNC_ONES = tuple(10 * g for g in range(N_GROUPS))
SYNC_ZEROS = tuple(10 * g + 1 for g in range(N_GROUPS))
#: leading guard before bit 0, as a fraction of the line
GUARD_FRAC = 0.02


def _crc8(bits82: np.ndarray) -> np.ndarray:
    """x^8 + 1 remainder: XOR-fold the message into 8 columns."""
    crc = np.zeros(8, dtype=np.int64)
    for k, b in enumerate(bits82):
        crc[k % 8] ^= int(b)
    return crc


def vitc_pack(hours: int, minutes: int, seconds: int, frames: int, *,
              drop_frame: bool = False, field: bool = False,
              user: tuple = (0,) * 8) -> np.ndarray:
    """Timecode -> the 90-bit VITC word (int64 host bits).  ``user``: 8
    binary-group nibbles; each nibble LSB first, the LTC convention."""
    if not (0 <= hours < 24 and 0 <= minutes < 60 and 0 <= seconds < 60
            and 0 <= frames < 60):
        raise ValueError(f"bad timecode {hours}:{minutes}:{seconds}:{frames}")
    digits = [
        frames % 10,
        (frames // 10) | (0x4 if drop_frame else 0),  # tens + drop-frame flag
        seconds % 10,
        seconds // 10 | (0x8 if field else 0),       # tens + field flag
        minutes % 10,
        minutes // 10,
        hours % 10,
        hours // 10,
    ]
    bits = np.zeros(N_BITS, dtype=np.int64)
    for g in range(8):
        base = 10 * g
        bits[base] = 1  # sync "1 0"
        for i in range(4):
            bits[base + 2 + i] = (digits[g] >> i) & 1
            bits[base + 6 + i] = (int(user[g]) >> i) & 1
    bits[80] = 1  # CRC group sync
    bits[82:90] = _crc8(bits[:82])
    return bits


def vitc_unpack(bits) -> dict:
    """90 received bits (host or device) -> the timecode and validity flags."""
    b = np.asarray(torch.as_tensor(bits).cpu().numpy(), dtype=np.int64)
    sync_ok = bool(np.all(b[list(SYNC_ONES)] == 1) and np.all(b[list(SYNC_ZEROS)] == 0))
    crc_ok = bool(np.all(_crc8(b[:82]) == b[82:90]))
    digits, user = [], []
    for g in range(8):
        base = 10 * g
        digits.append(int(sum(b[base + 2 + i] << i for i in range(4))))
        user.append(int(sum(b[base + 6 + i] << i for i in range(4))))
    return {
        "hours": (digits[7] & 0x3) * 10 + digits[6],
        "minutes": (digits[5] & 0x7) * 10 + digits[4],
        "seconds": (digits[3] & 0x7) * 10 + digits[2],
        "frames": (digits[1] & 0x3) * 10 + digits[0],
        "drop_frame": bool(digits[1] & 0x4),
        "field": bool(digits[3] & 0x8),
        "user": tuple(user),
        "sync_ok": sync_ok,
        "crc_ok": crc_ok,
    }


def _geometry_of(fh: float, fs: float, n: int) -> tuple[float, float]:
    spb = fs / (115.0 * fh)
    guard = GUARD_FRAC * n
    if guard + N_BITS * spb > n:
        raise ValueError(f"VITC needs {guard + N_BITS * spb:.0f} samples, line has {n}")
    return spb, guard


@lru_cache(maxsize=32)
def _encode_consts(fh: float, fs: float, n: int, device: torch.device):
    spb, guard = _geometry_of(fh, fs, n)
    cell = np.floor((np.arange(n, dtype=np.float64) - guard) / spb).astype(np.int64)
    return (torch.tensor(np.clip(cell, 0, N_BITS - 1), device=device),
            torch.tensor((cell >= 0) & (cell < N_BITS), device=device))


def encode_vitc_line(plan: Plan, bits, level: float = 0.8) -> torch.Tensor:
    """(..., 90) bits -> (..., N) VITC line waveform in luma units, on the
    bits' device (the host for an array)."""
    bits = torch.as_tensor(bits)
    if bits.shape[-1] != N_BITS:
        raise ValueError(f"expected {N_BITS} bits, got {bits.shape[-1]}")
    sel, in_pay = _encode_consts(plan.cfg.fh, plan.fs, plan.n_samples, bits.device)
    wave = torch.where(in_pay, bits[..., sel].to(torch.float32), 0.0) * f32(level)
    taps = design.lowpass_taps(plan.fs, 1.4 * 115.0 * plan.cfg.fh, 63)
    return fir_same_taps(wave, taps)


def _phase_grid(fh: float, fs: float, n: int, n_phases: int) -> np.ndarray:
    """(P, 90, K) int64 sample indices of every bit's integrate-and-dump
    window at every candidate phase, in the JAX package's float32 steps:
    ``round(guard + (k + 0.5) * spb + tau + off)``, ``tau`` spanning +- half
    a bit."""
    spb, guard = _geometry_of(fh, fs, n)
    taus = np.linspace(-0.5 * spb, 0.5 * spb, n_phases).astype(np.float32)
    centers = (np.float32(guard) + (np.arange(N_BITS, dtype=np.float32) + np.float32(0.5))
               * np.float32(spb))[None, :] + taus[:, None]
    offs = np.arange(-np.floor(0.3 * spb), np.floor(0.3 * spb) + 1.0, dtype=np.float32)
    return np.clip(np.round(centers[..., None] + offs), 0, n - 1).astype(np.int64)


@lru_cache(maxsize=32)
def _phase_grid_on(fh: float, fs: float, n: int, n_phases: int,
                   device: torch.device) -> torch.Tensor:
    return torch.tensor(_phase_grid(fh, fs, n, n_phases), device=device)


def decode_vitc_line(plan: Plan, line: torch.Tensor,
                     n_phases: int = 24) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) line -> ((..., 90) int32 bits, (...,) best sync score 0..18).

    Each phase's slicing threshold is the midpoint of its sync-'1' and
    sync-'0' cell means, so gain errors cancel; the phase with the most
    matched sync bits wins (the first such phase on a tie).
    """
    x = line.to(torch.float32)
    idx = _phase_grid_on(plan.cfg.fh, plan.fs, plan.n_samples, n_phases, x.device)
    vals = x[..., idx].mean(-1)                                  # (..., P, 90)
    # the sync bits by slices (SYNC_ONES, SYNC_ZEROS): an index list would
    # be a blocking upload on a card
    ones, zeros = slice(0, N_BITS, 10), slice(1, N_BITS, 10)
    hi = vals[..., ones].mean(-1, keepdim=True)
    lo = vals[..., zeros].mean(-1, keepdim=True)
    bits_p = (vals > 0.5 * (hi + lo)).to(torch.int32)
    score = bits_p[..., ones].sum(-1) + (1 - bits_p[..., zeros]).sum(-1)  # (..., P)
    best = torch.argmax(score, dim=-1, keepdim=True)
    bits = torch.take_along_dim(bits_p, best[..., None], dim=-2)[..., 0, :]
    return bits, torch.take_along_dim(score, best, dim=-1)[..., 0].to(torch.int32)


def timecode_for_frame(n: int, fps: int = 25) -> tuple:
    """Frame counter -> (h, m, s, f), non-drop."""
    return (n // (fps * 3600)) % 24, (n // (fps * 60)) % 60, (n // fps) % 60, n % fps
