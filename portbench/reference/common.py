"""The reference's arithmetic: precisions, 'same' FIRs and colour matrices.

Plain PyTorch, on any device, in the precision a :class:`Precision` names.
The reference runs in float64.  The control, the reference computed one
step below the configuration's float32 with TF32 off, runs in float32 with
every FIR and colour-matrix product in TF32: each operand rounded to TF32's
10-bit mantissa (round to nearest, ties away, as the tensor cores convert)
and the product summed in float32, so the control means the same on the CPU
and on the card.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class Precision:
    """``dtype`` of every operation; ``tf32``: FIR and matrix operands are
    rounded to TF32 before their products."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``x`` in the working dtype, TF32-rounded where the precision says."""
    if x.is_complex():
        if not prec.tf32:
            return x.to(prec.cdtype)
        return torch.complex(tf32_round(x.real.to(torch.float32)),
                             tf32_round(x.imag.to(torch.float32)))
    x = x.to(prec.dtype)
    return tf32_round(x) if prec.tf32 else x


@contextlib.contextmanager
def ieee_matmul():
    """float32 products in full float32 inside the block: the control's
    operands are TF32 already, and must not be rounded again elsewhere."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def toeplitz(taps: np.ndarray, n: int) -> np.ndarray:
    """(n, n) float64 M with ``x @ M == np.convolve(x, taps, 'same')`` for
    odd ``taps``: ``M[j, i] = taps[i + h - j]``."""
    t = len(taps)
    h = (t - 1) // 2
    j = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    k = i + h - j
    ok = (k >= 0) & (k < t)
    return np.where(ok, np.asarray(taps, np.float64)[np.clip(k, 0, t - 1)], 0.0)


def fir(x: torch.Tensor, taps: np.ndarray, prec: Precision) -> torch.Tensor:
    """'Same' convolution with zero edges along the last axis, as a product
    with the taps' Toeplitz matrix."""
    m = operand(torch.from_numpy(toeplitz(taps, x.shape[-1])).to(x.device), prec)
    with ieee_matmul():
        return operand(x, prec) @ m


def fir_held(x: torch.Tensor, taps: np.ndarray, prec: Precision) -> torch.Tensor:
    """'Same' convolution whose edges hold the first and last samples."""
    h = (len(taps) - 1) // 2
    n = x.shape[-1]
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], h), x,
                    x[..., -1:].expand(*x.shape[:-1], h)], dim=-1)
    return fir(xp, taps, prec)[..., h:h + n]


def fft_fir(x: torch.Tensor, taps: np.ndarray, prec: Precision) -> torch.Tensor:
    """'Same' convolution of long real streams (..., T) with real or complex
    ``taps`` by one zero-padded transform of the whole stream; complex
    output where the taps are complex."""
    t = len(taps)
    h = (t - 1) // 2
    n_in = x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(n_in + t - 1)))
    xs = operand(x, prec)
    k = operand(torch.from_numpy(np.asarray(taps)).to(x.device), prec)
    if k.is_complex():
        y = torch.fft.ifft(torch.fft.fft(xs, nfft) * torch.fft.fft(k, nfft))
    else:
        y = torch.fft.irfft(torch.fft.rfft(xs, nfft) * torch.fft.rfft(k, nfft), nfft)
    return y[..., h:h + n_in]


def mat3(mat: np.ndarray, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``y[..., d, l, n] = sum_c mat[d, c] x[..., c, l, n]``."""
    m = operand(torch.from_numpy(np.asarray(mat, np.float64)).to(x.device), prec)
    xs = operand(x, prec)
    return (m[:, 0, None, None] * xs[..., 0:1, :, :] + m[:, 1, None, None] * xs[..., 1:2, :, :]
            + m[:, 2, None, None] * xs[..., 2:3, :, :])


def reflect(idx: np.ndarray, n: int) -> np.ndarray:
    """Line indices reflected into [0, n): -1 -> 1, n -> n - 2."""
    idx = np.where(idx < 0, -idx, idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def line_index(frames, n_lines: int, total_lines: int, device) -> torch.Tensor:
    """(B, L) int64 absolute line index ``frame * total_lines + line``."""
    f = torch.as_tensor(np.asarray(frames, np.int64), device=device)
    return f[:, None] * int(total_lines) + torch.arange(n_lines, device=device)[None, :]
