"""Time-base error: per-line horizontal jitter and its correction (TBC).

Port of ``color_modem_tpu/frame/timebase.py``, on the rastered signal
(``frame/raster.py``), which carries the sync edge a TBC locks to:

* :func:`impair_timebase`: per-line fractional-sample shifts, a vertical
  wobble sine, exponential top flagging and optional random jitter (from a
  JAX key, ``utils/prng.py``);
* :func:`measure_line_shift`: per-line delay from the blanking interval,
  the cross-spectrum against the nominal sync + burst template, read off
  as the angle of the adjacent-bin product (no unwrap);
* :func:`tbc_correct`: each line shifted back by its measured error.

Shifts are spectral phase ramps (circular), on ``torch.fft.rfft``/``irfft``
at the line's own length: the JAX package's real-DFT matmuls
(``dsp/rdft.py``) have the same DC and Nyquist semantics.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.frame.pipeline import resolve_device
from color_modem_tpu_torch.frame.raster import RasterPlan, add_raster
from color_modem_tpu_torch.utils import prng


def fractional_shift(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Shift each line of ``x`` (..., L, N) right by ``delta`` (..., L)
    samples, fractional and circular, by a spectral phase ramp."""
    n = x.shape[-1]
    X = torch.fft.rfft(x.to(torch.float32), dim=-1)
    xr, xi = X.real, X.imag
    k = torch.arange(n // 2 + 1, dtype=torch.float32, device=x.device)
    theta = f32(2.0 * np.pi / n) * k * delta[..., None].to(torch.float32)
    ct, st = torch.cos(theta), torch.sin(theta)
    # X' = X * (cos - i sin)(theta)
    out = torch.fft.irfft(torch.complex(xr * ct + xi * st, xi * ct - xr * st), n=n, dim=-1)
    return out.to(x.dtype)


def timebase_profile(plan, n_lines: int, *, wobble_us: float = 0.3,
                     wobble_cycles: float = 2.5, flagging_us: float = 0.0,
                     jitter_us: float = 0.0, key: prng.Key | None = None,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """(L,) per-line shift in samples on ``device`` (by default the card;
    without CUDA that raises, as the factories do): a wobble sine, the
    top-of-field flag (exponential decay over the first ~8% of lines) and
    white jitter, ``normal(key, (L,))`` (``jitter_us`` != 0 needs ``key``)."""
    device = resolve_device(device)
    l = torch.arange(n_lines, dtype=torch.float32, device=device)
    per_us = np.float32(plan.fs * 1e-6)
    delta = float(np.float32(wobble_us) * per_us) * torch.sin(
        f32(2.0 * np.pi * wobble_cycles) * l / f32(n_lines))
    if flagging_us != 0.0:
        delta = delta + float(np.float32(flagging_us) * per_us) * torch.exp(
            -l / f32(max(1.0, 0.08 * n_lines)))
    if jitter_us != 0.0:
        if key is None:
            raise ValueError("jitter_us > 0 requires a PRNG key")
        delta = delta + float(np.float32(jitter_us) * per_us) * prng.normal(
            key, (n_lines,), device)
    return delta


def impair_timebase(plan, rastered: torch.Tensor, **profile_kwargs):
    """Apply a time-base error to a (..., L, n_total) rastered block;
    returns ``(shifted, delta)``, ``delta`` the true per-line shifts."""
    delta = timebase_profile(plan, rastered.shape[-2], device=rastered.device,
                             **profile_kwargs)
    delta = delta.expand(rastered.shape[:-1])
    return fractional_shift(rastered, delta), delta


@lru_cache(maxsize=16)
def _guard(nb: int, max_shift: int, device: torch.device) -> torch.Tensor:
    guard = np.ones(nb, np.float32)
    guard[:max_shift] = 0.0
    guard[nb - max_shift:] = 0.0
    return torch.tensor(guard, device=device)


def measure_line_shift(plan, rp: RasterPlan, rastered: torch.Tensor, gline: torch.Tensor,
                       max_shift: int | None = None) -> torch.Tensor:
    """(..., L) per-line time-base error, in samples, from the blanking
    interval: ``C_k = R_k T_k*`` against the nominal template (sync and
    this line's burst), and the delay ``nb/(2 pi) angle(sum_k C_k
    C_{k+1}*)``, unambiguous for ``|d| < nb/2``.  The first and last
    ``max_shift`` samples of the window are zeroed (the circular shift
    wraps active video there); default :func:`correctable_reach`."""
    if max_shift is None:
        max_shift = correctable_reach(rp)
    if max_shift >= rp.sync_start:
        raise ValueError(
            f"max_shift {max_shift} exceeds the {rp.sync_start}-sample "
            "front porch (the guard would eat the sync edge)"
        )
    nb = rp.n_blank
    zeros = torch.zeros(*rastered.shape[:-1], rp.n_active, dtype=torch.float32,
                        device=rastered.device)
    guard = _guard(nb, max_shift, rastered.device)
    tmpl = add_raster(plan, rp, zeros, gline)[..., :nb] * guard
    recv = rastered[..., :nb].to(torch.float32) * guard
    R = torch.fft.rfft(recv, dim=-1)
    T = torch.fft.rfft(tmpl, dim=-1)
    rr, ri, tr, ti = R.real, R.imag, T.real, T.imag
    cr = rr * tr + ri * ti
    ci = ri * tr - rr * ti
    pr = torch.sum(cr[..., :-1] * cr[..., 1:] + ci[..., :-1] * ci[..., 1:], dim=-1)
    pi = torch.sum(ci[..., :-1] * cr[..., 1:] - cr[..., :-1] * ci[..., 1:], dim=-1)
    return f32(nb / (2.0 * np.pi)) * torch.atan2(pi, pr)


def tbc_correct(plan, rp: RasterPlan, rastered: torch.Tensor, gline: torch.Tensor,
                max_shift: int | None = None) -> torch.Tensor:
    """Time-base-correct a rastered block: measure each line's error and
    shift it back.  Shifts beyond ``max_shift`` are mis-estimated."""
    return fractional_shift(rastered, -measure_line_shift(plan, rp, rastered, gline, max_shift))


def correctable_reach(rp: RasterPlan) -> int:
    """Largest shift the single-line estimator can correct: an early line
    must not push the sync edge into the front guard, nor a late one the
    burst (or sync) tail past the blanking window's end."""
    used_end = (
        rp.burst_start + rp.burst_len if rp.burst_len
        else rp.sync_start + rp.sync_len
    )
    return max(1, min(rp.sync_start // 2, rp.n_blank - used_end))
