"""Vertical-interval data lines: caption-style NRZ data on a picture row.

Port of ``color_modem_tpu/frame/vbi.py``.  A data line is

    [ run-in: ``run_in_cycles`` of a raised sine at f_bit ][ start bits ]
    [ n_bits NRZ bits, each 1/f_bit ]  ...rest of the line at 0

(or, with ``run_in_alt``, the alternating 1010... run-in of real WST),
band-limited by a host-designed FIR, in luma units (0 = black, ``level`` =
data high).  The decoder correlates the run-in against the clock in
quadrature to recover the bit clock's phase and amplitude, then integrates
and dumps each bit.  Every row of a ``(..., N)`` batch decodes at once.

The float32 arithmetic follows the JAX package's order: the bit centres
are ``run_in + (n_start + k + 0.5) * spb`` (rounded as the JAX package
rounds them), plus the recovered timing, then rounded half to even.  The
run-in's sine and cosine tables are the float64 values of the float32
angles, rounded once (JAX evaluates them in float32 on the device).  The
geometry and tables upload once per (plan, spec, device).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_taps
from color_modem_tpu_torch.dsp.nco import TWO_PI, f32
from color_modem_tpu_torch.frame.pipeline import Plan


@dataclasses.dataclass(frozen=True)
class DataLineSpec:
    """Geometry of one data line on the active-sample grid."""

    f_bit: float          # bit rate, Hz (and run-in sine frequency)
    n_bits: int           # payload bits per line
    run_in_cycles: int    # clock run-in length, cycles of the run-in tone
    level: float          # data "1" amplitude in luma units
    start_bits: tuple     # framing pattern between run-in and payload
    #: False: a sine burst AT f_bit (EIA-608's line-21 run-in); True: the
    #: alternating 1010... NRZ run-in of real WST, whose fundamental is at
    #: f_bit/2 and one cycle of which spans two bit periods, with
    #: 100% cosine roll-off pulse shaping (:func:`_shaping_taps`)
    run_in_alt: bool = False

    def samples_per_bit(self, fs: float) -> float:
        return fs / self.f_bit


def cc_pack(text: str) -> torch.Tensor:
    """Two characters -> the EIA-608 line payload: (16,) int32 bits on the
    host, each byte 7-bit ASCII + ODD parity, LSB first."""
    if len(text) != 2:
        raise ValueError(f"a caption line carries exactly 2 chars, got {len(text)}")
    bits = []
    for ch in text:
        v = ord(ch)
        if v > 0x7F:
            raise ValueError(f"EIA-608 is 7-bit: {ch!r}")
        data = [(v >> i) & 1 for i in range(7)]  # LSB first
        bits.extend(data + [1 - (sum(data) % 2)])  # odd parity
    return torch.tensor(bits, dtype=torch.int32)


def cc_unpack(bits) -> tuple[str, bool]:
    """16 decoded bits (host or device) -> (2 chars, parity_ok)."""
    b = [int(v) for v in torch.as_tensor(bits).reshape(-1).tolist()]
    chars, ok = [], True
    for k in range(2):
        byte = b[8 * k : 8 * k + 8]
        chars.append(chr(sum(bit << i for i, bit in enumerate(byte[:7]))))
        ok = ok and sum(byte) % 2 == 1
    return "".join(chars), ok


def cc_spec(plan: Plan, n_bits: int = 16) -> DataLineSpec:
    """EIA-608-style spec: clock at 32x the line rate (~0.503 MHz on NTSC),
    7-cycle run-in, start 001, 16 payload bits, 50-IRE data level."""
    return DataLineSpec(f_bit=32.0 * plan.cfg.fh, n_bits=n_bits, run_in_cycles=7,
                        level=0.5, start_bits=(0, 0, 1))


def teletext_spec(plan: Plan, n_bits: int = 64) -> DataLineSpec:
    """Teletext-flavoured spec at 222x the line rate (~3.5 MHz on PAL, half
    the real WST rate, >= 3.8 samples per bit on the 13.5 MHz grid)."""
    return DataLineSpec(f_bit=222.0 * plan.cfg.fh, n_bits=n_bits, run_in_cycles=8,
                        level=0.5, start_bits=(1, 1, 0))


def _layout_of(fs: float, n: int, spec: DataLineSpec) -> tuple[float, float, float]:
    spb = spec.samples_per_bit(fs)
    # an alternating (1010...) run-in cycle spans TWO bit periods
    run_in = spec.run_in_cycles * spb * (2 if spec.run_in_alt else 1)
    start = len(spec.start_bits) * spb
    total = run_in + start + spec.n_bits * spb
    if total > n:
        raise ValueError(f"{spec.n_bits} bits at {spec.f_bit/1e6:.2f} MHz need "
                         f"{total:.0f} samples, line has {n}")
    if spb < 3.0:
        raise ValueError(f"{spec.f_bit/1e6:.2f} MHz is under 3 samples/bit at "
                         f"fs={fs/1e6:.2f} MHz — raise the line width")
    return spb, run_in, start


def _layout(plan: Plan, spec: DataLineSpec) -> tuple[float, float, float]:
    """(samples per bit, run-in length, start-code length) in samples."""
    return _layout_of(plan.fs, plan.n_samples, spec)


@lru_cache(maxsize=64)
def _taps_of(fs: float, spec: DataLineSpec) -> np.ndarray:
    if spec.run_in_alt:
        # 100% cosine roll-off (ETS 300 706): cos^2(pi f / 2 f_bit), zero
        # beyond f_bit, -6 dB at the f_bit/2 Nyquist point
        def rc(f):
            fa = np.minimum(np.abs(np.asarray(f, np.float64)), spec.f_bit)
            return (np.cos(0.5 * np.pi * fa / spec.f_bit) ** 2).astype(np.complex128)

        taps = design.freq_sampled_taps(fs, rc, 63)
    else:
        # the sine run-in sits AT f_bit: the cutoff stays above it
        taps = design.lowpass_taps(fs, 1.4 * spec.f_bit, 63)
    taps.flags.writeable = False  # the cache hands the same array to every caller
    return taps


def _shaping_taps(plan: Plan, spec: DataLineSpec) -> np.ndarray:
    """The data line's pulse-shaping FIR (float64 host taps)."""
    return _taps_of(plan.fs, spec)


@lru_cache(maxsize=64)
def _encode_consts(fs: float, n: int, spec: DataLineSpec, device: torch.device):
    """(fixed run-in + start waveform, payload cell of each sample, payload
    mask), on ``device``."""
    spb, run_in, _ = _layout_of(fs, n, spec)
    m = np.arange(n, dtype=np.float64)
    if spec.run_in_alt:
        # alternating 1,0,1,0 bit cells
        clock = (np.floor(m / spb).astype(np.int64) % 2 == 0).astype(np.float64)
    else:
        # a sine burst at f_bit, one cycle per bit, peaks at the centres
        clock = 0.5 * (1.0 - np.cos(TWO_PI * m / spb))
    run_wave = np.where(m < run_in, clock, 0.0)
    cell = np.floor((m - run_in) / spb).astype(np.int64)
    n_start = len(spec.start_bits)
    start_vals = np.asarray(spec.start_bits, np.float64)
    in_start = (m >= run_in) & (cell < n_start)
    start_wave = np.where(in_start, start_vals[np.clip(cell, 0, n_start - 1)], 0.0)
    pay = cell - n_start
    in_pay = (m >= run_in) & (pay >= 0) & (pay < spec.n_bits)
    return (torch.tensor((run_wave + start_wave).astype(np.float32), device=device),
            torch.tensor(np.clip(pay, 0, spec.n_bits - 1), device=device),
            torch.tensor(in_pay, device=device))


def encode_data_line(plan: Plan, spec: DataLineSpec, bits) -> torch.Tensor:
    """(..., n_bits) 0/1 -> (..., N) data-line waveform in luma units, on
    the bits' device."""
    bits = torch.as_tensor(bits)
    if bits.shape[-1] != spec.n_bits:
        raise ValueError(f"expected {spec.n_bits} bits, got {bits.shape[-1]}")
    fixed, sel, in_pay = _encode_consts(plan.fs, plan.n_samples, spec, bits.device)
    pay = torch.where(in_pay, bits[..., sel].to(torch.float32), 0.0)
    wave = f32(spec.level) * (fixed + pay)
    return fir_same_taps(wave, _taps_of(plan.fs, spec))


@lru_cache(maxsize=64)
def _decode_consts(fs: float, n: int, spec: DataLineSpec, device: torch.device):
    """The run-in window times its two clock phases, the window's weight,
    the bit centres before timing recovery, and the integrate-and-dump
    offsets, on ``device``."""
    spb, run_in, _ = _layout_of(fs, n, spec)
    idx = np.arange(n)
    # half a bit of guard at each end of the run-in window: the shaping FIR
    # smears the leading edge, and the start bits smear backwards
    w = ((idx >= 0.5 * spb) & (idx < run_in - 0.5 * spb)).astype(np.float64)
    m = np.arange(n, dtype=np.float32)
    if spec.run_in_alt:
        ang = (np.float32(np.pi / spb) * m).astype(np.float64)
        zi, zq = np.sin(ang), -np.cos(ang)
    else:
        ang = (np.float32(TWO_PI / spb) * m).astype(np.float64)
        zi, zq = -np.cos(ang), np.sin(ang)
    n_start = len(spec.start_bits)
    centers = np.float32(run_in) + (
        (np.float32(n_start) + np.arange(spec.n_bits, dtype=np.float32)) + np.float32(0.5)
    ) * np.float32(spb)
    frac = 0.15 if spec.run_in_alt else 0.3
    offs = np.arange(-np.floor(frac * spb), np.floor(frac * spb) + 1.0, dtype=np.float32)
    win = torch.tensor(w.astype(np.float32), device=device)
    return (win * torch.tensor(zi.astype(np.float32), device=device),
            win * torch.tensor(zq.astype(np.float32), device=device),
            float(w.sum()), torch.tensor(centers, device=device),
            torch.tensor(offs, device=device))


def _half_rate_gain(fs: float, spec: DataLineSpec) -> float:
    """The shaping FIR's response at f_bit/2, the alternating run-in's
    fundamental (its 100% roll-off is -6 dB there, while data runs ride
    its unit DC gain)."""
    taps = _taps_of(fs, spec)
    k = np.arange(len(taps), dtype=np.float64) - (len(taps) - 1) / 2
    return float(np.sum(taps * np.cos(TWO_PI * (0.5 * spec.f_bit / fs) * k)))


def decode_data_line(plan: Plan, spec: DataLineSpec,
                     line: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) received line -> ((..., n_bits) int32 bits, (...,) margin).

    The run-in gives the clock phase (sub-sample timing) and amplitude (the
    slicing threshold, so gain errors cannot break slicing); ``margin`` is
    the worst bit's distance from the threshold in units of the data level:
    0.5 is a perfect eye, <= 0 means a bit error is likely.
    """
    spb, _, _ = _layout(plan, spec)
    x = line.to(torch.float32)
    wi, wq, wsum, centers, offs = _decode_consts(plan.fs, plan.n_samples, spec, x.device)
    # the window is 0/1, so (window * x) * clock == x * (window * clock)
    zi, zq = (x * wi).sum(-1), (x * wq).sum(-1)
    amp = 2.0 * torch.hypot(zi, zq) / f32(wsum)
    if spec.run_in_alt:
        # the 1010... run-in's fundamental is sin(pi m / spb); a line delayed
        # by t correlates to C (cos, sin)(pi t / spb).  |fundamental| of the
        # level/0 square is (2/pi) level, scaled by the shaping's response
        # there, so the threshold lands mid-eye
        tau = f32(spb / np.pi) * torch.atan2(zq, zi)
        level = f32(np.pi / 2.0 / max(_half_rate_gain(plan.fs, spec), 1e-6)) * amp
    else:
        # clock = -cos(2 pi m / spb) around its mean; a line delayed by t
        # correlates to C (cos, -sin)(2 pi t / spb)
        tau = f32(-spb / TWO_PI) * torch.atan2(zq, zi)
        level = 2.0 * amp
    c = centers + tau[..., None]
    # integrate and dump: the middle 60% of each bit, or the middle 30% of a
    # cosine-shaped (run_in_alt) pulse, whose zero-ISI point is the centre
    idx = torch.clamp(torch.round(c[..., None] + offs).to(torch.int64), 0, plan.n_samples - 1)
    k = offs.shape[0]
    taken = torch.gather(x, -1, idx.reshape(*idx.shape[:-2], spec.n_bits * k))
    vals = taken.reshape(*idx.shape).mean(-1)
    thresh = level[..., None] * 0.5
    bits = (vals > thresh).to(torch.int32)
    margin = torch.amin((vals - thresh).abs(), dim=-1) / torch.clamp_min(level, 1e-6)
    return bits, margin
