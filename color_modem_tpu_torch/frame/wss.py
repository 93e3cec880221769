"""Widescreen signalling (WSS, line 23): a 14-bit biphase status word.

Port of ``color_modem_tpu/frame/wss.py``.  The aspect-ratio group uses the
EN 300 294 code table (8 odd-weight 4-bit words: odd parity is built in),
in the real group sizes 4+4+3+3.  Elements run at 330 fh (5.156 MHz on
625/50), so element edges are closed-form on any sample grid; each bit is
6 elements, ``b b b ~b ~b ~b``.  The run-in is a raised-sine clock burst
and a fixed start code, recovered like the other data lines
(``frame/vbi.py``); each bit then correlates against the biphase template.
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

N_BITS = 14
#: bits per group: aspect (A), enhanced services (B), subtitles (C), reserved (D)
GROUPS = (4, 4, 3, 3)

#: EN 300 294 group-A aspect-ratio codebook (b0 first on the wire); every
#: word has odd weight
ASPECT_CODES = {
    "4:3 full": (1, 0, 0, 0),
    "14:9 letterbox centre": (0, 0, 0, 1),
    "14:9 letterbox top": (0, 0, 1, 0),
    "16:9 letterbox centre": (1, 0, 1, 1),
    "16:9 letterbox top": (0, 1, 0, 0),
    ">16:9 letterbox centre": (1, 1, 0, 1),
    "14:9 full (shoot & protect)": (1, 1, 1, 0),
    "16:9 full (anamorphic)": (0, 1, 1, 1),
}
_ASPECT_DECODE = {v: k for k, v in ASPECT_CODES.items()}

#: start code between the clock run-in and the biphase data
_START = (1, 1, 1, 0, 0, 1)
#: elements per bit (3 elements, then the 3 inverted)
_EPB = 6
#: clock run-in length in bit periods
_RUN_IN_BITS = 5
#: data level in luma units (EN 300 294: 0.5 V over black)
LEVEL = 0.7


@dataclasses.dataclass(frozen=True)
class WssLayout:
    spe: float        # samples per element
    run_in: float     # run-in length, samples
    start: float      # start-code length, samples
    f_elem: float     # element rate, Hz


def _layout_of(fh: float, fs: float, n: int) -> WssLayout:
    f_elem = 330.0 * fh
    spe = fs / f_elem
    if spe < 2.0:
        raise ValueError(f"WSS needs >= 2 samples/element, fs={fs/1e6:.2f} MHz "
                         f"gives {spe:.2f}")
    spb = spe * _EPB
    run_in = _RUN_IN_BITS * spb
    start = len(_START) * spe
    total = run_in + start + N_BITS * spb
    if total > n:
        raise ValueError(f"WSS needs {total:.0f} samples, line has {n}")
    return WssLayout(spe=spe, run_in=run_in, start=start, f_elem=f_elem)


def wss_layout(plan: Plan) -> WssLayout:
    return _layout_of(plan.cfg.fh, plan.fs, plan.n_samples)


def wss_word(aspect: str = "4:3 full", enhanced: int = 0, subtitles: int = 0,
             reserved: int = 0) -> torch.Tensor:
    """The 14-bit status word as (14,) int32 host bits.  ``enhanced``,
    ``subtitles`` and ``reserved`` are raw group values (4/3/3 bits)."""
    if aspect not in ASPECT_CODES:
        raise ValueError(f"unknown aspect label {aspect!r}; one of {sorted(ASPECT_CODES)}")
    bits = list(ASPECT_CODES[aspect])
    for val, width in ((enhanced, 4), (subtitles, 3), (reserved, 3)):
        if not 0 <= val < (1 << width):
            raise ValueError(f"group value {val} exceeds {width} bits")
        bits.extend((val >> i) & 1 for i in range(width))
    return torch.tensor(bits, dtype=torch.int32)


def _shaping(fs: float, lay: WssLayout) -> np.ndarray:
    # band-limit the element edges; keep the run-in tone (at 1/spb) intact
    return design.lowpass_taps(fs, 0.7 * lay.f_elem, 63)


@lru_cache(maxsize=32)
def _encode_consts(fh: float, fs: float, n: int, device: torch.device):
    """(fixed run-in + start waveform, bit of each sample, second-half flag,
    data mask), on ``device``."""
    lay = _layout_of(fh, fs, n)
    spb = lay.spe * _EPB
    m = np.arange(n, dtype=np.float64)
    # clock run-in: a raised sine, one cycle per BIT period
    run_wave = np.where(m < lay.run_in, 0.5 * (1.0 - np.cos(TWO_PI * m / spb)), 0.0)
    el = np.floor((m - lay.run_in) / lay.spe).astype(np.int64)
    n_start = len(_START)
    in_start = (m >= lay.run_in) & (el < n_start)
    start_wave = np.where(in_start, np.asarray(_START, np.float64)[np.clip(el, 0, n_start - 1)],
                          0.0)
    data_el = el - n_start
    bit_idx = data_el // _EPB
    return (torch.tensor((run_wave + start_wave).astype(np.float32), device=device),
            torch.tensor(np.clip(bit_idx, 0, N_BITS - 1), device=device),
            torch.tensor((data_el % _EPB) >= (_EPB // 2), device=device),
            torch.tensor((data_el >= 0) & (bit_idx < N_BITS), device=device))


def encode_wss(plan: Plan, bits) -> torch.Tensor:
    """(..., 14) bits -> (..., N) line-23 waveform in luma units, on the
    bits' device."""
    bits = torch.as_tensor(bits)
    if bits.shape[-1] != N_BITS:
        raise ValueError(f"WSS carries {N_BITS} bits, got {bits.shape[-1]}")
    fixed, sel, half, in_data = _encode_consts(plan.cfg.fh, plan.fs, plan.n_samples,
                                               bits.device)
    b = bits[..., sel].to(torch.float32)
    data = torch.where(in_data, torch.where(half, 1.0 - b, b), 0.0)
    wave = f32(LEVEL) * (fixed + data)
    return fir_same_taps(wave, _shaping(plan.fs, wss_layout(plan)))


@lru_cache(maxsize=32)
def _decode_consts(fh: float, fs: float, n: int, device: torch.device):
    """The run-in window times its clock's two phases, the window's weight
    and the element centres before timing recovery, on ``device``."""
    lay = _layout_of(fh, fs, n)
    spb = lay.spe * _EPB
    idx = np.arange(n)
    w = ((idx >= 0.5 * spb) & (idx < lay.run_in - 0.5 * spb)).astype(np.float32)
    ang = (np.float32(TWO_PI / spb) * np.arange(n, dtype=np.float32)).astype(np.float64)
    centers = np.float32(lay.run_in + lay.start) + (
        np.arange(N_BITS * _EPB, dtype=np.float32) + np.float32(0.5)) * np.float32(lay.spe)
    return (torch.tensor(w * (-np.cos(ang)).astype(np.float32), device=device),
            torch.tensor(w * np.sin(ang).astype(np.float32), device=device),
            float(w.sum()), torch.tensor(centers, device=device))


def decode_wss(plan: Plan, line: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) received line -> ((..., 14) int32 bits, (...,) margin).

    Clock and amplitude from the run-in (as ``frame/vbi.py``), then each
    bit's six element centres correlate against ``[+1]*3 + [-1]*3``: the
    sign is the bit, the size the confidence."""
    lay = wss_layout(plan)
    spb = lay.spe * _EPB
    x = line.to(torch.float32)
    wi, wq, wsum, centers = _decode_consts(plan.cfg.fh, plan.fs, plan.n_samples, x.device)
    # the window is 0/1, so (window * x) * clock == x * (window * clock)
    zi, zq = (x * wi).sum(-1), (x * wq).sum(-1)
    tau = f32(-spb / TWO_PI) * torch.atan2(zq, zi)
    level = 2.0 * (2.0 * torch.hypot(zi, zq) / f32(wsum))
    idx = torch.clamp(torch.round(centers + tau[..., None]).to(torch.int64), 0,
                      plan.n_samples - 1)
    vals = torch.gather(x, -1, idx).reshape(*x.shape[:-1], N_BITS, _EPB)
    half = _EPB // 2
    d = vals - 0.5 * level[..., None, None]
    # the template sum in the JAX package's order: +d0 +d1 +d2 -d3 -d4 -d5
    corr = d[..., 0]
    for k in range(1, _EPB):
        corr = corr + d[..., k] if k < half else corr - d[..., k]
    bits = (corr > 0).to(torch.int32)
    margin = torch.amin(corr.abs(), dim=-1) / torch.clamp_min(_EPB * 0.5 * level, 1e-6)
    return bits, margin


def parse_wss(bits) -> dict:
    """14 decoded bits (host or device) -> the status word (host-side)."""
    b = [int(v) for v in torch.as_tensor(bits).reshape(-1).tolist()]
    aspect = _ASPECT_DECODE.get(tuple(b[:4]))
    return {
        "aspect": aspect if aspect is not None else "invalid",
        "aspect_ok": aspect is not None,  # the odd-weight codebook check
        "enhanced": sum(bit << i for i, bit in enumerate(b[4:8])),
        "subtitles": sum(bit << i for i, bit in enumerate(b[8:11])),
        "reserved": sum(bit << i for i, bit in enumerate(b[11:14])),
    }
