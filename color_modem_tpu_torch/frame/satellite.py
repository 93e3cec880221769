"""Satellite FM transmission: wideband video FM at IF.

Port of ``color_modem_tpu/frame/satellite.py``, with its analog audio
subcarrier ladder above the video.  The chain:

    baseband -> CCIR-405-shaped pre-emphasis -> energy dispersal ->
    wideband FM onto an IF carrier at exactly fs_rf/4 -> AWGN at a CNR ->
    receiver band-pass -> quadrature FM discriminator -> de-emphasis

* The IF carrier sits at fs_rf/4, so its cos/sin are the 4-sample
  patterns [1,0,-1,0] / [0,1,0,-1]: exact, with no phase state.
* The FM phase is the midpoint-rule integral of the deviation per frame
  over the contiguous row-major stream: a ``cumsum`` per line plus a line
  carry wrapped mod 2 pi.  The video path before it (pre-emphasis,
  interpolation, deviation), the sums, the carries and the line's phase
  (up to about 2.4 krad) are kept in float64 and the phase is reduced mod
  2 pi before it is cast to float32.  The integral turns the float32
  rounding of the filters into a phase walk that grows with the frame:
  in float32 the modulator reads 51 dB against the float64 oracle at 480
  lines x 720, in float64 96 dB (``scripts/torch_fm_parity_length.py``).
  The JAX package keeps all of it in float32 (ROADMAP section 3).  The frame's residual phase is spread
  over its samples, so each frame is one period of a periodic signal and
  the stream filters wrap around its ends (:func:`_wrap_pad`).
* Every filter is an overlap-save stream convolution (``dsp/stream.py``):
  the modulator's zero-stuff interpolation is one
  :func:`~color_modem_tpu_torch.dsp.stream.upsample_fir_stream`; the
  receiver's band-pass, fs/4 quadrature mix and I/Q low-pass are one
  complex FIR decimated by 2 inside the convolution
  (:func:`~color_modem_tpu_torch.dsp.stream.conv_decim_stream`), and the
  final low-pass and decimation one
  :func:`~color_modem_tpu_torch.dsp.stream.fir_decim_stream`.
* The discriminator is the phase of the product of adjacent half-rate
  samples, ``angle(a[m+1] conj(a[m]))``: no unwrap, no Hilbert filter.
* Each audio subcarrier completes a whole number of cycles per frame
  stream, its cos/sin a host float64 table uploaded once per device; the
  audio is 50 us pre-emphasised and frequency-modulated per frame with
  its phase closed mod 2 pi (summed in float64 in a fixed order,
  ``dsp/nco.py::running_phase``, where the JAX package sums in float32),
  and the receiver mixes each one down, discriminates it circularly and
  AC-couples the result.

The composed taps are built once per plan and their spectra uploaded once
per device; noise is drawn from a JAX key (``utils/prng.py``), the JAX
package's noise on every device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.nco import f32, running_phase
from color_modem_tpu_torch.dsp.stream import (
    _carrier_taps,
    conv_decim_stream,
    fir_decim_stream,
    fir_stream,
    pad_taps_center,
    plan_memo,
    upsample_fir_stream,
)
from color_modem_tpu_torch.utils import prng

TWO_PI = 2.0 * np.pi

def preemph_response(f, f1: float, f2: float, g0: float):
    """CCIR Rec. 405-shaped video pre-emphasis for FM: ``|P(f)|^2 = g0^2
    (1 + (f/f1)^2) / (1 + (f/f2)^2)`` with ``f2 = f1/g0``: LF gain ``g0``,
    HF gain ``1/g0``, zero phase."""
    f = np.asarray(f, dtype=np.float64)
    mag = g0 * np.sqrt((1.0 + (f / f1) ** 2) / (1.0 + (f / f2) ** 2))
    return mag.astype(np.complex128)


def _emph50_mag(f, audio_bw: float, tau: float = 50e-6):
    """50 us audio emphasis shelf ``|1 + j 2 pi f tau|``, held flat above
    ``audio_bw`` (the de-emphasis is its exact reciprocal)."""
    f50 = 1.0 / (2.0 * np.pi * tau)
    fe = np.minimum(np.abs(np.asarray(f, np.float64)), audio_bw)
    return np.sqrt(1.0 + (fe / f50) ** 2).astype(np.complex128)


@dataclasses.dataclass(frozen=True, eq=False)
class SatPlan:
    """Host-side constants for one (baseband geometry) satellite link."""

    base_fs: float            # baseband sample rate (Hz)
    n_base: int               # baseband samples per row
    r: int                    # RF oversampling factor (fs_rf = r * base_fs)
    fs_rf: float
    n_rf: int                 # RF samples per row = r * n_base
    deviation: float          # Hz per video unit
    center: float             # video value mapped to the carrier rest freq
    dispersal: float          # energy-dispersal amplitude, video units (pk)
    total_lines: int          # dispersal period (one frame)
    interp_taps: np.ndarray   # zero-stuff anti-image LPF (RF rate)
    rx_taps: np.ndarray       # receiver transponder band-pass (RF rate)
    iq_taps: np.ndarray       # post-mixer I/Q low-pass (RF rate)
    dec_taps: np.ndarray      # pre-decimation low-pass (RF rate)
    pre_taps: np.ndarray      # pre-emphasis (baseband rate)
    de_taps: np.ndarray       # de-emphasis (baseband rate)
    dec2_taps: np.ndarray | None = None  # pre-decimation low-pass at fs_rf/2
    # --- analog audio subcarriers (empty tuple = no sound designed) -----
    sub_freqs: tuple = ()     # subcarrier frequencies, Hz (baseband mux)
    sub_dev: float = 85e3     # audio FM deviation per subcarrier, Hz
    sub_amp: float = 0.11     # subcarrier amplitude, video units each
    audio_bw: float = 15e3
    mux_lpf: np.ndarray | None = None  # video LPF clearing the sub band
    sub_lpf: np.ndarray | None = None  # post-mix I/Q LPF (baseband rate)
    aud_rx: np.ndarray | None = None   # audio LPF * 50us de-emphasis
    aud_pre: np.ndarray | None = None  # 50us pre-emphasis

    # --- composed-FIR views (host float64, built once per plan) --------
    def tx_video_taps(self) -> np.ndarray:
        """Transmit-side baseband video FIR: pre-emphasis, composed with
        the sound-multiplex low-pass when subcarriers are designed."""
        def build():
            if self.mux_lpf is not None:
                return np.convolve(self.mux_lpf, self.pre_taps)
            return np.asarray(self.pre_taps, np.float64)
        return plan_memo(self, "tx_video", build)

    def rx_video_taps(self) -> np.ndarray:
        """Receive-side baseband video FIR: de-emphasis, composed with the
        subcarrier-reject low-pass when subcarriers are designed."""
        def build():
            if self.mux_lpf is not None:
                return np.convolve(self.mux_lpf, self.de_taps)
            return np.asarray(self.de_taps, np.float64)
        return plan_memo(self, "rx_video", build)

    def interp_up_taps(self) -> np.ndarray:
        """Anti-image interpolation FIR for upsample_fir_stream, with the
        zero-stuffing gain ``r`` folded in, aligned to the rate change."""
        return plan_memo(self, "interp_up", lambda: pad_taps_center(
            self.r * np.asarray(self.interp_taps, np.float64), 2 * self.r))

    def h_demod_taps(self) -> np.ndarray:
        """Receiver front end as ONE complex FIR: band-pass, exact fs/4
        quadrature mix, I/Q low-pass, ``2 conv(iq e^{+j(pi/2)(k-lo)},
        rx)``.  Its output ``w`` is the complex baseband rotated by
        ``e^{j(pi/2)n}``, which the discriminator cancels."""
        return plan_memo(self, "h_demod", lambda: np.convolve(
            2.0 * _carrier_taps(self.iq_taps, 0.5 * np.pi), self.rx_taps))

    def dec_down_taps(self) -> np.ndarray:
        """Pre-decimation low-pass for fir_decim_stream (aligned)."""
        return plan_memo(self, "dec_down", lambda: pad_taps_center(
            np.asarray(self.dec_taps, np.float64), 2 * self.r))

    def h_demod2_taps(self) -> np.ndarray:
        """:meth:`h_demod_taps` aligned for the half-rate front end
        (conv_decim_stream, r=2)."""
        return plan_memo(self, "h_demod2", lambda: pad_taps_center(
            self.h_demod_taps(), 4))

    def dec_down2_taps(self) -> np.ndarray:
        """Pre-decimation low-pass at fs_rf/2 for the half-rate
        demodulator's final fir_decim_stream (r//2), aligned."""
        return plan_memo(self, "dec_down2", lambda: pad_taps_center(
            np.asarray(self.dec2_taps, np.float64), max(2 * (self.r // 2), 2)))


#: Analog-satellite audio subcarrier ladder (Hz): the 6.50 MHz main mono
#: slot, then every third slot of the Astra 180 kHz grid from 7.02 MHz.
AUDIO_SUB_LADDER = (6.50e6, 7.02e6, 7.56e6, 8.10e6)


def make_sat_plan(
    base_fs: float,
    n_base: int,
    *,
    r: int = 4,
    deviation: float = 12.0e6,
    center: float = 0.5,
    dispersal: float = 0.0,
    total_lines: int = 625,
    f_emph: float = 1.0e6,
    g_emph: float = 0.45,
    audio_subs: int = 0,
    sub_freqs: tuple | None = None,
    sub_dev: float = 85e3,
    sub_amp: float = 0.11,
    audio_bw: float = 15e3,
) -> SatPlan:
    """Design the satellite link for a given baseband geometry (the JAX
    package's design, bit-identical, audio subcarrier filters included).

    Defaults: r=4 puts the carrier at exactly fs_rf/4; deviation 12 MHz
    per video unit; ``dispersal`` > 0 adds the frame-synchronous
    triangular energy dispersal (removed by the next layer's clamp);
    ``audio_subs`` > 0 designs that many FM audio subcarriers above a
    low-passed video.
    """
    if r < 1 or r & (r - 1):
        raise ValueError(
            f"make_sat_plan: oversampling r={r} must be a power of two — "
            "the stream engine's rate changes partition power-of-two FFT "
            "blocks into r dense sub-blocks (dsp/stream._check_rate)"
        )
    fs_rf = r * base_fs
    fc = fs_rf / 4.0
    f_base = 0.5 * base_fs
    bw = 2.0 * (deviation * max(center, 1.0 - center) + f_base)  # Carson
    bw = min(bw, 2.0 * fc - 2.0e6)  # keep the band off DC/Nyquist
    ntaps_rf = 4 * design.DEFAULT_NTAPS + 1

    sub_half = 2.0 * (sub_dev + audio_bw)  # Carson half-width, x2 margin
    if audio_subs:
        if sub_freqs is None:
            top = 0.49 * base_fs - sub_half - 0.1e6
            if AUDIO_SUB_LADDER[audio_subs - 1] <= top:
                sub_freqs = AUDIO_SUB_LADDER[:audio_subs]
            elif audio_subs <= 2:
                sub_freqs = tuple(
                    (0.43 + 0.035 * i) * base_fs for i in range(audio_subs)
                )
            else:
                raise ValueError(
                    f"audio_subs={audio_subs}: only 2 scaled subcarrier "
                    f"slots fit a {base_fs/1e6:.1f} MHz baseband — use a "
                    "wider geometry (27 MHz) for the full ladder"
                )
        sub_freqs = tuple(float(f) for f in sub_freqs)
        for f in sub_freqs:
            if f + sub_half > 0.49 * base_fs - 0.05e6:
                raise ValueError(
                    f"subcarrier {f/1e6:.2f} MHz + {sub_half/1e3:.0f} kHz "
                    f"Carson width exceeds the {base_fs/1e6:.1f} MHz "
                    "baseband's passband"
                )
        fl = sorted(sub_freqs)
        if any(b - a < 2.2 * (sub_dev + audio_bw) for a, b in zip(fl, fl[1:])):
            raise ValueError(f"subcarriers too close: {fl}")
    else:
        sub_freqs = ()

    base_cut = 0.49 * base_fs if sub_freqs else 0.5 * base_fs * 0.96
    interp = design.lowpass_taps(fs_rf, base_cut, ntaps_rf)
    rx = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, fc - 0.5 * bw, fc + 0.5 * bw, 1.0e6
        ),
        ntaps_rf,
    )
    iq = design.lowpass_taps(fs_rf, 0.5 * bw, ntaps_rf)
    dec = design.lowpass_taps(fs_rf, base_cut, ntaps_rf)
    dec2 = design.lowpass_taps(fs_rf / 2.0, base_cut, 2 * design.DEFAULT_NTAPS + 1)
    f1 = f_emph
    f2 = f1 / g_emph
    pre = design.freq_sampled_taps(base_fs, lambda f: preemph_response(f, f1, f2, g_emph))
    de = design.freq_sampled_taps(
        base_fs, lambda f: 1.0 / preemph_response(f, f1, f2, g_emph))
    mux_lpf = sub_lpf = aud_rx = aud_pre = None
    if sub_freqs:
        ntaps_b = 4 * design.DEFAULT_NTAPS + 1
        mux_lpf = design.lowpass_taps(base_fs, min(sub_freqs) - sub_half - 0.25e6, ntaps_b)
        cut = sub_half + 50e3
        if len(sub_freqs) > 1:
            fl0 = sorted(sub_freqs)
            cut = min(cut, 0.55 * min(b - a for a, b in zip(fl0, fl0[1:])))
        sub_lpf = design.lowpass_taps(base_fs, cut, ntaps_b)
        nt_aud = 8192 * max(1, round(base_fs / 13.5e6)) + 1
        aud_rx = design.freq_sampled_taps(
            base_fs,
            lambda f: design.raised_cosine_bandpass_response(
                f, 0.0, audio_bw + 3e3, 6e3
            ) / _emph50_mag(f, audio_bw),
            nt_aud,
        )
        aud_pre = design.freq_sampled_taps(base_fs, lambda f: _emph50_mag(f, audio_bw), nt_aud)
    return SatPlan(
        base_fs=base_fs, n_base=n_base, r=r, fs_rf=fs_rf, n_rf=r * n_base,
        deviation=deviation, center=center, dispersal=dispersal,
        total_lines=total_lines,
        interp_taps=interp, rx_taps=rx, iq_taps=iq, dec_taps=dec,
        pre_taps=pre, de_taps=de, dec2_taps=dec2,
        sub_freqs=sub_freqs, sub_dev=sub_dev, sub_amp=sub_amp,
        audio_bw=audio_bw, mux_lpf=mux_lpf, sub_lpf=sub_lpf,
        aud_rx=aud_rx, aud_pre=aud_pre,
    )


@lru_cache(maxsize=16)
def _carrier_patterns(n: int, device: torch.device):
    """cos / sin of the exact fs/4 carrier over ``n`` samples: repeating
    [1,0,-1,0] / [0,1,0,-1], made on the device once per (n, device)."""
    c = torch.tensor([1.0, 0.0, -1.0, 0.0], device=device).repeat(n // 4)
    s = torch.tensor([0.0, 1.0, 0.0, -1.0], device=device).repeat(n // 4)
    return c, s


def dispersal_offset(sp: SatPlan, gline: torch.Tensor) -> torch.Tensor:
    """Frame-synchronous triangular energy dispersal, video units (..., L):
    a closed form of the absolute line index, so chunked runs stay
    chunk-size independent."""
    if sp.dispersal == 0.0:
        return torch.zeros(gline.shape, dtype=torch.float32, device=gline.device)
    ph = torch.remainder(gline, 2 * sp.total_lines).to(torch.float32) / sp.total_lines
    tri = 1.0 - torch.abs(1.0 - ph) * 2.0  # -1 -> +1 -> -1 over 2 frames
    return f32(sp.dispersal) * tri


#: Stream-edge margin at the baseband rate: every stream filter's warm-up
#: fits inside 256 samples, and 256 * r is a multiple of 4, so the fs/4
#: mixer patterns and the decimation grid stay aligned across the crop.
_EDGE_PAD = 256


def _wrap_pad(s: torch.Tensor, p: int) -> torch.Tensor:
    """Circular edge extension along the stream axis: the frame is one
    period of a periodic signal (:func:`fm_modulate` closes its phase), so
    the true history of sample 0 is the end of the stream."""
    return torch.cat([s[..., -p:], s, s[..., :p]], dim=-1)


def _wrap_filter(s: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Stream FIR with circular edges: wrap-pad by the filter's half-width
    (rounded up to 8), filter, crop."""
    n = s.shape[-1]
    p = -(-(len(taps) // 2 + 1) // 8) * 8
    if p > n:
        raise ValueError(
            f"stream of {n} samples is shorter than the {len(taps)}-tap "
            "filter's half-width — use more lines"
        )
    return fir_stream(_wrap_pad(s, p), taps)[..., p : p + n]


@lru_cache(maxsize=16)
def _sub_trig(k_cycles: int, n_total: int, device: torch.device):
    """cos/sin (float32, on ``device``, uploaded once) of a subcarrier
    completing exactly ``k_cycles`` over the ``n_total``-sample frame
    stream: host float64, the product reduced mod ``n_total`` before the
    divide (``k*i`` reaches ~1e13, exact in float64)."""
    ph = (TWO_PI / n_total) * ((k_cycles * np.arange(n_total, dtype=np.float64)) % n_total)
    return (torch.tensor(np.cos(ph), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ph), dtype=torch.float32, device=device))


def _sub_cycles(sp: SatPlan, f: float, n_tot: int) -> int:
    return int(round(f * n_tot / sp.base_fs))


def _audio_mux(sp: SatPlan, audio, l: int) -> torch.Tensor:
    """(B, K, L*n_base) audio in [-1, 1] -> the subcarrier multiplex
    (B, L*n_base) in video units: 50 us pre-emphasis, then per-frame
    circular FM on each subcarrier (the deviation phase closed mod 2 pi
    over the frame, like the main carrier's)."""
    a = torch.as_tensor(audio, dtype=torch.float32)
    if a.ndim == 2:
        a = a[:, None, :]
    n_tot = l * sp.n_base
    if a.shape[1] != len(sp.sub_freqs) or a.shape[-1] != n_tot:
        raise ValueError(
            f"audio shape {tuple(a.shape)} != (B, {len(sp.sub_freqs)}, {n_tot})")
    a = _wrap_filter(a, sp.aud_pre)
    out = a.new_zeros(a.shape[0], n_tot)
    for j, f in enumerate(sp.sub_freqs):
        dphi = (f32(TWO_PI * sp.sub_dev / sp.base_fs) * a[:, j]).to(torch.float64)
        tot = torch.remainder(torch.sum(dphi, dim=-1, keepdim=True), TWO_PI)
        tot = torch.where(tot > np.pi, tot - TWO_PI, tot)
        dphi = dphi - tot / n_tot
        phi = torch.remainder(running_phase(dphi, sp.n_base) - 0.5 * dphi,
                              TWO_PI).to(torch.float32)
        c, s = _sub_trig(_sub_cycles(sp, f, n_tot), n_tot, a.device)
        out = out + f32(sp.sub_amp) * (c * torch.cos(phi) - s * torch.sin(phi))
    return out


def fm_modulate(sp: SatPlan, base: torch.Tensor, gline=None,
                audio: torch.Tensor | None = None) -> torch.Tensor:
    """Baseband (B, L, N) video units -> FM signal (B, L, N*r) at IF.

    Pre-emphasis at the baseband rate, zero-stuff interpolation to the RF
    rate, the midpoint-rule deviation integral per frame (line carry
    wrapped mod 2 pi), the exact fs/4 carrier.  ``gline`` (B, L) adds the
    energy dispersal.  ``audio``: (B, K, L*n_base) (or (B, L*n_base) when
    K = 1) audio in [-1, 1] at the baseband rate, one stream per designed
    subcarrier, added to the multiplex above the low-passed video (the
    plan needs ``audio_subs`` > 0).
    """
    b, l, n = base.shape
    if n != sp.n_base:
        raise ValueError(f"rows have {n} samples, plan expects {sp.n_base}")
    if audio is not None and not sp.sub_freqs:
        raise ValueError(
            "this SatPlan has no audio subcarriers — pass audio_subs= to make_sat_plan")
    # the video path in float64 (module docstring): float32 rounding of
    # the filters, integrated over the frame, walks the phase off by mrad
    v = _wrap_filter(base.to(torch.float64).reshape(b, l * n), sp.tx_video_taps())
    if sp.sub_freqs and audio is not None:
        v = v + _audio_mux(sp, torch.as_tensor(audio, device=base.device), l)
    v = v.reshape(b, l, n)
    if gline is not None:
        # dispersal enters after pre-emphasis; de-emphasis passes a per-line
        # DC at unit gain, so the next layer's clamp removes it exactly
        v = v + dispersal_offset(sp, gline)[..., None]
    # zero-stuff + anti-image LPF in one frequency-domain pass; the padded
    # baseband is stuffed, so the prefix keeps the stuffing grid
    pb = _EDGE_PAD
    v_rf = upsample_fir_stream(_wrap_pad(v.reshape(b, l * n), pb), sp.interp_up_taps(), sp.r)
    v_rf = v_rf[..., pb * sp.r : pb * sp.r + l * sp.n_rf].reshape(b, l, sp.n_rf)

    # the phase bookkeeping in float64 too: the line sums, the carries and
    # the prefix sums agree, so no line starts off its predecessor's end by
    # the float32 rounding of a 2.4 krad sum
    dphi = (TWO_PI * sp.deviation / sp.fs_rf) * (v_rf.double() - sp.center)
    # close the phase over the frame: spread the (mod 2 pi) residual of the
    # total deviation phase over every sample, so the frame is one period
    ls0 = torch.sum(dphi, dim=-1)                                        # (B, L)
    tot = torch.remainder(torch.cumsum(torch.remainder(ls0, TWO_PI), dim=-1)[..., -1:],
                          TWO_PI)
    tot = torch.where(tot > np.pi, tot - TWO_PI, tot)
    dphi = dphi - (tot / (l * sp.n_rf))[..., None]
    carry = torch.remainder(
        torch.cumsum(torch.remainder(torch.sum(dphi, dim=-1), TWO_PI), dim=-1), TWO_PI)
    carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]], dim=-1)
    phi = torch.cumsum(dphi, dim=-1) - 0.5 * dphi + carry[..., None]
    phi = torch.remainder(phi, TWO_PI).to(torch.float32)

    cpat, spat = _carrier_patterns(sp.n_rf, base.device)
    # cos(ramp + phi) = cos(ramp) cos(phi) - sin(ramp) sin(phi)
    return cpat * torch.cos(phi) - spat * torch.sin(phi)


def _demod_multiplex(sp: SatPlan, rf: torch.Tensor) -> torch.Tensor:
    """Receiver front end: band-pass, exact fs/4 quadrature mix, I/Q
    low-pass and decimation by 2 as one complex FIR, the adjacent-product
    discriminator, then the low-pass and decimation to the baseband rate.
    Returns the recovered baseband multiplex (B, L*n_base) in video units,
    before de-emphasis."""
    b, l, n_rf = rf.shape
    if n_rf != sp.n_rf:
        raise ValueError(f"rows have {n_rf} RF samples, plan expects {sp.n_rf}")
    if sp.r < 2 or sp.dec2_taps is None:
        raise ValueError(
            "the half-rate demod needs r >= 2 and a plan with dec2_taps "
            "(rebuild the SatPlan with make_sat_plan)"
        )
    # circular extension: a zero edge would be a dead carrier, whose
    # discriminator noise the decimation LPF smears into line 0
    pad = _EDGE_PAD * sp.r
    stream = _wrap_pad(rf.to(torch.float32).reshape(b, l * n_rf), pad)
    # the stream ADVANCED by one sample keeps the odd complex-baseband
    # samples: a[m] = w[2m+1], so adjacent products pair z(2m+3) with
    # z(2m+1) and read f_inst at the even RF time 2m+2
    s1 = torch.cat([stream[..., 1:], stream[..., -1:]], dim=-1)
    a = conv_decim_stream(s1, sp.h_demod2_taps(), 2)
    i, q = a.real, a.imag
    ip = torch.cat([i[..., 1:], i[..., -1:]], dim=-1)
    qp = torch.cat([q[..., 1:], q[..., -1:]], dim=-1)
    # a[m+1] conj(a[m]) = -z(2m+3) z*(2m+1)
    re = -(ip * i + qp * q)
    imag = -(qp * i - ip * q)
    f_dev = torch.atan2(imag, re) * f32(sp.fs_rf / (2.0 * TWO_PI))
    # f_dev[m] reads time 2m+2: delay one half-rate sample -> time 2m
    f_dev = torch.cat([f_dev[..., :1], f_dev[..., :-1]], dim=-1)
    v = f_dev / f32(sp.deviation) + f32(sp.center)
    v = fir_decim_stream(v, sp.dec_down2_taps(), sp.r // 2)
    pc = pad // sp.r
    return v[..., pc : pc + l * sp.n_base]


def fm_demodulate(sp: SatPlan, rf: torch.Tensor) -> torch.Tensor:
    """FM signal (B, L, N*r) -> baseband (B, L, N) video units: the front
    end, then the subcarrier reject and de-emphasis as one composed FIR.
    Dispersal, when transmitted, is still in the output (the next layer's
    clamp removes it)."""
    b, l, _ = rf.shape
    v = _wrap_filter(_demod_multiplex(sp, rf), sp.rx_video_taps())
    return v.reshape(b, l, sp.n_base)


def fm_demodulate_audio(sp: SatPlan, rf: torch.Tensor) -> torch.Tensor:
    """FM signal (B, L, N*r) -> subcarrier audio (B, K, L*n_base).

    The front end, then per subcarrier: the quadrature mix with its exact
    whole-cycles-per-frame carrier, the I/Q low-pass (the band selection),
    the circular symmetric discriminator (``torch.roll`` is exact: the
    mixed-down stream is frame-periodic) and the audio low-pass with the
    50 us de-emphasis in one FIR.  The output is AC-coupled, which removes
    the ~100 Hz carrier bias of the per-frame phase closure.
    """
    if not sp.sub_freqs:
        raise ValueError("this SatPlan has no audio subcarriers")
    _, l, _ = rf.shape
    mux = _demod_multiplex(sp, rf)
    n_tot = l * sp.n_base
    outs = []
    for f in sp.sub_freqs:
        c, s = _sub_trig(_sub_cycles(sp, f, n_tot), n_tot, rf.device)
        i = _wrap_filter(mux * (2.0 * c), sp.sub_lpf)
        q = _wrap_filter(mux * (-2.0 * s), sp.sub_lpf)
        ip, im = torch.roll(i, -1, -1), torch.roll(i, 1, -1)
        qp, qm = torch.roll(q, -1, -1), torch.roll(q, 1, -1)
        f_dev = torch.atan2(qp * im - ip * qm, ip * im + qp * qm) * f32(
            sp.base_fs / (2.0 * TWO_PI))
        a = _wrap_filter(f_dev / f32(sp.sub_dev), sp.aud_rx)
        outs.append(a - torch.mean(a, dim=-1, keepdim=True))
    return torch.stack(outs, dim=1)


def noise_sigma(sp: SatPlan, cnr_db: float) -> float:
    """White-noise sigma for a carrier-to-noise ratio referenced to the
    noise power inside the receiver band-pass (host float64)."""
    H = np.fft.rfft(np.asarray(sp.rx_taps), n=1 << 15)
    bw_frac = float(np.sum(np.abs(H) ** 2) / len(H) / np.max(np.abs(H)) ** 2)
    cnr = 10.0 ** (cnr_db / 10.0)
    return float(np.sqrt(0.5 / cnr / max(bw_frac, 1e-6)))


def awgn(sp: SatPlan, rf: torch.Tensor, key: prng.Key, cnr_db: float) -> torch.Tensor:
    """Add channel noise at a carrier-to-noise ratio, ``normal(key,
    rf.shape)``."""
    return prng.add_normal(rf, noise_sigma(sp, cnr_db), key)


def sat_roundtrip(sp: SatPlan, base: torch.Tensor, gline=None,
                  key: prng.Key | None = None,
                  cnr_db: float | None = None) -> torch.Tensor:
    rf = fm_modulate(sp, base, gline)
    if cnr_db is not None:
        rf = awgn(sp, rf, key, cnr_db)
    return fm_demodulate(sp, rf)
