"""RF/IF vestigial-sideband picture transmission.

Port of ``color_modem_tpu/frame/rf.py``:

    composite -> negative-AM VSB picture signal at a low IF
              -> Nyquist-flank receiver + synchronous detection -> composite

with an intercarrier FM sound carrier above the video sideband
(:func:`rf_modulate`'s ``audio``, :func:`sound_on_rf` /
:func:`sound_from_rf` for the chunked runner's joined streams).

* Row-major composite samples are ONE contiguous stream per frame, as in
  ``frame/channel.py``'s ghost; rastered lines (``frame/raster.py``) work
  too, with ``make_rf_plan(row_samples=raster.n_total)``.
* The picture carrier is snapped to a half-integer number of cycles per
  row, so a row starts at phase 0 or pi: a ``(-1)^row`` sign on the
  absolute row index, with no phase state between rows, frames or chunks.
* Each direction's filter-mix-filter cascade is composed into one complex
  FIR (``RFPlan.mod_taps``/``dem_taps``) by the modulation identity
  ``h*(y cos wn) = Re{e^{jwn}((h e^{-jw.})*y)}``, and the rate change
  happens in the frequency domain (``dsp/stream.py``: ``upconv_stream``
  up, ``conv_decim_stream`` down); only the carrier rotation is left as
  elementwise work.
* The sound carrier is a half-integer number of cycles per row too.  Its
  FM phase is the running sum of the float32 deviation steps at the RF
  rate, kept in float64 in a fixed order (``dsp/nco.py::running_phase``)
  and reduced mod 2 pi before float32 holds it; the JAX package sums in
  float32 (ROADMAP queue 3).  The receiver's discriminator is the exact
  phase difference ``angle(z[t] conj(z[t-1]))`` at the composite rate.

The composed taps are built once per (plan, frequency offset) and their
spectra uploaded once per device, as are the carrier tables; dropouts draw
from a JAX key (``utils/prng.py``), the JAX package's on every device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.nco import (
    f32,
    frame_indices,
    line_phase0,
    running_phase,
    sample_phase_ramp,
)
from color_modem_tpu_torch.dsp.stream import (
    _carrier_taps,
    conv_decim_stream,
    fir_stream,
    pad_taps_center,
    plan_memo,
    upconv_stream,
)
from color_modem_tpu_torch.modem.plan import FmPlan, QamPlan
from color_modem_tpu_torch.utils import prng
from color_modem_tpu_torch.utils.tracing import span

TWO_PI = 2.0 * np.pi

#: Negative-modulation envelope map (BT.470 System M levels, fractions of
#: peak carrier): sync tip 100 %, blanking 75 %, peak white 12.5 %; with
#: the raster's -0.4 sync tip, env = BLANK - (BLANK - WHITE) * v.
ENV_BLANK = 0.75
ENV_WHITE = 0.125

#: Design margins (Hz): band-edge transition width, guard to DC/Nyquist.
_TRANSITION = 0.3e6
_GUARD = 0.2e6

#: DOC carrier-loss threshold: a legitimate envelope never falls below
#: peak white (0.125), so anything under half of it is carrier loss.
DOC_THRESHOLD = 0.06

def _nyquist_flank(f, fc: float, f_vestige: float, f_video: float,
                   transition: float = _TRANSITION):
    """Receiver response: a raised-cosine flank through 0.5 at the carrier
    (width 2*f_vestige), flat over the upper sideband, raised-cosine
    rolloff after ``fc + f_video``; ``H(fc+f) + H(fc-f) = 1``."""
    f = np.asarray(f, dtype=np.float64)
    lo, hi = fc - f_vestige, fc + f_vestige
    flank = np.where(
        f <= lo, 0.0,
        np.where(f >= hi, 1.0, 0.5 * (1 - np.cos(np.pi * (f - lo) / (hi - lo)))),
    )
    top = fc + f_video
    roll = np.where(
        f <= top, 1.0,
        np.where(
            f >= top + transition, 0.0,
            0.5 * (1 + np.cos(np.pi * (f - top) / transition)),
        ),
    )
    return flank * roll


@dataclasses.dataclass(frozen=True, eq=False)
class RFPlan:
    """Config-time RF geometry and filter taps for one (plan, r) pair
    (hashable by identity)."""

    plan: QamPlan | FmPlan
    r: int                  # oversampling: fs_rf = r * plan.fs
    row_samples: int        # composite samples per row
    fc: float               # picture carrier, Hz (exact: cpl_num/2 cycles/row)
    cpl_num: int            # carrier cycles per row = cpl_num / 2 (odd)
    f_vestige: float        # lower (vestigial) sideband width, Hz
    f_video: float          # upper sideband width, Hz
    tx_taps: np.ndarray     # VSB shaping bandpass (fs_rf)
    rx_taps: np.ndarray     # Nyquist-flank receiver bandpass (fs_rf)
    det_taps: np.ndarray    # post-detection video lowpass (fs_rf)
    ramp: np.ndarray        # (N*r,) within-row carrier phase ramp, f64
    # --- intercarrier FM sound ---------------------------------------------
    f_snd: float            # sound carrier, Hz (exact: snd_num/2 cycles/row)
    snd_num: int
    snd_dev: float          # peak FM deviation, Hz (audio in [-1, 1])
    snd_amp: float          # sound carrier amplitude vs peak picture carrier
    snd_bpf: np.ndarray     # receiver sound-takeoff bandpass (fs_rf)
    snd_lpf: np.ndarray     # post-mix I/Q lowpass (fs_rf)
    aud_lpf: np.ndarray     # recovered-audio lowpass (composite rate fs)
    snd_ramp: np.ndarray    # (N*r,) sound-carrier phase ramp, f64

    @property
    def fs_rf(self) -> float:
        return self.r * self.plan.fs

    @property
    def n_rf(self) -> int:
        """RF samples per row."""
        return self.row_samples * self.r

    def mod_taps(self, df: float = 0.0) -> np.ndarray:
        """Composed complex modulate filter: anti-image lowpass, carrier mix
        at ``fc + df`` and VSB shaping as one FIR for ``upconv_stream``
        (stuffing gain ``r`` included)."""
        def build():
            w = TWO_PI * (self.fc + df) / self.fs_rf
            return pad_taps_center(
                self.r * np.convolve(_carrier_taps(self.tx_taps, -w), self.det_taps),
                2 * self.r,
            )
        return plan_memo(self, ("mod", float(df)), build)

    def dem_taps(self, df: float = 0.0) -> np.ndarray:
        """Composed complex demodulate filter: Nyquist-flank selection,
        product mix at ``fc + df`` and post-detection lowpass as one FIR for
        ``conv_decim_stream``."""
        def build():
            w = TWO_PI * (self.fc + df) / self.fs_rf
            return pad_taps_center(
                np.convolve(_carrier_taps(self.det_taps, -w), self.rx_taps), 2 * self.r)
        return plan_memo(self, ("dem", float(df)), build)

    def snd_dem_taps(self, df: float = 0.0) -> np.ndarray:
        """Composed complex sound-takeoff filter: sound bandpass, I/Q mix at
        ``f_snd + df`` and I/Q lowpass (factor 2 of the mix included)."""
        def build():
            w = TWO_PI * (self.f_snd + df) / self.fs_rf
            return pad_taps_center(
                2.0 * np.convolve(_carrier_taps(self.snd_lpf, +w), self.snd_bpf),
                2 * self.r)
        return plan_memo(self, ("snd_dem", float(df)), build)

    @property
    def ramp_comp(self) -> np.ndarray:
        """Within-row picture-carrier phase at the composite rate (fc is a
        half-integer number of cycles per row at either rate)."""
        return sample_phase_ramp(self.fc, self.plan.fs, self.row_samples)

    @property
    def snd_ramp_comp(self) -> np.ndarray:
        return sample_phase_ramp(self.f_snd, self.plan.fs, self.row_samples)

    @property
    def video_zero(self) -> float:
        """Composite level at which the carrier nulls (env = 0): the pivot
        about which an RF-linear channel (:func:`rf_ghost`) is linear at the
        composite rate (``frame/equalize.py``'s ``pivot``)."""
        return ENV_BLANK / (ENV_BLANK - ENV_WHITE)


def make_rf_plan(
    plan: QamPlan | FmPlan,
    r: int = 4,
    fc: float | None = None,
    f_video: float | None = None,
    ntaps: int = 1025,
    intercarrier: float | None = None,
    snd_dev: float | None = None,
    snd_amp: float = 0.2,
    audio_bw: float = 15e3,
    snd_ntaps: int = 4097,
    transition: float = _TRANSITION,
    row_samples: int | None = None,
) -> RFPlan:
    """Design the RF geometry and filters for ``plan`` at oversampling ``r``
    (the JAX package's design, bit-identical, sound filters included).

    The carrier snaps to the nearest half-integer number of cycles per row;
    by default it sits at ``f_video + 2 MHz`` and the video bandwidth is
    0.46 fs (0.49 fs for SECAM), the transparent mode.  ``row_samples``:
    the row length when it is not ``plan.n_samples`` (``raster.n_total``
    for rastered lines).
    """
    with span("cm.build.rf_plan"):
        if r < 1 or r & (r - 1):
            raise ValueError(
                f"make_rf_plan: oversampling r={r} must be a power of two — "
                "the stream engine's rate changes partition power-of-two FFT "
                "blocks into r dense sub-blocks (dsp/stream._check_rate)"
            )
        fs = plan.fs
        fs_rf = r * fs
        n = plan.n_samples if row_samples is None else int(row_samples)
        if f_video is None:
            f_video = (0.49 if plan.cfg.is_fm else 0.46) * fs
        # vestige per BT.470: 0.75 MHz for System M (525), 1.25 MHz for 625-line
        f_vestige = 0.75e6 if plan.cfg.total_lines == 525 else 1.25e6
        if fc is None:
            fc = f_video + 2.0e6
        cpl_num = 2 * int(round(fc * n / fs - 0.5)) + 1
        fc = cpl_num / 2 * fs / n
        if 2 * fc - f_vestige < f_video + transition + _GUARD:
            raise ValueError(
                f"fc={fc/1e6:.2f} MHz too low: the 2fc detection image "
                f"(down to {(2*fc - f_vestige)/1e6:.2f} MHz) overlaps the "
                f"{f_video/1e6:.2f} MHz video band — raise fc"
            )
        if fc + f_video + transition > fs_rf / 2 - _GUARD:
            raise ValueError(
                f"fc+f_video={(fc+f_video)/1e6:.2f} MHz exceeds RF Nyquist "
                f"{fs_rf/2e6:.2f} MHz — raise r (r={r})"
            )
        if fc - f_vestige < _GUARD:
            raise ValueError(f"fc={fc/1e6:.2f} MHz leaves no room for the vestige")

        tx_taps = design.freq_sampled_taps(
            fs_rf,
            lambda f: design.raised_cosine_bandpass_response(
                f, fc - f_vestige, fc + f_video, transition
            ),
            ntaps,
        )
        rx_taps = design.freq_sampled_taps(
            fs_rf, lambda f: _nyquist_flank(f, fc, f_vestige, f_video, transition), ntaps)
        det_taps = design.lowpass_taps(fs_rf, f_video + transition, ntaps)

        if intercarrier is None:
            intercarrier = f_video + 0.75e6
        if snd_dev is None:
            snd_dev = 25e3 if plan.cfg.total_lines == 525 else 50e3
        snd_num = 2 * int(round((fc + intercarrier) * n / fs - 0.5)) + 1
        f_snd = snd_num / 2 * fs / n
        snd_half = 2.0 * (snd_dev + audio_bw)
        if f_snd - snd_half < fc + f_video + transition:
            raise ValueError(
                f"sound carrier {f_snd/1e6:.2f} MHz overlaps the video "
                f"sideband top {(fc + f_video)/1e6:.2f} MHz — raise intercarrier"
            )
        if f_snd + snd_half > fs_rf / 2 - _GUARD:
            raise ValueError(
                f"sound carrier {f_snd/1e6:.2f} MHz too close to RF Nyquist "
                f"{fs_rf/2e6:.2f} MHz — raise r"
            )
        snd_bpf = design.freq_sampled_taps(
            fs_rf,
            lambda f: design.raised_cosine_bandpass_response(
                f, f_snd - snd_half, f_snd + snd_half, snd_half
            ),
            snd_ntaps,
        )
        snd_lpf = design.lowpass_taps(fs_rf, snd_half, snd_ntaps)
        aud_lpf = design.lowpass_taps(fs, audio_bw + 3e3, 8192 * max(1, round(fs / 13.5e6)) + 1)
        return RFPlan(
            plan=plan, r=r, row_samples=n, fc=fc, cpl_num=cpl_num,
            f_vestige=f_vestige, f_video=f_video,
            tx_taps=tx_taps, rx_taps=rx_taps, det_taps=det_taps,
            ramp=sample_phase_ramp(fc, fs_rf, n * r),
            f_snd=f_snd, snd_num=snd_num, snd_dev=snd_dev, snd_amp=snd_amp,
            snd_bpf=snd_bpf, snd_lpf=snd_lpf, aud_lpf=aud_lpf,
            snd_ramp=sample_phase_ramp(f_snd, fs_rf, n * r),
        )


@lru_cache(maxsize=64)
def _table(values: bytes, device: torch.device) -> torch.Tensor:
    with span("cm.build.table"):
        return torch.tensor(np.frombuffer(values, np.float32), device=device)


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host float64 table as float32 on ``device``, uploaded once."""
    return _table(np.asarray(host, np.float32).tobytes(), torch.device(device))


def _trig(ramp: np.ndarray, device: torch.device):
    """cos and sin of a host float64 phase table, float32 on ``device``."""
    return _upload(np.cos(ramp), device), _upload(np.sin(ramp), device)


def _abs_rows(frame0, b: int, l: int, device) -> torch.Tensor:
    """(B, L) absolute row indices, keyed by the absolute frame index."""
    g = frame_indices(frame0, b, device)
    return g[:, None] * l + torch.arange(l, dtype=torch.int32, device=device)[None, :]


def _row_sign(frame0, b: int, l: int, device) -> torch.Tensor:
    """(-1)^(absolute row index): the carrier's row-start phase."""
    return 1.0 - 2.0 * torch.remainder(_abs_rows(frame0, b, l, device), 2).to(torch.float32)


def _df_phase(rfp: RFPlan, df: float, frame0, b: int, l: int, device,
              comp_rate: bool = False) -> torch.Tensor:
    """(B, L, n) extra carrier phase (radians) of a static frequency offset
    ``df`` Hz over the contiguous stream, keyed by the absolute row index.

    The row-start part is ``(df*n/fs * row) mod 1`` cycles, with ``row`` up
    to ~1e6: the row index splits as ``q*4096 + r`` and each factor's
    cycles reduce mod 1 in host float64 first, so both float32 products
    stay small.  ``comp_rate`` evaluates on the composite-rate grid.
    """
    n = rfp.row_samples
    cyc = float(df) * n / rfp.plan.fs
    frac1 = cyc % 1.0
    frac2 = (4096.0 * cyc) % 1.0
    rows = _abs_rows(frame0, b, l, device)
    q, rr = torch.div(rows, 4096, rounding_mode="floor"), torch.remainder(rows, 4096)
    cycles = torch.remainder(q.to(torch.float32) * f32(frac2)
                             + rr.to(torch.float32) * f32(frac1), 1.0)
    fs_here = rfp.plan.fs if comp_rate else rfp.fs_rf
    n_here = rfp.row_samples if comp_rate else rfp.n_rf
    in_row = _upload(TWO_PI * ((float(df) / fs_here)
                               * np.arange(n_here, dtype=np.float64) % 1.0), device)
    return (TWO_PI * cycles)[:, :, None] + in_row[None, None, :]


def _hold(x: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-order hold by ``r`` along the last axis (each sample repeated
    ``r`` times), as a broadcast: no host sync for the output size."""
    return x.unsqueeze(-1).expand(*x.shape, r).reshape(*x.shape[:-1], x.shape[-1] * r)


def _deviation_phase(dphi: torch.Tensor, row: int, phi0=0.0) -> torch.Tensor:
    """The FM deviation phase of float32 steps (S, T), plus ``phi0`` (a
    float or a 0-d tensor): summed in float64 in a fixed order
    (``dsp/nco.py::running_phase``), reduced mod 2 pi, then float32."""
    if isinstance(phi0, torch.Tensor):
        phi0 = phi0.to(device=dphi.device, dtype=torch.float64)
    return torch.remainder(running_phase(dphi, row) + phi0, TWO_PI).to(torch.float32)


def _check_rows(name: str, rfp: RFPlan, n: int) -> None:
    if n != rfp.row_samples:
        raise ValueError(
            f"{name}: rows have {n} samples but the RF plan was "
            f"designed for {rfp.row_samples} — pass row_samples= to "
            "make_rf_plan (e.g. raster.n_total for rastered lines)"
        )


def rf_modulate(rfp: RFPlan, comp: torch.Tensor, frame0=0, audio=None,
                df: float = 0.0) -> torch.Tensor:
    """Composite (B, L, N) video units -> VSB picture RF (B, L, N*r).

    Negative AM (sync tip = peak carrier), zero-stuffed to the RF rate,
    mixed onto the closed-form carrier and VSB-shaped, in one
    ``upconv_stream`` pass and a carrier rotation.  ``df``: transmitter
    mistuning, Hz (both carriers shift together).  ``audio``: optional
    (B, L*N) mono audio in [-1, 1] at the composite rate, added as the
    intercarrier FM sound carrier; each batch item is integrated on its
    own (:func:`sound_on_rf` joins them).
    """
    b, l, n = comp.shape
    _check_rows("rf_modulate", rfp, n)
    dev = comp.device
    env = ENV_BLANK - (ENV_BLANK - ENV_WHITE) * comp.to(torch.float32)
    v = upconv_stream(env.reshape(b, l * n), rfp.mod_taps(df), rfp.r).reshape(b, l, rfp.n_rf)
    if df != 0.0:
        ph = _upload(rfp.ramp, dev)[None, None, :] + _df_phase(rfp, df, frame0, b, l, dev)
        cos_t, sin_t = torch.cos(ph), torch.sin(ph)
    else:
        cos_t, sin_t = _trig(rfp.ramp, dev)
    rf = (v.real * cos_t - v.imag * sin_t) * _row_sign(frame0, b, l, dev)[:, :, None]
    if audio is not None:
        # FM: the closed-form carrier ramp plus the deviation integral, one
        # cumsum over each item's stream of the zero-order-held audio;
        # cos(pi*row + x) = row_sign * cos(x)
        a_rf = _hold(torch.as_tensor(audio, dtype=torch.float32, device=dev), rfp.r)
        dphi = f32(2.0 * np.pi * rfp.snd_dev / rfp.fs_rf) * a_rf
        phi = _upload(rfp.snd_ramp, dev)[None, None, :] + _deviation_phase(
            dphi, rfp.n_rf).reshape(b, l, rfp.n_rf)
        if df != 0.0:  # the same LO chain: the sound carrier shifts too
            phi = phi + _df_phase(rfp, df, frame0, b, l, dev)
        rf = rf + rfp.snd_amp * torch.cos(phi) * _row_sign(frame0, b, l, dev)[:, :, None]
    return rf


def _row_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row ``q`` quantile of (B, n) with linear interpolation, as
    ``jnp.quantile`` computes it (position ``q * (n - 1)`` in float32).  A
    sort, not ``torch.quantile``, which refuses more than 2^24 elements."""
    v = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    pos = np.float32(q) * (np.float32(n) - np.float32(1.0))
    low = int(np.floor(pos))
    high = min(int(np.ceil(pos)), n - 1)
    w_high = np.float32(pos - np.float32(low))
    w_low = np.float32(np.float32(1.0) - w_high)
    return v[:, low] * float(w_low) + v[:, high] * float(w_high)


def rf_demodulate(rfp: RFPlan, rf: torch.Tensor, frame0=0, detection: str = "sync",
                  phase_error: float = 0.0, doc: bool = False,
                  agc: bool = False, freq_error: float = 0.0) -> torch.Tensor:
    """VSB picture RF (B, L, N*r) -> composite (B, L, N) video units.

    Nyquist-flank selection, product mix and post-detection lowpass as one
    complex filter decimated to the composite rate, then the carrier
    rotation there.  ``detection``: ``"sync"`` (coherent product detection;
    ``phase_error`` radians models a mis-locked oscillator) or
    ``"envelope"`` (``4|z|``, immune to carrier phase).  ``doc``: dropout
    compensation, samples whose envelope falls below
    :data:`DOC_THRESHOLD` (dilated by 4) take the previous line's.
    ``agc``: sync-tip AGC, the envelope over its per-item 97.5th
    percentile (needs a rastered composite).  ``freq_error``: the
    receiver's mixers run at ``fc + freq_error``.
    """
    b, l, n_rf = rf.shape
    dev = rf.device
    z = conv_decim_stream(
        rf.reshape(b, l * n_rf), rfp.dem_taps(freq_error), rfp.r
    ).reshape(b, l, rfp.row_samples)
    sign = _row_sign(frame0, b, l, dev)[:, :, None]
    if detection == "sync":
        # gain 4: x2 for the product's cos^2 halving, x2 for the Nyquist
        # flank's half envelope
        if freq_error != 0.0:
            ph = (_upload(rfp.ramp_comp + phase_error, dev)[None, None, :]
                  + _df_phase(rfp, freq_error, frame0, b, l, dev, comp_rate=True))
            mix_c, mix_s = torch.cos(ph), torch.sin(ph)
        else:
            mix_c, mix_s = _trig(rfp.ramp_comp + phase_error, dev)
        env = 4.0 * (z.real * mix_c - z.imag * mix_s) * sign
    elif detection == "envelope":
        env = 4.0 * torch.abs(z)
    else:
        raise ValueError(f"unknown detection {detection!r}")
    if agc:
        # the sync plateau holds ~7% of the samples at one level: the
        # 97.5th percentile lands mid-plateau
        ref = _row_quantile(env.reshape(b, -1), 0.975)
        env = env / torch.clamp_min(ref, 1e-6)[:, None, None]
    if doc:
        lost = env < DOC_THRESHOLD
        for k in (1, 2, 3, 4):  # dilate over the detection-filter ramps
            lost = lost | torch.roll(lost, k, -1) | torch.roll(lost, -k, -1)
        prev_line = torch.cat([env[:, :1], env[:, :-1]], dim=1)
        env = torch.where(lost, prev_line, env)
    return (ENV_BLANK - env) / (ENV_BLANK - ENV_WHITE)


def rf_cochannel(rfp: RFPlan, comp: torch.Tensor, frame0=0, offset_num: int = 1,
                 offset_den: int = 2) -> torch.Tensor:
    """Co-channel interferer: a second station's VSB picture on the same
    channel, its carrier offset by ``offset_num/offset_den`` cycles per
    row (1/2 = the classic precision offset).  Returns the interferer's RF
    (scale by the protection ratio and add to the wanted signal).  The
    offset carrier's row-start phase is ``dsp/nco.py::line_phase0``'s
    exact integer law."""
    b, l, n = comp.shape
    if n != rfp.row_samples:
        raise ValueError(
            f"rf_cochannel: rows have {n} samples, plan expects {rfp.row_samples}")
    dev = comp.device
    env = ENV_BLANK - (ENV_BLANK - ENV_WHITE) * comp.to(torch.float32)
    num = rfp.cpl_num * offset_den + 2 * offset_num
    den = 2 * offset_den
    phi0 = line_phase0(num, den, _abs_rows(frame0, b, l, dev))
    fh = rfp.plan.fs / rfp.row_samples
    fc2 = rfp.fc + offset_num / offset_den * fh

    def build():
        w2 = TWO_PI * fc2 / rfp.fs_rf
        return pad_taps_center(
            rfp.r * np.convolve(_carrier_taps(rfp.tx_taps, -w2), rfp.det_taps), 2 * rfp.r)

    taps2 = plan_memo(rfp, ("cochannel", offset_num, offset_den), build)
    v = upconv_stream(env.reshape(b, l * n), taps2, rfp.r).reshape(b, l, rfp.n_rf)
    ramp2 = _upload(sample_phase_ramp(fc2, rfp.fs_rf, rfp.n_rf), dev)
    ph = phi0[:, :, None] + ramp2[None, None, :]
    return v.real * torch.cos(ph) - v.imag * torch.sin(ph)


def rf_ghost(rfp: RFPlan, rf: torch.Tensor, delay_us: float, gain: float) -> torch.Tensor:
    """Multipath ghost at RF: a delayed, attenuated copy of the RF stream
    (B, L, N*r -> same); the delay rides the contiguous stream and delays
    the carrier too.  Through synchronous detection it is a linear
    composite-rate channel about ``RFPlan.video_zero``, which the GCR
    equalizer (``frame/equalize.py``) cancels."""
    b, l, n_rf = rf.shape
    d = max(1, int(round(delay_us * 1e-6 * rfp.fs_rf)))
    stream = rf.reshape(b, l * n_rf)
    g = torch.cat([stream.new_zeros(b, d), stream[:, :-d]], dim=-1)
    return (stream + gain * g).reshape(b, l, n_rf)


def rf_dropout(rfp: RFPlan, rf: torch.Tensor, key: prng.Key | int,
               rate: float = 0.05, len_us: float = 10.0) -> torch.Tensor:
    """Tape dropouts at RF: with probability ``rate`` per line the carrier
    vanishes over a ``len_us`` span at a random position; ``key`` (or
    ``PRNGKey(key)`` for an int) splits into the hits' key and the starts',
    as in JAX."""
    b, l, n_rf = rf.shape
    dev = rf.device
    span = int(round(len_us * 1e-6 * rfp.fs_rf))
    k_hit, k_start = prng.split(prng.as_key(key))
    hit = prng.bernoulli(k_hit, rate, (b, l), dev)
    start = prng.randint(k_start, (b, l), 0, max(n_rf - span, 1), dev)
    idx = torch.arange(n_rf, device=dev)[None, None, :]
    mask = hit[:, :, None] & (idx >= start[:, :, None]) & (idx < start[:, :, None] + span)
    return torch.where(mask, 0.0, rf)


def recover_carrier_phase(rfp: RFPlan, rf: torch.Tensor, frame0=0,
                          freq_error: float = 0.0) -> torch.Tensor:
    """Received picture-carrier phase offset, radians (B,): the stream
    correlated against the nominal I/Q mixers (at ``fc + freq_error``) and
    averaged, ``atan2(<x (-sin)>, <x cos>)``.  Pass it to
    :func:`rf_demodulate` as ``phase_error``."""
    b, l, n_rf = rf.shape
    dev = rf.device
    sign = _row_sign(frame0, b, l, dev)[:, :, None]
    if freq_error != 0.0:
        ph = _upload(rfp.ramp, dev)[None, None, :] + _df_phase(rfp, freq_error, frame0, b, l, dev)
        c, s = torch.cos(ph), torch.sin(ph)
    else:
        c, s = _trig(rfp.ramp, dev)
    xi = torch.mean(rf * c * sign, dim=(1, 2))
    xq = torch.mean(rf * (-s) * sign, dim=(1, 2))
    return torch.atan2(xq, xi)


def recover_carrier_frequency(rfp: RFPlan, rf: torch.Tensor, frame0=0,
                              search: float = 100e3) -> torch.Tensor:
    """Received picture-carrier frequency offset, Hz (B,): the AFT.

    Coarse: the peak ``|rfft|`` bin within ``fc +- search`` over the
    contiguous stream.  Fine: derotate by the coarse estimate, correlate
    each row against the nominal carrier and read the mean per-row phase
    step.  Returns ``df_hat`` for :func:`rf_demodulate` /
    :func:`recover_carrier_phase`'s ``freq_error`` (as a host float).
    """
    b, l, n_rf = rf.shape
    dev = rf.device
    stream = rf.reshape(b, l * n_rf)
    t = stream.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(t)))
    spec = torch.abs(torch.fft.rfft(stream, n=nfft, dim=-1))
    dbin = rfp.fs_rf / nfft
    k0 = max(int(np.floor((rfp.fc - search) / dbin)), 1)
    k1 = min(int(np.ceil((rfp.fc + search) / dbin)) + 1, nfft // 2)
    k = k0 + torch.argmax(spec[:, k0:k1], dim=-1)
    df_c = k.to(torch.float32) * f32(dbin) - f32(rfp.fc)
    # fine: block-relative sample times j = row*n_rf + i keep the float32
    # products small
    alpha = df_c[:, None, None] * f32(n_rf / rfp.fs_rf)
    rows = torch.arange(l, dtype=torch.float32, device=dev)[None, :, None]
    i_in = torch.arange(n_rf, dtype=torch.float32, device=dev)[None, None, :]
    derot = TWO_PI * (torch.remainder(alpha * rows, 1.0)
                      + (df_c[:, None, None] / f32(rfp.fs_rf)) * i_in)
    sign = _row_sign(frame0, b, l, dev)[:, :, None]
    base_c, base_s = _trig(rfp.ramp, dev)
    cc, ss = torch.cos(derot), torch.sin(derot)
    zr = torch.sum(rf * sign * (base_c * cc - base_s * ss), dim=-1)
    zi = torch.sum(rf * sign * (-base_s * cc - base_c * ss), dim=-1)
    dre = torch.sum(zr[:, 1:] * zr[:, :-1] + zi[:, 1:] * zi[:, :-1], dim=-1)
    dim = torch.sum(zi[:, 1:] * zr[:, :-1] - zr[:, 1:] * zi[:, :-1], dim=-1)
    dtheta = torch.atan2(dim, dre)
    fh = rfp.plan.fs / rfp.row_samples
    return df_c + dtheta * f32(fh / TWO_PI)


def rf_retune(rfp: RFPlan, rf: torch.Tensor, df: float, frame0=0) -> torch.Tensor:
    """Digital AFC retune: shift the received RF by ``-df`` (B, L, N*r ->
    same): the analytic signal by one power-of-two FFT over the stream,
    heterodyned by ``e^{-i 2 pi df t}`` on the absolute-row time law, real
    part.  Demodulate the result with ``freq_error=0``."""
    b, l, n_rf = rf.shape
    dev = rf.device
    stream = rf.reshape(b, l * n_rf)
    t = stream.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(t)))
    spec = torch.fft.fft(stream, n=nfft, dim=-1)
    w = np.zeros(nfft, np.float32)
    w[0] = 1.0
    w[nfft // 2] = 1.0
    w[1:nfft // 2] = 2.0
    za = torch.fft.ifft(spec * _upload(w, dev)[None, :], dim=-1)[:, :t]
    ph = _df_phase(rfp, -df, frame0, b, l, dev).reshape(b, l * n_rf)
    shifted = za * torch.complex(torch.cos(ph), torch.sin(ph))
    return shifted.real.reshape(b, l, n_rf)


def _snd_rotate(rfp: RFPlan, zc: torch.Tensor, frame0, freq_error: float):
    """(i, q) from the composed sound-takeoff output: ``zc`` rotated by
    ``e^{-j(snd ramp + (-1)^row law + df phase)}`` at the composite rate
    (the factor 2 of the mix is in ``RFPlan.snd_dem_taps``)."""
    b, l, _ = zc.shape
    dev = zc.device
    sign = _row_sign(frame0, b, l, dev)[:, :, None]
    if freq_error != 0.0:
        ph = (_upload(rfp.snd_ramp_comp, dev)[None, None, :]
              + _df_phase(rfp, freq_error, frame0, b, l, dev, comp_rate=True))
        c, s = torch.cos(ph) * sign, torch.sin(ph) * sign
    else:
        c, s = _trig(rfp.snd_ramp_comp, dev)
        c, s = c * sign, s * sign
    zr, zi = zc.real, zc.imag
    return zr * c + zi * s, zi * c - zr * s


def _discriminate(rfp: RFPlan, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact phase-difference FM discriminator along the last axis, in
    audio units: ``atan2`` of ``z[t] conj(z[t-1])``, the first sample held
    (its step is exactly 0)."""
    ip = torch.cat([i[..., :1], i[..., :-1]], dim=-1)
    qp = torch.cat([q[..., :1], q[..., :-1]], dim=-1)
    dphi = torch.atan2(ip * q - i * qp, i * ip + q * qp)
    return dphi * f32(rfp.plan.fs / (2.0 * np.pi * rfp.snd_dev))


def rf_demodulate_sound(rfp: RFPlan, rf: torch.Tensor, frame0=0,
                        freq_error: float = 0.0) -> torch.Tensor:
    """Intercarrier FM sound takeoff: RF (B, L, N*r) -> audio (B, L*N).

    The sound band-pass, quadrature mix and I/Q low-pass as one composed
    complex filter decimated to the composite rate, the carrier rotation
    there, the exact phase-difference discriminator, then the audio
    low-pass by overlap-save (``fir_stream``).  ``freq_error`` (Hz, from
    :func:`recover_carrier_frequency`) tracks a mistuned transmitter;
    untracked, an offset ``df`` reads as an audio DC of ``df / snd_dev``.
    """
    b, l, n_rf = rf.shape
    n = rfp.row_samples
    zc = conv_decim_stream(rf.reshape(b, l * n_rf), rfp.snd_dem_taps(freq_error),
                           rfp.r).reshape(b, l, n)
    i, q = _snd_rotate(rfp, zc, frame0, freq_error)
    audio = _discriminate(rfp, i.reshape(b, l * n), q.reshape(b, l * n))
    return fir_stream(audio, rfp.aud_lpf)


def sound_on_rf(rfp: RFPlan, rf: torch.Tensor, frame0, audio, phi0=0.0) -> torch.Tensor:
    """Add the FM sound carrier treating the batch as one contiguous
    broadcast (the chunked video transmitter).

    The zero-order hold, the deviation phase and the carrier run over the
    joined (B*L*N*r) stream, so consecutive frames keep one phase law.
    ``phi0`` (radians; a float or a 0-d tensor) is the deviation phase
    accumulated before this chunk: the runner takes it from the whole
    track's float64 prefix sum, reduced mod 2 pi, so any chunking rebuilds
    the same law.  ``audio``: (B, L*N) in [-1, 1] at the composite rate.
    """
    b, l, n_rf = rf.shape
    dev = rf.device
    a_rf = _hold(torch.as_tensor(audio, dtype=torch.float32, device=dev).reshape(
        1, b * l * rfp.row_samples), rfp.r)
    dphi = f32(TWO_PI * rfp.snd_dev / rfp.fs_rf) * a_rf
    phi_dev = _deviation_phase(dphi, n_rf, phi0)
    phi = _upload(rfp.snd_ramp, dev).expand(b, l, n_rf).reshape(1, b * l * n_rf) + phi_dev
    snd = torch.cos(phi).reshape(b, l, n_rf) * _row_sign(frame0, b, l, dev)[:, :, None]
    return rf + rfp.snd_amp * snd


def _sound_disc(rfp: RFPlan, rf: torch.Tensor, frame0) -> torch.Tensor:
    """Joined-chunk discriminator: RF (B, L, N*r) -> the instantaneous audio
    (1, B*L*N) before the audio low-pass."""
    b, l, n_rf = rf.shape
    n = rfp.row_samples
    zc = conv_decim_stream(rf.reshape(1, b * l * n_rf), rfp.snd_dem_taps(),
                           rfp.r).reshape(b, l, n)
    i, q = _snd_rotate(rfp, zc, frame0, 0.0)
    return _discriminate(rfp, i.reshape(1, b * l * n), q.reshape(1, b * l * n))


def sound_from_rf(rfp: RFPlan, rf: torch.Tensor, frame0=0) -> torch.Tensor:
    """Contiguous-batch sound takeoff, the mirror of :func:`sound_on_rf`:
    RF (B, L, N*r) -> audio (B, L*N).  Every stream filter runs over the
    joined chunk, so only the chunk's edges carry filter warm-up (the
    runner hides them under its one-frame overlap)."""
    b, l, _ = rf.shape
    audio = _sound_disc(rfp, rf, frame0)
    return fir_stream(audio, rfp.aud_lpf).reshape(b, l * rfp.row_samples)


def sound_from_rf_halo(rfp: RFPlan, rf: torch.Tensor, frame0=0, halo: int = 1,
                       head_dead=None, tail_dead=None) -> torch.Tensor:
    """Sound takeoff on a frame-halo-extended chunk (B+2*halo, L, N*r) ->
    audio (B, L*N) of the own frames only: the receive side of a sharded
    hop.  The stream filters see the ``halo`` neighbour frames on each
    side, and the result crops them.

    ``head_dead`` / ``tail_dead`` (Python bools or 0-d bool tensors): the
    halo before the global first / after the global last frame carries no
    signal.  The discriminator output there (and at the first own sample,
    whose predecessor is dead) is zeroed before the audio low-pass, which
    reproduces what the unsharded chunk's zero padding past its stream
    ends gives.
    """
    b_ext, l, _ = rf.shape
    n = rfp.row_samples
    b = b_ext - 2 * halo
    audio = _sound_disc(rfp, rf, frame0)                  # (1, b_ext*l*n)
    if head_dead is not None or tail_dead is not None:
        pos = torch.arange(b_ext * l * n, dtype=torch.int32, device=rf.device)[None, :]
        keep = torch.ones_like(audio, dtype=torch.bool)
        if head_dead is not None:
            keep &= ~(head_dead & (pos < halo * l * n + 1))
        if tail_dead is not None:
            keep &= ~(tail_dead & (pos >= (halo + b) * l * n))
        audio = torch.where(keep, audio, 0.0)
    out = fir_stream(audio, rfp.aud_lpf).reshape(b_ext, l * n)
    return out[halo : halo + b]


def rf_roundtrip(rfp: RFPlan, comp: torch.Tensor, frame0=0, audio=None):
    """modulate -> demodulate: the recovered composite, or ``(composite,
    audio)`` when an ``audio`` stream is sent."""
    rf = rf_modulate(rfp, comp, frame0, audio)
    out = rf_demodulate(rfp, rf, frame0)
    if audio is None:
        return out
    return out, rf_demodulate_sound(rfp, rf, frame0)
