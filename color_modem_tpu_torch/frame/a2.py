"""A2 / Zweikanalton two-carrier stereo.

Port of ``color_modem_tpu/frame/a2.py``.  A2 sends a second FM sound
carrier beside the intercarrier sound of ``frame/rf.py``:

* carrier 1 (the normal sound): (L+R)/2, so a mono receiver hears the
  compatible sum;
* carrier 2, 15.5 line frequencies above carrier 1 at half its amplitude:
  the right channel (stereo) or a second program (dual);
* a pilot at 3.5 fh on carrier 2's multiplex, amplitude-modulated by the
  identification tone: fh/133 for stereo, fh/57 for dual, none for mono.

Carrier 2 sits 31 half-cycles per row above carrier 1, whose count is odd,
so it completes a whole number of cycles per row and its row-start phase
never alternates (no ``(-1)^row`` factor).  The pilot is 7 half-cycles per
row: a host float64 ramp times the row sign.  The ident tone's row-start
phase is ``(row mod div) / div`` cycles, exact at any video length.  Mode
detection is a least-squares fit of [DC, cos, sin] at each ident frequency
to the pilot envelope, the 3x3 normal equations in full float32
(``dsp/apply.py::full_float32``), whatever the process-wide TF32 setting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_fft, full_float32, matmul_f32
from color_modem_tpu_torch.dsp.nco import f32, sample_phase_ramp
from color_modem_tpu_torch.frame.rf import (
    RFPlan,
    _abs_rows,
    _deviation_phase,
    _discriminate,
    _hold,
    _row_sign,
    _trig,
    _upload,
)

TWO_PI = 2.0 * np.pi

#: carrier-2 offset above carrier 1, in half-cycles per row: 15.5 fh
OFFSET_HALF_CYCLES = 31
#: pilot frequency in half-cycles per row: 3.5 fh = 54.6875 kHz at 625/50
PILOT_HALF_CYCLES = 7
#: ident tone dividers of fh: stereo fh/133 = 117.49 Hz, dual fh/57 = 274.12 Hz
IDENT_DIV = {"stereo": 133, "dual": 57}
#: pilot FM deviation on carrier 2, Hz (+-2.5 kHz), and its AM depth by the
#: ident tone (50 %)
PILOT_DEV = 2.5e3
PILOT_AM = 0.5


@dataclasses.dataclass(frozen=True, eq=False)
class A2Plan:
    """Carrier-2 and pilot geometry over an RFPlan."""

    rfp: RFPlan
    f_snd2: float             # second sound carrier, Hz
    snd2_num: int             # half-cycles per row (= snd_num + 31)
    amp2: float               # carrier-2 amplitude vs peak picture carrier
    snd2_ramp: np.ndarray     # (N*r,) carrier-2 phase ramp, f64
    pilot_ramp: np.ndarray    # (N,) pilot phase ramp at the composite rate, f64
    bpf1: np.ndarray          # carrier-1 takeoff band-pass (fs_rf)
    bpf2: np.ndarray          # carrier-2 takeoff band-pass (fs_rf)
    snd_lpf: np.ndarray       # post-mix I/Q low-pass (fs_rf)
    pil_lpf: np.ndarray       # pilot-envelope low-pass (composite rate)

    @property
    def fh(self) -> float:
        return self.rfp.plan.fs / self.rfp.row_samples

    def ident_hz(self, mode: str) -> float:
        return self.fh / IDENT_DIV[mode]


def make_a2_plan(rfp: RFPlan) -> A2Plan:
    """Design the A2 second-carrier geometry over ``rfp`` (the JAX
    package's design, bit-identical).  The two takeoff band-passes are
    +-100 kHz with 70 kHz skirts, narrower than ``rfp.snd_bpf``, so each
    discriminator's capture clears the neighbour."""
    fs_rf = rfp.fs_rf
    n = rfp.row_samples
    snd2_num = rfp.snd_num + OFFSET_HALF_CYCLES
    f_snd2 = snd2_num / 2 * rfp.plan.fs / n
    half = rfp.snd_dev + 15e3 + 35e3          # Carson half-width + margin
    skirt = 70e3
    if f_snd2 + half + skirt > fs_rf / 2 - 0.2e6:
        raise ValueError(
            f"A2 carrier 2 at {f_snd2/1e6:.3f} MHz does not fit under RF "
            f"Nyquist {fs_rf/2e6:.2f} MHz — raise r")
    ntaps = 4097
    bpf1 = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(
            f, rfp.f_snd - half, rfp.f_snd + half, skirt),
        ntaps,
    )
    bpf2 = design.freq_sampled_taps(
        fs_rf,
        lambda f: design.raised_cosine_bandpass_response(f, f_snd2 - half, f_snd2 + half, skirt),
        ntaps,
    )
    snd_lpf = design.lowpass_taps(fs_rf, half + 30e3, ntaps)
    # passes the ident tones (117/274 Hz), stops the 2x-pilot image (~109 kHz)
    pil_lpf = design.lowpass_taps(rfp.plan.fs, 2e3, 8193)
    return A2Plan(
        rfp=rfp, f_snd2=f_snd2, snd2_num=snd2_num, amp2=rfp.snd_amp / 2,
        snd2_ramp=sample_phase_ramp(f_snd2, fs_rf, n * rfp.r),
        pilot_ramp=sample_phase_ramp(PILOT_HALF_CYCLES / 2 * rfp.plan.fs / n, rfp.plan.fs, n),
        bpf1=bpf1, bpf2=bpf2, snd_lpf=snd_lpf, pil_lpf=pil_lpf,
    )


def _ident_phase_rows(a2p: A2Plan, mode: str, rows: torch.Tensor) -> torch.Tensor:
    """(..., N) ident-tone phase for an absolute-row index tensor: the
    row-start phase is ``(row mod div) / div`` cycles, exact; the within-row
    ramp is host float64."""
    n = a2p.rfp.row_samples
    div = IDENT_DIV[mode]
    start = torch.remainder(rows, div).to(torch.float32) / float(div)
    in_row = _upload(TWO_PI * np.mod(np.arange(n, dtype=np.float64) / (n * div), 1.0),
                     rows.device)
    return (TWO_PI * start)[..., None] + in_row


def _ident_phase(a2p: A2Plan, mode: str, frame0, b: int, l: int, device) -> torch.Tensor:
    """(B, L, N) ident-tone phase, keyed on the absolute row index."""
    return _ident_phase_rows(a2p, mode, _abs_rows(frame0, b, l, device))


def a2_multiplex(a2p: A2Plan, audio2, mode: str, frame0, b: int, l: int) -> torch.Tensor:
    """Carrier 2's modulating signal: audio plus the AM-ident pilot (B, L*N)."""
    n = a2p.rfp.row_samples
    audio2 = torch.as_tensor(audio2, dtype=torch.float32)
    dev = audio2.device
    pilot = _trig(a2p.pilot_ramp, dev)[0][None, None, :] * _row_sign(frame0, b, l, dev)[:, :, None]
    am = 1.0 + PILOT_AM * torch.cos(_ident_phase(a2p, mode, frame0, b, l, dev))
    pil = (PILOT_DEV / a2p.rfp.snd_dev) * (am * pilot).reshape(b, l * n)
    return audio2 + pil


def _carrier2_sign(a2p: A2Plan, frame0, b: int, l: int, device) -> torch.Tensor:
    """Row-start sign of carrier 2: ``(-1)^row`` only if its half-cycle
    count is odd (an integer-cycles-per-row carrier never alternates)."""
    if a2p.snd2_num % 2:
        return _row_sign(frame0, b, l, device)[:, :, None]
    return torch.ones(b, l, 1, dtype=torch.float32, device=device)


def a2_on_rf(a2p: A2Plan, rf: torch.Tensor, frame0, audio2, mode: str = "stereo") -> torch.Tensor:
    """Add the A2 second sound carrier to an RF block (B, L, N*r).

    ``audio2``: (B, L*N) in [-1, 1], the right channel (stereo) or the
    second program (dual); carrier 1 comes from ``rf_modulate(...,
    audio=...)``.  ``mode`` picks the ident tone; mono is not calling this.
    """
    rfp = a2p.rfp
    b, l, n_rf = rf.shape
    dev = rf.device
    mux = a2_multiplex(a2p, torch.as_tensor(audio2, device=dev), mode, frame0, b, l)
    a_rf = _hold(mux, rfp.r)   # zero-order hold, as rf_modulate's sound
    dphi = f32(TWO_PI * rfp.snd_dev / rfp.fs_rf) * a_rf
    phi = _upload(a2p.snd2_ramp, dev)[None, None, :] + _deviation_phase(
        dphi, n_rf).reshape(b, l, n_rf)
    snd = torch.cos(phi) * _carrier2_sign(a2p, frame0, b, l, dev)
    return rf + a2p.amp2 * snd


def _takeoff(a2p: A2Plan, rf: torch.Tensor, bpf, ramp, frame0, sign=None):
    """FM-discriminate one sound carrier -> (raw audio (B, L*N), carrier
    level (B,)): band-pass, I/Q mix and low-pass (each a padded FFT
    filter), every r-th sample, the exact phase-difference discriminator.
    The level is the mean I/Q magnitude, the receiver's carrier-presence
    meter (a discriminator with no carrier sprays full-scale noise)."""
    rfp = a2p.rfp
    b, l, n_rf = rf.shape
    n = rfp.row_samples
    dev = rf.device
    xs = fir_same_fft(rf.reshape(b, l * n_rf), bpf)
    if sign is None:
        sign = _row_sign(frame0, b, l, dev)[:, :, None]
    cr, sr = _trig(ramp, dev)
    c = (cr * sign).reshape(b, l * n_rf)
    s = (sr * sign).reshape(b, l * n_rf)
    i = fir_same_fft(xs * (2.0 * c), a2p.snd_lpf)
    q = fir_same_fft(xs * (-2.0 * s), a2p.snd_lpf)
    i = i.reshape(b, l, n, rfp.r)[..., 0].reshape(b, l * n)
    q = q.reshape(b, l, n, rfp.r)[..., 0].reshape(b, l * n)
    level = torch.mean(torch.sqrt(i * i + q * q), dim=-1)
    return _discriminate(rfp, i, q), level


def a2_detect_mode(a2p: A2Plan, raw2: torch.Tensor, frame0, b: int, l: int, group: int = 1):
    """Pilot and ident detection from carrier 2's raw discriminator output.

    Returns ``(pilot_level, powers, resid)`` (B,) tensors: the pilot level
    in multiplex units (sent: PILOT_DEV/snd_dev = 0.05), the fitted ident
    amplitude per candidate (sent: half the pilot level) and each
    candidate's normalised fit residual, which decides (the amplitudes
    alone cannot, at sub-cycle windows).  ``group``: decide over groups of
    consecutive batch items, 2 for an interlaced run's field pairs; each
    group's statistic repeats over its members.
    """
    rfp = a2p.rfp
    n = rfp.row_samples
    if b % group:
        raise ValueError(f"a2_detect_mode: group={group} must divide b={b}")
    bg, lg = b // group, group * l
    dev = raw2.device
    # absolute rows of the grouped blocks: the block starts at row frame0*l
    start = (frame0.to(device=dev, dtype=torch.int32) * l if isinstance(frame0, torch.Tensor)
             else int(frame0) * l)
    rows = (start + torch.arange(bg, dtype=torch.int32, device=dev)[:, None] * lg
            + torch.arange(lg, dtype=torch.int32, device=dev)[None, :])
    sign = (1.0 - 2.0 * torch.remainder(rows, 2).to(torch.float32))[:, :, None]
    pilot, qpil = _trig(a2p.pilot_ramp, dev)
    raw2g = raw2.reshape(bg, lg * n)
    pc = (pilot * sign).reshape(bg, lg * n)
    ps = (qpil * sign).reshape(bg, lg * n)
    # the pilot-envelope filter runs on the joined group stream
    i = fir_same_fft(raw2g * (2.0 * pc), a2p.pil_lpf)
    q = fir_same_fft(raw2g * (-2.0 * ps), a2p.pil_lpf)
    env = torch.sqrt(i * i + q * q)            # (Bg, Lg*N): the pilot AM envelope
    level = torch.mean(env, dim=-1)
    t = lg * n
    powers, resid = {}, {}
    for mode in ("stereo", "dual"):
        ph = _ident_phase_rows(a2p, mode, rows).reshape(bg, t)
        g = torch.stack([torch.ones_like(ph), torch.cos(ph), torch.sin(ph)], dim=-1)  # (Bg, T, 3)
        gt = g.transpose(1, 2)
        a = matmul_f32(gt, g) / t
        c = matmul_f32(gt, env[..., None])[..., 0] / t
        with full_float32():
            coef = torch.linalg.solve_ex(a, c[..., None])[0][..., 0]           # (Bg, 3)
        powers[mode] = torch.sqrt(coef[:, 1] ** 2 + coef[:, 2] ** 2)
        # normalised residual power of the fit: mean(env^2) - c . coef
        resid[mode] = torch.mean(env * env, dim=-1) - torch.sum(c * coef, dim=-1)
    if group > 1:
        level = _hold(level, group)
        powers = {k: _hold(v, group) for k, v in powers.items()}
        resid = {k: _hold(v, group) for k, v in resid.items()}
    return level, powers, resid


def _decode_arrays(a2p: A2Plan, rf: torch.Tensor, frame0, group: int = 1):
    """The tensor half of :func:`a2_decode`: both takeoffs, the mode
    statistics and the audio low-pass, all on ``rf``'s device."""
    rfp = a2p.rfp
    b, l, _ = rf.shape
    m, _ = _takeoff(a2p, rf, a2p.bpf1, rfp.snd_ramp, frame0)
    raw2, c2_level = _takeoff(a2p, rf, a2p.bpf2, a2p.snd2_ramp, frame0,
                              sign=_carrier2_sign(a2p, frame0, b, l, rf.device))
    pilot, powers, resid = a2_detect_mode(a2p, raw2, frame0, b, l, group)
    m = fir_same_fft(m, rfp.aud_lpf)
    r2 = fir_same_fft(raw2, rfp.aud_lpf)     # aud_lpf also strips the pilot
    return m, r2, c2_level, pilot, powers, resid


def a2_decode(a2p: A2Plan, rf: torch.Tensor, frame0=0, group: int = 1):
    """RF block -> ``(left, right, info)``: the full A2 receiver.

    Dematrixes with the detected mode: stereo -> (2M - R, R); dual -> the
    two programs as they are; mono (carrier 2's level under 0.3 of its
    amplitude, the threshold rounded to float32) -> carrier 1 on both.
    ``left``/``right`` stay on ``rf``'s device.  The mode is decided on the
    host from one stacked fetch of the per-item statistics; ``info`` holds
    them as NumPy arrays and the mode string per item.  ``group``: the
    mode-detection window in consecutive batch items (2 for interlaced
    field pairs).
    """
    m, r2, c2_level, pilot, powers, resid = _decode_arrays(a2p, rf, frame0, group)
    thresh = np.float32(0.3 * a2p.amp2)
    is_mono = c2_level < float(thresh)
    is_stereo = ~is_mono & (resid["stereo"] <= resid["dual"])
    left = torch.where(is_stereo[:, None], 2.0 * m - r2, m)
    right = torch.where(is_mono[:, None], m, r2)
    stats = torch.stack([c2_level, pilot, powers["stereo"], powers["dual"],
                         resid["stereo"], resid["dual"]]).cpu().numpy()
    c2, pil, p_st, p_du, r_st, r_du = stats
    modes = ["mono" if c2[i] < thresh else "stereo" if r_st[i] <= r_du[i] else "dual"
             for i in range(c2.shape[0])]
    info = {"mode": modes, "carrier2_level": c2, "pilot_level": pil,
            "ident_power": {"stereo": p_st, "dual": p_du},
            "ident_resid": {"stereo": r_st, "dual": r_du}}
    return left, right, info
