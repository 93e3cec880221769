"""Broadcast test and measurement: test signals, readouts and instrument images.

Port of ``color_modem_tpu/frame/measure.py``.  Analog plants were qualified
with standard test signals driven through the chain and read off a
vectorscope or waveform monitor:

    rgb  = modulated_staircase(plan, lines, samples)
    comp = impair(plan, encode(rgb), diff_phase_deg=20.0, ...)
    rep  = measure_differential(plan, comp, gline)
    rep["dp_deg"]   # ~20 * (luma span), the vectorscope DP number
    rep["dg"]       # (Amax - Amin) / Amax, the DG number

The stimuli (staircase, multiburst, pulse-and-bar) are host NumPy arrays,
like every reference signal.  The readouts run on the data's device and
bring their numbers back in one stacked fetch; every float32 product goes
through ``matmul_f32``, so no process-wide TF32 or bf16 setting touches
them.  The images (vectorscope, spectrum analyser, waveform monitor) fetch
what they draw once and render it on the host, in float64, as the JAX
package does.  The plan's buffers must lie on the data's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from color_modem_tpu_torch.dsp.apply import fir_same, matmul_f32
from color_modem_tpu_torch.modem import niir, qam
from color_modem_tpu_torch.modem.plan import QamPlan

#: luma levels of the staircase steps (near black to near white, so the
#: constant chroma on top never clips RGB out of [0, 1])
_STEP_LUMA = (0.10, 0.25, 0.40, 0.55, 0.70, 0.85)

#: multiburst packet frequencies, MHz (0.5 through the chroma region);
#: packets beyond ~0.45 fs are dropped per plan
MULTIBURST_MHZ = (0.5, 1.0, 2.0, 3.0, 3.58, 4.2)


def _is_niir(plan) -> bool:
    return plan.chroma.reference_amplitude is not None


def modulated_staircase(plan: QamPlan, n_lines: int, n_samples: int, c1: float = 0.06,
                        c2: float = 0.06) -> np.ndarray:
    """(3, L, N) float32 RGB: stepped luma with CONSTANT chroma (c1, c2) on
    top, the differential-distortion stimulus (any variation of the decoded
    chroma across the steps is the channel's)."""
    steps = len(_STEP_LUMA)
    idx = np.minimum((np.arange(n_samples) * steps) // n_samples, steps - 1)
    y = np.asarray(_STEP_LUMA)[idx]
    ycc = np.stack([y, np.full(n_samples, c1), np.full(n_samples, c2)])
    rgb = plan.host["ycc_to_rgb"] @ ycc
    if rgb.min() < -1e-6 or rgb.max() > 1.0 + 1e-6:
        raise ValueError(f"staircase chroma ({c1}, {c2}) clips RGB "
                         f"[{rgb.min():.3f}, {rgb.max():.3f}] — lower the amplitudes")
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.broadcast_to(rgb[:, None, :], (3, n_lines, n_samples)).astype(np.float32).copy()


def _burst_freqs(plan) -> list[float]:
    return [f for f in MULTIBURST_MHZ if f * 1e6 < 0.45 * plan.fs]


def multiburst(plan, n_lines: int, amplitude: float = 0.35) -> np.ndarray:
    """(3, L, N) float32 gray multiburst: a reference pedestal, then sine
    packets at :data:`MULTIBURST_MHZ` riding mid-gray, equal RGB (so the
    luma path carries all of it): the luma frequency-response stimulus."""
    freqs = _burst_freqs(plan)
    n = plan.n_samples
    width = n / (len(freqs) + 1)  # slot 0: the flat reference pedestal
    m = np.arange(n)
    y = np.full(n, 0.5)
    for i, f in enumerate(freqs):
        sel = (m >= (i + 1) * width + 0.15 * width) & (m < (i + 2) * width - 0.15 * width)
        y[sel] += amplitude * np.sin(2 * np.pi * f * 1e6 / plan.fs * m[sel])
    return np.broadcast_to(y, (3, n_lines, n)).astype(np.float32).copy()


@lru_cache(maxsize=16)
def _burst_basis(fs: float, n: int, freqs: tuple, device: torch.device) -> torch.Tensor:
    """(F, 3, N) float32 masked [sin, cos, 1] basis of every packet window
    (the inner 60% of its slot), on ``device``."""
    width = n / (len(freqs) + 1)
    m = np.arange(n, dtype=np.float64)
    wb = np.zeros((len(freqs), 3, n), np.float32)
    for i, f in enumerate(freqs):
        w = (m >= (i + 1) * width + 0.2 * width) & (m < (i + 2) * width - 0.2 * width)
        ang = 2.0 * np.pi * f * 1e6 / fs * m
        wb[i] = np.stack([np.sin(ang), np.cos(ang), np.ones(n)]) * w
    return torch.tensor(wb, device=device)


def measure_frequency_response(plan, luma: torch.Tensor, amplitude: float = 0.35) -> dict:
    """Per-packet gain of a decoded multiburst LUMA plane (..., L, N):
    ``{MHz: gain}``, 1.0 on a flat channel.

    Each packet window is projected by least squares onto its own
    ``[sin, cos, DC]`` basis (a plain quadrature correlation reads up to
    ~25% high on the low packets, whose windows hold a non-integer number
    of cycles); all the 3x3 systems solve at once, and the amplitudes come
    back in one fetch."""
    freqs = _burst_freqs(plan)
    n = luma.shape[-1]
    mean_line = luma.reshape(-1, n).to(torch.float32).mean(0)
    wb = _burst_basis(plan.fs, n, tuple(freqs), luma.device)
    gram = matmul_f32(wb, wb.transpose(-1, -2))       # (F, 3, 3)
    b = matmul_f32(wb, mean_line)                      # (F, 3)
    coef = torch.linalg.solve_ex(gram, b[..., None])[0][..., 0]
    amps = torch.hypot(coef[:, 0], coef[:, 1]).cpu().numpy()
    return {f: float(a) / amplitude for f, a in zip(freqs, amps)}


def _step_masks(n: int) -> np.ndarray:
    """(steps, N) float32 masks of the central 60% of each staircase step."""
    steps = len(_STEP_LUMA)
    width = n / steps
    m = np.arange(n)
    return np.stack([((m >= k * width + 0.2 * width) & (m < (k + 1) * width - 0.2 * width))
                     .astype(np.float32) for k in range(steps)])


@lru_cache(maxsize=16)
def _step_masks_on(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    masks = _step_masks(n)
    return torch.tensor(masks, device=device), torch.tensor(masks.sum(-1), device=device)


def _demodulated(plan: QamPlan, comp: torch.Tensor, gline: torch.Tensor):
    """The product detector's (c1, c2) of a composite's chroma band."""
    chroma_band = fir_same(comp.to(torch.float32), plan.chroma_bpf_mat)
    return qam.demodulate_carrier(plan, chroma_band, gline)


def measure_differential(plan: QamPlan, comp: torch.Tensor, gline: torch.Tensor) -> dict:
    """Vectorscope readout of a (..., L, N) staircase composite.

    The complex chroma vector, averaged over the central 60% of each step
    and over all lines of one V-switch parity (on PAL a phase error shows
    as +t on one parity and -t on the other, and averaging both would
    cancel it), relative to the bottom step:

    * ``dg``: differential gain, ``(Amax - Amin) / Amax``;
    * ``dp_deg``: differential phase, max minus min step phase;
    * ``step_gain`` / ``step_phase_deg``: the per-step curves.

    NIIR reads through the decoder's reference normalisation over its
    chroma lines only, so its numbers are the residual after correction.
    """
    if plan.cfg.is_fm:
        raise ValueError(f"{plan.cfg.name}: differential gain/phase is a QAM-standard "
                         "measurement (SECAM FM is immune by design)")
    c1, c2 = _demodulated(plan, comp, gline)
    n = comp.shape[-1]
    masks, mask_sums = _step_masks_on(n, comp.device)
    if _is_niir(plan):
        c1, c2 = niir.normalize(plan, c1, c2, gline)
        sel = niir.is_chroma_line(gline).to(torch.float32)[..., None]
    else:
        sel = (qam.v_sign(plan, gline) > 0.0).to(torch.float32)[..., None]
    flat1 = (c1 * sel).reshape(-1, n)
    flat2 = (c2 * sel).reshape(-1, n)
    denom = mask_sums * torch.clamp_min(sel.sum(), 1.0)
    re = matmul_f32(masks, flat1.sum(0)) / denom
    im = matmul_f32(masks, flat2.sum(0)) / denom
    amp = torch.hypot(re, im)
    phase = torch.atan2(im, re)
    d = phase - phase[0]
    rel_phase = torch.rad2deg(torch.atan2(torch.sin(d), torch.cos(d)))
    gain = amp / torch.clamp_min(amp[0], 1e-9)
    dg = (amp.max() - amp.min()) / torch.clamp_min(amp.max(), 1e-9)
    dp = rel_phase.max() - rel_phase.min()
    got = torch.cat([dg[None], dp[None], gain, rel_phase]).cpu().numpy()
    steps = len(_STEP_LUMA)
    return {"dg": float(got[0]), "dp_deg": float(got[1]),
            "step_gain": got[2 : 2 + steps], "step_phase_deg": got[2 + steps :]}


# --- the ITU-R pulse-and-bar insertion test line ------------------------------

def _pb_T_seconds(plan) -> float:
    """The sine-squared unit time T: 125 ns on 525-line systems, 100 ns on
    625-line ones (ITU-R BT.628, T = 1/(2 BW) at 4 / 5 MHz)."""
    return 125e-9 if plan.cfg.total_lines == 525 else 100e-9


def _pb_layout(plan) -> dict:
    """Sample-index layout of the pulse-and-bar line, shared by the stimulus
    and the readouts; every window scales with the line length and T."""
    n = plan.n_samples
    ts = _pb_T_seconds(plan) * plan.fs  # T in samples
    lay = {
        "T": ts,
        "blank": (int(0.02 * n), int(0.08 * n)),
        "bar_rise": 0.10 * n,
        "bar_fall": 0.40 * n,
        "bar_win": (int(0.18 * n), int(0.34 * n)),
        "pulse_c": 0.55 * n,   # 2T pulse centre
        "p20_c": 0.78 * n,     # 20T modulated pulse centre
    }
    c = lay["pulse_c"]
    lay["pulse_win"] = (int(c - 3.0 * ts), int(c + 3.0 * ts) + 1)
    # the K-factor ring windows, 3T..20T either side of the pulse (the flat
    # graticule: the conservative bound)
    lay["ring_l"] = (int(c - 20.0 * ts), int(c - 3.0 * ts))
    lay["ring_r"] = (int(c + 3.0 * ts) + 1, int(c + 20.0 * ts) + 1)
    c2 = lay["p20_c"]
    lay["p20_win"] = (int(c2 - 25.0 * ts), int(c2 + 25.0 * ts) + 1)
    return lay


def pulse_and_bar(plan: QamPlan, n_lines: int, amplitude: float = 0.7) -> np.ndarray:
    """(3, L, N) float32 RGB pulse-and-bar insertion test line: a white bar
    with 4T sine-squared edges, a 2T sine-squared pulse, and a 20T pulse
    modulated by the subcarrier at equal amplitude (scaled by
    ``amplitude`` so the chroma stays inside RGB [0, 1])."""
    lay = _pb_layout(plan)
    n = plan.n_samples
    ts = lay["T"]
    m = np.arange(n, dtype=np.float64)

    def edge(t0):
        u = np.clip((m - t0) / (4.0 * ts), 0.0, 1.0)
        return np.sin(0.5 * np.pi * u) ** 2

    def sin2(center, tau):
        t = m - (center - 0.5 * tau)
        return np.where((t >= 0) & (t <= tau), np.sin(np.pi * np.clip(t, 0, tau) / tau) ** 2,
                        0.0)

    y = edge(lay["bar_rise"]) - edge(lay["bar_fall"])
    y += sin2(lay["pulse_c"], 4.0 * ts)          # half-amplitude duration 2T
    env = amplitude * sin2(lay["p20_c"], 40.0 * ts)
    cmag = 0.5 * env / np.sqrt(2.0)              # split across both components
    rgb = plan.host["ycc_to_rgb"] @ np.stack([y + 0.5 * env, cmag, cmag])
    if rgb.min() < -1e-6 or rgb.max() > 1.0 + 1e-6:
        raise ValueError(f"pulse-and-bar amplitude {amplitude} clips RGB "
                         f"[{rgb.min():.3f}, {rgb.max():.3f}] — lower it")
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.broadcast_to(rgb[:, None, :], (3, n_lines, n)).astype(np.float32).copy()


def _k_factor(lay: dict, mean_line: torch.Tensor):
    """(2T K-rating, pulse/bar ratio, bar height) of a mean line, tensors."""
    def win(name):
        lo, hi = lay[name]
        return mean_line[lo:hi]

    base = win("blank").mean()
    bar = torch.clamp_min(win("bar_win").mean() - base, 1e-6)
    ratio = (win("pulse_win").max() - base) / bar
    k_pb = (ratio - 1.0).abs() / 4.0
    ring = torch.maximum((win("ring_l") - base).abs().max(),
                         (win("ring_r") - base).abs().max()) / (4.0 * bar)
    return torch.maximum(k_pb, ring), ratio


def _chroma_lines_mean(plan, x: torch.Tensor, gline: torch.Tensor) -> torch.Tensor:
    """(rows, N) -> the mean row; NIIR averages its chroma lines only (the
    reference carrier rides every other line, blanking included)."""
    if _is_niir(plan):
        sel = niir.is_chroma_line(gline).to(torch.float32).reshape(-1)
        return matmul_f32(sel, x) / torch.clamp_min(sel.sum(), 1.0)
    return x.mean(0)


def measure_pulse_bar(plan: QamPlan, comp: torch.Tensor, gline: torch.Tensor,
                      amplitude: float = 0.7) -> dict:
    """Waveform-monitor readout of a (..., L, N) pulse-and-bar composite:

    * ``k2t_pct``: the 2T K-rating in percent, the larger of the pulse-to-bar
      inequality |P/B - 1|/4 and the echo reading max|r|/(4B) over the
      3T..20T windows beside the pulse;
    * ``pulse_bar_ratio``: P/B;
    * ``cl_gain``: chrominance/luminance gain inequality off the 20T pulse;
    * ``cl_delay_ns``: chrominance/luminance delay inequality, the centroid
      of the chroma envelope minus that of the low-passed luma envelope.

    Both 20T envelopes come through zero-phase FIRs (the plan's own chroma
    low-pass), so the readout adds no delay of its own.  One fetch.
    """
    if plan.cfg.is_fm:
        raise ValueError(f"{plan.cfg.name}: pulse-and-bar chroma inequality is a "
                         "QAM-standard measurement")
    lay = _pb_layout(plan)
    n = comp.shape[-1]
    x = comp.reshape(-1, n).to(torch.float32)
    mean_line = _chroma_lines_mean(plan, x, gline)
    k2t, ratio = _k_factor(lay, mean_line)

    c1, c2 = _demodulated(plan, comp, gline)
    env = _chroma_lines_mean(plan, torch.hypot(c1, c2).reshape(-1, n), gline)
    # the zero-phase low-pass strips the subcarrier, leaving the 20T LUMA
    # envelope (its own bandwidth, ~1/(40T), is well inside)
    luma = fir_same(mean_line, plan.c1_lpf_mat)
    lo, hi = lay["p20_win"]
    blo, bhi = lay["blank"]
    idx = torch.arange(lo, hi, dtype=torch.float32, device=comp.device)
    ce = torch.clamp_min(env[lo:hi] - env[blo:bhi].mean(), 0.0)
    le = torch.clamp_min(luma[lo:hi] - luma[blo:bhi].mean(), 0.0)
    cw, lw = ce * ce, le * le
    cen_c = (idx * cw).sum() / torch.clamp_min(cw.sum(), 1e-12)
    cen_l = (idx * lw).sum() / torch.clamp_min(lw.sum(), 1e-12)
    delay_ns = (cen_c - cen_l) / plan.fs * 1e9
    gain = ce.max() / torch.clamp_min(le.max(), 1e-9)
    k2t, ratio, gain, delay_ns = torch.stack([k2t, ratio, gain, delay_ns]).cpu().numpy()
    return {"k2t_pct": float(100.0 * k2t), "pulse_bar_ratio": float(ratio),
            "cl_gain": float(gain), "cl_delay_ns": float(delay_ns)}


def measure_k_rating(plan, luma: torch.Tensor) -> dict:
    """2T K-rating off a DECODED LUMA plane (..., L, N): the SECAM half of
    the pulse-and-bar instrument (SECAM's FM carrier rides every window at
    constant amplitude, so the raw waveform would rate it as ringing).
    Pass the decoded picture's Y plane.  One fetch."""
    n = luma.shape[-1]
    mean_line = luma.reshape(-1, n).to(torch.float32).mean(0)
    k2t, ratio = torch.stack(_k_factor(_pb_layout(plan), mean_line)).cpu().numpy()
    return {"k2t_pct": float(100.0 * k2t), "pulse_bar_ratio": float(ratio)}


# --- instrument images -----------------------------------------------------------

def bar_vectors(plan, amplitude: float = 0.75) -> np.ndarray:
    """(6, 2) chroma targets of the 75% colour bars (yellow, cyan, green,
    magenta, red, blue) in the standard's own (c1, c2) space: the graticule
    boxes of a vectorscope, from the plan's colorimetry."""
    bars = np.array([[1, 1, 0], [0, 1, 1], [0, 1, 0], [1, 0, 1], [1, 0, 0], [0, 0, 1]],
                    dtype=np.float64) * amplitude
    return (bars @ plan.host["rgb_to_ycc"].T)[:, 1:]


def vectorscope_image(plan: QamPlan, comp: torch.Tensor, gline: torch.Tensor,
                      size: int = 512) -> np.ndarray:
    """The vectorscope display: demodulated chroma samples accumulated as a
    green phosphor trace over the (c1, c2) plane (log brightness), with
    graticule boxes at the 75%-bar targets.  PAL shows both V-switch arms.
    Returns (size, size, 3) float32 RGB in [0, 1]; +c2 up, +c1 right."""
    if plan.cfg.is_fm:
        raise ValueError(f"{plan.cfg.name}: the vectorscope demodulates a QAM "
                         "subcarrier (SECAM is FM — use the FM deviation readout)")
    c1, c2 = _demodulated(plan, comp, gline)
    v_switch = bool(getattr(plan.chroma, "v_switch", False))
    if v_switch:
        c2 = c2 * qam.v_sign(plan, gline)[..., None]
    uv = torch.stack([c1, c2]).cpu().numpy().astype(np.float64)
    u, v = uv[0].ravel(), uv[1].ravel()
    targets = bar_vectors(plan)
    rmax = 1.35 * float(np.max(np.hypot(targets[:, 0], targets[:, 1])))
    hist, _, _ = np.histogram2d(v, u, bins=size, range=[[-rmax, rmax], [-rmax, rmax]])
    hist = hist[::-1]  # +c2 up
    img = _phosphor(hist, size)

    def _px(cu, cv):
        x = int(round((cu + rmax) / (2 * rmax) * (size - 1)))
        y = int(round((rmax - cv) / (2 * rmax) * (size - 1)))
        return np.clip(x, 0, size - 1), np.clip(y, 0, size - 1)

    grat = np.float32([0.35, 0.35, 0.35])
    cx, cy = _px(0.0, 0.0)
    img[cy, :] = np.maximum(img[cy, :], grat * 0.6)
    img[:, cx] = np.maximum(img[:, cx], grat * 0.6)
    arms = np.concatenate([targets, targets * np.array([1.0, -1.0])]) if v_switch else targets
    half = max(2, int(round(0.05 * size / 2)))
    for cu, cv in arms:
        x, y = _px(cu, cv)
        x0, x1 = max(x - half, 0), min(x + half, size - 1)
        y0, y1 = max(y - half, 0), min(y + half, size - 1)
        for yy in (y0, y1):
            img[yy, x0 : x1 + 1] = np.maximum(img[yy, x0 : x1 + 1], grat)
        for xx in (x0, x1):
            img[y0 : y1 + 1, xx] = np.maximum(img[y0 : y1 + 1, xx], grat)
    return img


def _phosphor(hist: np.ndarray, size: int) -> np.ndarray:
    """A dwell histogram as a green phosphor image (log brightness, as a
    CRT's follows dwell time)."""
    g = np.log1p(hist) / max(np.log1p(hist.max()), 1.0)
    img = np.zeros((size, size, 3), np.float32)
    img[..., 0] = 0.25 * g
    img[..., 1] = 0.95 * g
    img[..., 2] = 0.35 * g
    return img


def _host64(x) -> np.ndarray:
    return torch.as_tensor(x).detach().cpu().numpy().astype(np.float64)


def composite_spectrum(plan, comp) -> tuple[np.ndarray, np.ndarray]:
    """(freqs_hz, power_db) averaged spectrum of a (..., L, N) composite:
    one Hann-windowed power-of-two rfft over each concatenated line stream
    (per-line FFTs cannot resolve the fh-spaced comb teeth), power averaged
    over the leading axes, relative to the peak.  Fetched once, computed on
    the host in float64.  Feed a RASTERED composite: the fh comb belongs to
    the full line period."""
    x = _host64(comp)
    x = x.reshape(-1, x.shape[-2] * x.shape[-1])
    t = x.shape[-1]
    x = (x - x.mean(axis=-1, keepdims=True)) * np.hanning(t)
    nfft = 1 << int(np.ceil(np.log2(t)))
    p = np.mean(np.abs(np.fft.rfft(x, n=nfft, axis=-1)) ** 2, axis=0)
    freqs = np.fft.rfftfreq(nfft, d=1.0 / plan.fs)
    return freqs, 10.0 * np.log10(np.maximum(p, 1e-30) / max(p.max(), 1e-30))


def spectrum_image(plan, comp, size: int = 512, zoom_teeth: int = 16,
                   floor_db: float = -80.0) -> np.ndarray:
    """The spectrum analyser: the top panel 0..fs/2, the bottom panel zoomed
    to fsc +- ``zoom_teeth`` fh, where the luma/chroma comb interleave shows
    tooth by tooth; verticals at fsc and (in the zoom) every multiple of fh,
    rules every 20 dB.  Returns (size, size, 3) float32 RGB."""
    freqs, db = composite_spectrum(plan, comp)
    fh = plan.cfg.fh
    fsc = plan.cfg.chroma.fsc
    img = np.zeros((size, size, 3), np.float32)
    h = size // 2
    grat = np.float32([0.35, 0.35, 0.35])
    trace = np.float32([0.25, 0.95, 0.35])

    def _panel(y0, f_lo, f_hi):
        rows = h - 2
        sel = (freqs >= f_lo) & (freqs <= f_hi)
        f, d = freqs[sel], np.clip(db[sel], floor_db, 0.0)
        col = ((f - f_lo) / (f_hi - f_lo) * (size - 1)).astype(np.int64)
        peak = np.full(size, floor_db)  # per-column peak hold
        np.maximum.at(peak, col, d)
        top = np.clip((peak / floor_db * (rows - 1)).astype(np.int64), 0, rows - 1)
        yy = np.arange(rows)[:, None]
        fill, on = yy > top[None, :], yy == top[None, :]
        img[y0 : y0 + rows][fill] = np.maximum(img[y0 : y0 + rows][fill], 0.18 * trace)
        img[y0 : y0 + rows][on] = trace
        for k in range(1, 4):  # -20/-40/-60 dB rules
            y = y0 + int(rows * (20.0 * k / -floor_db))
            img[y] = np.maximum(img[y], grat * 0.6)
        if f_lo <= fsc <= f_hi:
            c = int((fsc - f_lo) / (f_hi - f_lo) * (size - 1))
            img[y0 : y0 + rows, c] = np.maximum(img[y0 : y0 + rows, c],
                                                np.float32([0.8, 0.5, 0.2]))

    _panel(0, 0.0, plan.fs / 2)
    f_lo, f_hi = fsc - zoom_teeth * fh, fsc + zoom_teeth * fh
    _panel(h + 2, f_lo, f_hi)
    k0 = int(np.ceil(f_lo / fh))
    while k0 * fh <= f_hi:  # the luma teeth, dim
        c = int((k0 * fh - f_lo) / (f_hi - f_lo) * (size - 1))
        img[h + 2 :, c] = np.maximum(img[h + 2 :, c], grat * 0.45)
        k0 += 1
    return img


def waveform_image(comp, size: int = 512, lo: float = -0.5, hi: float = 1.2) -> np.ndarray:
    """The waveform monitor: every line of a (..., L, N) composite overlaid
    as a phosphor trace (x along the line, y the amplitude in video units),
    with graticule lines at sync tip -0.4, blanking 0, 0.7 and peak white 1.
    Returns (size, size, 3) float32 RGB in [0, 1]."""
    x = _host64(comp)
    x = x.reshape(-1, x.shape[-1])
    n = x.shape[-1]
    col = np.arange(n) * size // n
    amp_bin = np.clip(((hi - x) / (hi - lo) * (size - 1)).astype(np.int64), 0, size - 1)
    hist = np.zeros((size, size), np.float64)
    np.add.at(hist, (amp_bin.ravel(), np.broadcast_to(col, x.shape).ravel()), 1.0)
    img = _phosphor(hist, size)
    grat = np.float32([0.35, 0.35, 0.35])
    for level, strength in ((-0.4, 0.9), (0.0, 1.0), (0.7, 0.5), (1.0, 0.9)):
        y = int(round((hi - level) / (hi - lo) * (size - 1)))
        if 0 <= y < size:
            img[y] = np.maximum(img[y], grat * strength)
    return img
