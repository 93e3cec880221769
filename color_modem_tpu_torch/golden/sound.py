"""GOLDEN ORACLE — naive analog sound chains (VERDICT r3 item 4).

The port's copy of ``color_modem_tpu/golden/sound.py``: the same NumPy
code on the port's RFPlan, SatPlan and A2Plan, its outputs equal to the
JAX package's oracle bit for bit (``tests/test_torch_golden.py``).

Frozen per-sample NumPy float64 models of the analog SOUND cores, in the
style of golden/transmission.py: deliberately UNCOMPOSED filter-mix-
filter cascades with ``np.convolve(..., 'same')``, carrier phases
evaluated directly on the absolute sample index in f64, rectangle/
midpoint FM integrals exactly as the module contracts state them — no
modulation-identity tap composition, no overlap-save blocking, no
closed-form (-1)^row phase factoring.  Covered chains and their JAX
counterparts (parity certified by tests/test_golden_sound.py):

* intercarrier FM sound on/off the RF stream —
  frame/rf.py ``sound_on_rf`` / ``sound_from_rf`` (the chunked-video
  transmitter/receiver; ``rf_modulate(audio=)`` / ``rf_demodulate_sound``
  share the same taps and per-item math);
* the MTS/BTSC stereo multiplex (pilot at fh + DSB-SC difference at
  2 fh) — frame/mts.py ``mts_encode`` / ``mts_decode``;
* satellite FM audio subcarriers (pre-emphasis, per-frame circular FM
  on integer-cycles-per-frame carriers, subcarrier takeoff) — frame/
  satellite.py ``fm_modulate(audio=)`` / ``fm_demodulate_audio``;
* A2/Zweikanalton's second sound carrier with its AM-ident pilot —
  frame/a2.py ``a2_on_rf`` and the carrier-2 takeoff.

Without this oracle a regression that shifted an encoder and its decoder
CONSISTENTLY would keep passing the physics-asserting SNR/separation
tests (golden/transmission.py's own scope note); with it, either
direction's parity breaks.

Shared-taps tradeoff (same as golden/transmission.py): filter TAPS come
from the caller's RFPlan/SatPlan/A2Plan (design-time host numpy) — the
oracle checks the pipeline MATH, not a second filter design.  The plans
are duck-typed; this module imports nothing from frame/ and no JAX
(package rule), so the A2 pilot/ident constants are duplicated below.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi

# --------------------------------------------------------------------------
# shared naive helpers
# --------------------------------------------------------------------------


def _conv_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """'same'-centered convolution per stream (odd taps), f64, any number
    of leading axes."""
    t = np.asarray(taps, np.float64)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).astype(np.float64)
    return np.stack(
        [np.convolve(row, t, mode="same") for row in x2]
    ).reshape(lead + (x.shape[-1],))


def _wrap_filter(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Circular 'same' filter: wrap-pad by the (8-rounded) half-width,
    convolve, crop — the naive mirror of satellite._wrap_filter."""
    t = np.asarray(taps, np.float64)
    n = x.shape[-1]
    p = -(-(len(t) // 2 + 1) // 8) * 8
    xp = np.concatenate([x[..., -p:], x, x[..., :p]], axis=-1)
    return _conv_same(xp, t)[..., p : p + n]


def _abs_phase(f: float, fs: float, m0: int, count: int) -> np.ndarray:
    """2*pi*frac(f/fs * m) on absolute sample indices m0..m0+count, exact
    f64 reduction BEFORE the trig (golden/transmission._carrier_cos
    convention: m stays < 2^53)."""
    m = np.arange(m0, m0 + count, dtype=np.float64)
    cyc = (f / fs) * m
    return TWO_PI * (cyc - np.floor(cyc))


def _prev_held(x: np.ndarray) -> np.ndarray:
    """x delayed one sample with the first sample edge-held (the
    discriminators' z[t-1] convention in frame/rf.py)."""
    return np.concatenate([x[..., :1], x[..., :-1]], axis=-1)


def _discriminate(i: np.ndarray, q: np.ndarray, fs: float,
                  dev: float) -> np.ndarray:
    """Exact phase-difference FM discriminator: atan2 of z[t]*conj(z[t-1])
    scaled to audio units (frame/rf.py::rf_demodulate_sound math)."""
    ip, qp = _prev_held(i), _prev_held(q)
    dphi = np.arctan2(ip * q - i * qp, i * ip + q * qp)
    return dphi * (fs / (TWO_PI * dev))


# --------------------------------------------------------------------------
# intercarrier FM sound on the RF stream (frame/rf.py sound_on_rf /
# sound_from_rf — the contiguous-batch chunked-video sound paths)
# --------------------------------------------------------------------------


def sound_on_rf(rfp, rf: np.ndarray, frame0: int, audio: np.ndarray,
                phi0: float = 0.0) -> np.ndarray:
    """RF (B, L, N*r) + audio (B, L*N) -> RF with the FM sound carrier,
    naive chain over the JOINED batch stream: zero-order-hold upsample,
    rectangle-rule deviation integral (cumsum) seeded with ``phi0``, the
    sound carrier's phase evaluated on the absolute RF sample index."""
    b, l, n_rf = rf.shape
    r = rfp.r
    a_rf = np.repeat(
        np.asarray(audio, np.float64).reshape(b * l * rfp.row_samples), r
    )
    dphi = (TWO_PI * rfp.snd_dev / rfp.fs_rf) * a_rf
    phi_dev = np.cumsum(dphi) + float(phi0)
    ph_c = _abs_phase(rfp.f_snd, rfp.fs_rf, frame0 * l * n_rf, b * l * n_rf)
    snd = np.cos(ph_c + phi_dev)
    return rf.astype(np.float64) + rfp.snd_amp * snd.reshape(b, l, n_rf)


def sound_from_rf(rfp, rf: np.ndarray, frame0: int = 0) -> np.ndarray:
    """RF (B, L, N*r) -> audio (B, L*N), naive chain over the JOINED
    batch stream: sound band-pass, quadrature mix against the absolute-
    sample carrier, separate I/Q low-passes, strided decimation to the
    composite rate, exact phase-difference discriminator, audio
    low-pass."""
    b, l, n_rf = rf.shape
    r = rfp.r
    n_tot_rf = b * l * n_rf
    xs = _conv_same(rf.reshape(1, n_tot_rf), rfp.snd_bpf)[0]
    ph = _abs_phase(rfp.f_snd, rfp.fs_rf, frame0 * l * n_rf, n_tot_rf)
    i = _conv_same((xs * (2.0 * np.cos(ph)))[None], rfp.snd_lpf)[0, ::r]
    q = _conv_same((xs * (-2.0 * np.sin(ph)))[None], rfp.snd_lpf)[0, ::r]
    audio = _discriminate(i, q, rfp.plan.fs, rfp.snd_dev)
    audio = _conv_same(audio[None], rfp.aud_lpf)[0]
    return audio.reshape(b, l * rfp.row_samples)


# --------------------------------------------------------------------------
# MTS/BTSC stereo multiplex (frame/mts.py)
# --------------------------------------------------------------------------

#: pilot amplitude (duplicated from frame/mts.py by the no-frame-imports
#: rule: BTSC's 5 kHz-of-25 kHz pilot deviation = 0.2, kept at 0.1 here)
MTS_PILOT_AMP = 0.1


def _mts_phase(n_row: int, n_t: int) -> np.ndarray:
    """2*pi*fh*t on the composite grid: fh = exactly one cycle per
    ``n_row``-sample row, phase = 2*pi*(t mod n)/n in exact arithmetic."""
    t = np.arange(n_t, dtype=np.float64)
    return (TWO_PI / n_row) * np.mod(t, n_row)


def mts_encode(n_row: int, left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Stereo pair (B, T) -> MTS baseband (B, T): (L+R)/2 + pilot at fh +
    DSB suppressed-carrier (L-R)/2 at 2 fh."""
    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    ph = _mts_phase(n_row, left.shape[-1])[None, :]
    s = 0.5 * (left + right)
    d = 0.5 * (left - right)
    return s + MTS_PILOT_AMP * np.sin(ph) + d * (2.0 * np.cos(2.0 * ph))


def mts_decode(n_row: int, taps: np.ndarray, a: np.ndarray):
    """MTS baseband (B, T) -> (left, right, pilot_level): sum = low-pass,
    difference = coherent DSB-SC product against the exact 2 fh carrier,
    pilot level = correlated pilot amplitude."""
    a = np.asarray(a, np.float64)
    ph = _mts_phase(n_row, a.shape[-1])[None, :]
    s = _conv_same(a, taps)
    d = _conv_same(a * np.cos(2.0 * ph), taps)
    pilot = 2.0 * np.mean(a * np.sin(ph), axis=-1)
    return s + d, s - d, pilot


# --------------------------------------------------------------------------
# satellite FM audio subcarriers (frame/satellite.py fm_modulate(audio=) /
# fm_demodulate_audio)
# --------------------------------------------------------------------------

#: stream-edge wrap margin at the baseband rate (satellite._EDGE_PAD)
_EDGE_PAD = 256


def _sub_phase(k_cycles: int, n_total: int) -> np.ndarray:
    """Phase of a subcarrier completing EXACTLY ``k_cycles`` over the
    frame stream (satellite._sub_trig law: integer product reduced mod
    n_total before the divide)."""
    return (TWO_PI / n_total) * np.mod(
        k_cycles * np.arange(n_total, dtype=np.float64), n_total
    )


def _sat_audio_mux(sp, audio: np.ndarray, l: int) -> np.ndarray:
    """(B, K, L*n_base) audio -> subcarrier multiplex (B, L*n_base):
    50 us pre-emphasis, per-frame circular FM per subcarrier (deviation
    phase closed mod 2 pi over the frame), midpoint integral."""
    a = np.asarray(audio, np.float64)
    if a.ndim == 2:
        a = a[:, None, :]
    n_tot = l * sp.n_base
    a = _wrap_filter(a, sp.aud_pre)
    out = np.zeros((a.shape[0], n_tot), np.float64)
    for j, f in enumerate(sp.sub_freqs):
        k_cyc = int(round(f * n_tot / sp.base_fs))
        dphi = (TWO_PI * sp.sub_dev / sp.base_fs) * a[:, j]
        tot = np.sum(dphi, axis=-1, keepdims=True) % TWO_PI
        tot = np.where(tot > np.pi, tot - TWO_PI, tot)
        dphi = dphi - tot / n_tot
        phi = np.cumsum(dphi, axis=-1) - 0.5 * dphi
        out = out + sp.sub_amp * np.cos(_sub_phase(k_cyc, n_tot)[None] + phi)
    return out


def sat_fm_modulate_audio(sp, base: np.ndarray,
                          audio: np.ndarray) -> np.ndarray:
    """Baseband video (B, L, N) + audio (B, K, L*N) -> satellite FM at IF
    (B, L, N*r), naive chain: pre-emphasis then multiplex low-pass as
    SEPARATE circular filters, + the audio subcarrier multiplex, explicit
    zero-stuff + interp low-pass, midpoint FM integral with the per-frame
    phase closure, carrier at exactly fs_rf/4 (the golden/transmission.py
    fm_modulate chain with the sound multiplex added at the modulator
    input — duplicated here because that module is frozen without an
    audio input)."""
    b, l, n = base.shape
    r = sp.r
    v = _wrap_filter(base.reshape(b, l * n), sp.pre_taps)
    v = _wrap_filter(v, sp.mux_lpf)
    v = v + _sat_audio_mux(sp, audio, l)
    pb = _EDGE_PAD
    vp = np.concatenate([v[:, -pb:], v, v[:, :pb]], axis=-1)
    stuffed = np.zeros((b, vp.shape[-1] * r), np.float64)
    stuffed[:, ::r] = r * vp
    v_rf = _conv_same(stuffed, sp.interp_taps)[:, pb * r : pb * r + l * n * r]

    dphi = (TWO_PI * sp.deviation / sp.fs_rf) * (v_rf - sp.center)
    tot = np.sum(dphi, axis=-1, keepdims=True) % TWO_PI
    tot = np.where(tot > np.pi, tot - TWO_PI, tot)
    dphi = dphi - tot / (l * n * r)
    phi = np.cumsum(dphi, axis=-1) - 0.5 * dphi
    m = np.arange(l * n * r, dtype=np.float64)
    return np.cos(TWO_PI * 0.25 * (m % 4.0) + phi).reshape(b, l, n * r)


def sat_fm_demodulate_audio(sp, rf: np.ndarray) -> np.ndarray:
    """Satellite FM (B, L, N*r) -> subcarrier audio (B, K, L*N), naive
    chain: the golden/transmission.py fm_demodulate front end down to the
    recovered MULTIPLEX (before video de-emphasis), then per subcarrier:
    quadrature mix against the integer-cycles-per-frame carrier, circular
    I/Q low-passes, circular symmetric discriminator, audio low-pass +
    de-emphasis, AC coupling."""
    b, l, n_rf = rf.shape
    r = sp.r
    n_tot_rf = l * n_rf
    pad = _EDGE_PAD * r
    x = rf.reshape(b, n_tot_rf).astype(np.float64)
    xp = np.concatenate([x[:, -pad:], x, x[:, :pad]], axis=-1)
    y = _conv_same(xp, sp.rx_taps)
    m = np.arange(y.shape[-1], dtype=np.float64)
    c = np.cos(TWO_PI * 0.25 * (m % 4.0))
    s = np.sin(TWO_PI * 0.25 * (m % 4.0))
    i = _conv_same(y * (2.0 * c), sp.iq_taps)
    q = _conv_same(y * (-2.0 * s), sp.iq_taps)
    ip, im = np.concatenate([i[:, 1:], i[:, -1:]], axis=-1), _prev_held(i)
    qp, qm = np.concatenate([q[:, 1:], q[:, -1:]], axis=-1), _prev_held(q)
    f_dev = np.arctan2(qp * im - ip * qm, ip * im + qp * qm) * (
        sp.fs_rf / (2.0 * TWO_PI)
    )
    mux = f_dev / sp.deviation + sp.center
    mux = _conv_same(mux, sp.dec_taps)[:, pad : pad + n_tot_rf : r]

    n_tot = l * sp.n_base
    outs = []
    for f in sp.sub_freqs:
        k_cyc = int(round(f * n_tot / sp.base_fs))
        ph = _sub_phase(k_cyc, n_tot)[None]
        si = _wrap_filter(mux * (2.0 * np.cos(ph)), sp.sub_lpf)
        sq = _wrap_filter(mux * (-2.0 * np.sin(ph)), sp.sub_lpf)
        sip, sim = np.roll(si, -1, -1), np.roll(si, 1, -1)
        sqp, sqm = np.roll(sq, -1, -1), np.roll(sq, 1, -1)
        f_a = np.arctan2(sqp * sim - sip * sqm, sip * sim + sqp * sqm) * (
            sp.base_fs / (2.0 * TWO_PI)
        )
        a = _wrap_filter(f_a / sp.sub_dev, sp.aud_rx)
        outs.append(a - np.mean(a, axis=-1, keepdims=True))
    return np.stack(outs, axis=1)


# --------------------------------------------------------------------------
# A2 / Zweikanalton second sound carrier (frame/a2.py)
# --------------------------------------------------------------------------

#: A2 pilot constants (duplicated from frame/a2.py by the no-frame-
#: imports rule): +-2.5 kHz pilot deviation, 50 % AM by the ident tone,
#: ident dividers of fh (stereo fh/133, dual fh/57).
A2_PILOT_DEV = 2.5e3
A2_PILOT_AM = 0.5
A2_IDENT_DIV = {"stereo": 133, "dual": 57}
#: pilot frequency in half-cycles per row (3.5 fh)
A2_PILOT_HALF_CYCLES = 7


def a2_multiplex(a2p, audio2: np.ndarray, mode: str, frame0: int,
                 b: int, l: int) -> np.ndarray:
    """Carrier-2 modulating signal (B, L*N): audio + the AM-ident pilot,
    both phases evaluated on the absolute composite sample index (the
    pilot at 3.5 fh, the ident at fh/div)."""
    rfp = a2p.rfp
    n = rfp.row_samples
    fs = rfp.plan.fs
    fh = fs / n
    out = np.empty((b, l * n), np.float64)
    for k in range(b):
        m0 = (frame0 + k) * l * n
        ph_pil = _abs_phase(A2_PILOT_HALF_CYCLES / 2.0 * fh, fs, m0, l * n)
        ph_id = _abs_phase(fh / A2_IDENT_DIV[mode], fs, m0, l * n)
        am = 1.0 + A2_PILOT_AM * np.cos(ph_id)
        out[k] = (A2_PILOT_DEV / rfp.snd_dev) * am * np.cos(ph_pil)
    return np.asarray(audio2, np.float64) + out


def a2_on_rf(a2p, rf: np.ndarray, frame0: int, audio2: np.ndarray,
             mode: str = "stereo") -> np.ndarray:
    """RF (B, L, N*r) + second-program audio (B, L*N) -> RF with the A2
    second sound carrier, naive per-item chain: multiplex (audio +
    AM-ident pilot), zero-order hold, rectangle-rule deviation integral,
    carrier 2's phase on the absolute RF sample index (its integer-
    cycles-per-row law needs no row sign — frame/a2.py module
    docstring)."""
    rfp = a2p.rfp
    b, l, n_rf = rf.shape
    mux = a2_multiplex(a2p, audio2, mode, frame0, b, l)
    out = rf.astype(np.float64).copy()
    for k in range(b):
        a_rf = np.repeat(mux[k], rfp.r)
        dphi = (TWO_PI * rfp.snd_dev / rfp.fs_rf) * a_rf
        phi_dev = np.cumsum(dphi)
        ph2 = _abs_phase(a2p.f_snd2, rfp.fs_rf,
                         (frame0 + k) * l * n_rf, l * n_rf)
        out[k] += a2p.amp2 * np.cos(ph2 + phi_dev).reshape(l, n_rf)
    return out


def a2_takeoff2(a2p, rf: np.ndarray, frame0: int = 0) -> np.ndarray:
    """Carrier-2 FM takeoff (B, L, N*r) -> raw discriminator audio
    (B, L*N): band-pass, quadrature mix on the absolute-sample carrier,
    separate I/Q low-passes, strided decimation, exact phase-difference
    discriminator (the frame/a2.py::_takeoff chain, carrier 2; the raw
    output still carries the pilot — frame/a2.py strips it with aud_lpf
    downstream)."""
    rfp = a2p.rfp
    b, l, n_rf = rf.shape
    r = rfp.r
    out = np.empty((b, l * rfp.row_samples), np.float64)
    for k in range(b):
        xs = _conv_same(rf[k].reshape(1, l * n_rf).astype(np.float64),
                        a2p.bpf2)[0]
        ph = _abs_phase(a2p.f_snd2, rfp.fs_rf, (frame0 + k) * l * n_rf,
                        l * n_rf)
        i = _conv_same((xs * (2.0 * np.cos(ph)))[None], a2p.snd_lpf)[0, ::r]
        q = _conv_same((xs * (-2.0 * np.sin(ph)))[None], a2p.snd_lpf)[0, ::r]
        out[k] = _discriminate(i, q, rfp.plan.fs, rfp.snd_dev)
    return out
