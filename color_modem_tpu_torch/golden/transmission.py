"""GOLDEN ORACLE — naive transmission-layer chains (VERDICT r2 item 7).

The port's copy of ``color_modem_tpu/golden/transmission.py``: the same
NumPy code on the port's own RFPlan and SatPlan (host NumPy taps with the
same field names), its outputs equal to the JAX package's oracle bit for
bit (``tests/test_torch_golden.py``).

Frozen per-sample NumPy float64 models of the VSB picture chain
(frame/rf.py) and the satellite FM video chain (frame/satellite.py), in
the style of golden/modems.py: deliberately UNCOMPOSED filter-mix-filter
cascades with ``np.convolve(..., 'same')``, explicit zero-stuffing, and
the carrier phase evaluated directly on the absolute sample index in
f64 — no modulation-identity tap composition, no overlap-save blocking,
no frequency-domain rate changing, no phase-law factoring.  The JAX
paths derive the same signals through dsp/stream.py's composed complex
FIRs; parity between the two is what certifies that machinery
(tests/test_golden_transmission.py) — a regression that shifted encoder
and decoder consistently would still disagree with this model.

Shared-taps tradeoff (same as golden/mac.py): the filter TAPS come from
the caller's RFPlan/SatPlan (design-time host numpy) — the oracle checks
the pipeline MATH, not a second filter design.  The plans are duck-typed
arguments; this module imports nothing from frame/ and no JAX (package
rule).

Scope: the noise-free core picture chains only — rf_modulate/rf_demodulate
at df=0 with sync detection and no audio, fm_modulate/fm_demodulate with
no dispersal/audio.  Sound, AFT/AGC/DOC and channel impairments are
covered by their own physics-asserting property tests.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi

#: Negative-AM envelope map (spec values, duplicated from frame/rf.py by
#: the package's no-JAX-imports rule): blanking at 75 % of peak carrier,
#: peak white at 12.5 % (BT.470 System M convention).
ENV_BLANK = 0.75
ENV_WHITE = 0.125


def _conv_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """'same'-centered convolution per stream (odd taps), f64."""
    t = np.asarray(taps, np.float64)
    return np.stack(
        [np.convolve(row.astype(np.float64), t, mode="same") for row in x]
    )


def _carrier_cos(f: float, fs: float, row0: int, l: int, n_row: int):
    """cos/sin of ``f`` Hz on the absolute sample index: rows row0..row0+l
    of ``n_row`` samples each, phase = 2*pi*f/fs * m_abs reduced mod 1
    cycle in exact f64 BEFORE the trig (m_abs stays < 2^53)."""
    m = np.arange(row0 * n_row, (row0 + l) * n_row, dtype=np.float64)
    cyc = (f / fs) * m
    ph = TWO_PI * (cyc - np.floor(cyc))
    return np.cos(ph), np.sin(ph)


# --------------------------------------------------------------------------
# VSB picture chain (frame/rf.py core; SURVEY.md §4.2 oracle discipline)
# --------------------------------------------------------------------------

def rf_modulate(rfp, comp: np.ndarray, frame0: int = 0) -> np.ndarray:
    """Composite (B, L, N) -> VSB picture RF (B, L, N*r), naive chain:
    envelope map, explicit zero-stuff (gain r), anti-image lowpass
    (det_taps), carrier multiply at the absolute-sample phase, VSB
    shaping (tx_taps)."""
    b, l, n = comp.shape
    assert n == rfp.row_samples
    r = rfp.r
    env = ENV_BLANK - (ENV_BLANK - ENV_WHITE) * comp.astype(np.float64)
    env = env.reshape(b, l * n)
    stuffed = np.zeros((b, l * n * r), np.float64)
    stuffed[:, ::r] = r * env
    y = _conv_same(stuffed, rfp.det_taps)
    out = np.zeros_like(y)
    for k in range(b):
        c, _ = _carrier_cos(rfp.fc, rfp.fs_rf, (frame0 + k) * l, l, rfp.n_rf)
        out[k] = np.convolve(y[k] * c, np.asarray(rfp.tx_taps, np.float64),
                             mode="same")
    return out.reshape(b, l, n * r)


def rf_demodulate(rfp, rf: np.ndarray, frame0: int = 0) -> np.ndarray:
    """VSB picture RF (B, L, N*r) -> composite (B, L, N), naive synchronous
    chain: Nyquist-flank bandpass (rx_taps), product mix against the
    absolute-sample carrier, post-detection lowpass (det_taps), strided
    decimation, envelope-map inversion.  Product gain 4 as in the JAX
    path (x2 cos^2 halving, x2 Nyquist-flank half-envelope convention)."""
    b, l, n_rf = rf.shape
    assert n_rf == rfp.n_rf
    r = rfp.r
    y = _conv_same(rf.reshape(b, l * n_rf), rfp.rx_taps)
    det = np.asarray(rfp.det_taps, np.float64)
    env = np.zeros_like(y)
    for k in range(b):
        c, _ = _carrier_cos(rfp.fc, rfp.fs_rf, (frame0 + k) * l, l, rfp.n_rf)
        env[k] = 4.0 * np.convolve(y[k] * c, det, mode="same")
    env = env[:, ::r].reshape(b, l, rfp.row_samples)
    return (ENV_BLANK - env) / (ENV_BLANK - ENV_WHITE)


# --------------------------------------------------------------------------
# Satellite FM video chain (frame/satellite.py core)
# --------------------------------------------------------------------------

#: stream-edge wrap margin at the baseband rate (frame/satellite.py
#: _EDGE_PAD — the frame stream is ONE PERIOD of a periodic signal)
_EDGE_PAD = 256


def _wrap_filter(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Circular 'same' filter: wrap-pad by the (8-rounded) half-width,
    convolve, crop — the naive mirror of satellite._wrap_filter."""
    t = np.asarray(taps, np.float64)
    n = x.shape[-1]
    p = -(-(len(t) // 2 + 1) // 8) * 8
    xp = np.concatenate([x[..., -p:], x, x[..., :p]], axis=-1)
    return _conv_same(xp, t)[..., p : p + n]


def fm_modulate(sp, base: np.ndarray) -> np.ndarray:
    """Baseband (B, L, N) -> satellite FM at IF (B, L, N*r), naive chain:
    pre-emphasis (and the multiplex lowpass when subcarriers are
    designed) as SEPARATE circular filters, explicit zero-stuff + interp
    lowpass, midpoint-rule deviation integral with the per-frame phase
    closure, carrier at exactly fs_rf/4 on the within-frame index."""
    b, l, n = base.shape
    assert n == sp.n_base
    r = sp.r
    v = _wrap_filter(base.reshape(b, l * n), sp.pre_taps)
    if getattr(sp, "mux_lpf", None) is not None:
        v = _wrap_filter(v, sp.mux_lpf)
    pb = _EDGE_PAD
    vp = np.concatenate([v[:, -pb:], v, v[:, :pb]], axis=-1)
    stuffed = np.zeros((b, vp.shape[-1] * r), np.float64)
    stuffed[:, ::r] = r * vp
    v_rf = _conv_same(stuffed, sp.interp_taps)[:, pb * r : pb * r + l * n * r]

    dphi = (TWO_PI * sp.deviation / sp.fs_rf) * (v_rf - sp.center)
    # close the deviation phase over the frame (one period; the residual
    # is wrapped to (-pi, pi] and spread across all samples — the same
    # law as frame/satellite.fm_modulate, in f64)
    tot = np.sum(dphi, axis=-1, keepdims=True) % TWO_PI
    tot = np.where(tot > np.pi, tot - TWO_PI, tot)
    dphi = dphi - tot / (l * n * r)
    phi = np.cumsum(dphi, axis=-1) - 0.5 * dphi
    m = np.arange(l * n * r, dtype=np.float64)
    ph = TWO_PI * 0.25 * (m % 4.0) + phi
    return np.cos(ph).reshape(b, l, n * r)


def fm_demodulate(sp, rf: np.ndarray) -> np.ndarray:
    """Satellite FM (B, L, N*r) -> baseband (B, L, N), naive chain:
    circular band-pass, explicit fs/4 quadrature mixers, separate I/Q
    lowpasses, symmetric phase-difference discriminator, pre-decimation
    lowpass + stride, then de-emphasis (and the multiplex lowpass when
    designed) as separate circular filters."""
    b, l, n_rf = rf.shape
    assert n_rf == sp.n_rf
    r = sp.r
    n_tot = l * n_rf
    pad = _EDGE_PAD * r
    x = rf.reshape(b, n_tot).astype(np.float64)
    xp = np.concatenate([x[:, -pad:], x, x[:, :pad]], axis=-1)
    y = _conv_same(xp, sp.rx_taps)
    m = np.arange(y.shape[-1], dtype=np.float64)
    c = np.cos(TWO_PI * 0.25 * (m % 4.0))
    s = np.sin(TWO_PI * 0.25 * (m % 4.0))
    i = _conv_same(y * (2.0 * c), sp.iq_taps)
    q = _conv_same(y * (-2.0 * s), sp.iq_taps)
    ip = np.concatenate([i[:, 1:], i[:, -1:]], axis=-1)
    im = np.concatenate([i[:, :1], i[:, :-1]], axis=-1)
    qp = np.concatenate([q[:, 1:], q[:, -1:]], axis=-1)
    qm = np.concatenate([q[:, :1], q[:, :-1]], axis=-1)
    f_dev = np.arctan2(qp * im - ip * qm, ip * im + qp * qm) * (
        sp.fs_rf / (2.0 * TWO_PI)
    )
    v = f_dev / sp.deviation + sp.center
    v = _conv_same(v, sp.dec_taps)[:, pad : pad + n_tot : r]
    if getattr(sp, "mux_lpf", None) is not None:
        v = _wrap_filter(v, sp.mux_lpf)
    v = _wrap_filter(v, sp.de_taps)
    return v.reshape(b, l, sp.n_base)
