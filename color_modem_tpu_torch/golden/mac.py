"""GOLDEN ORACLE — sequential per-line D2-MAC codec (SURVEY.md §4.2 rules).

The port's copy of ``color_modem_tpu/golden/mac.py``, on the port's
``modem/mac_plan.py::MacPlan`` and ``dsp/design.py::resample_matrix``
(both bit-identical to the JAX package's), its outputs equal to the JAX
package's oracle bit for bit (``tests/test_torch_golden.py``).

Mirrors modem/mac.py the way golden/modems.py mirrors the QAM/FM pipeline:
deliberately naive NumPy float64, an explicit Python loop over scanlines, a
STATEFUL bit-by-bit duobinary precoder (the hardware shift-register shape),
and an explicit 1-line chroma store for the line-sequential reassembly.
The JAX path derives the same quantities in closed form (prefix-parity
precoding, broadcast segment assembly, neighbor-average via shifts); this
oracle checks that the two agree line by line.

Constants and the resampling matrix come from the shared JAX-free plan
(modem/mac_plan.py, dsp/design.resample_matrix) — the documented shared-taps
tradeoff (golden/modems.py header): the oracle checks pipeline MATH, not a
second filter design.  NumPy only; no JAX imports (enforced by this
package's rule).
"""

from __future__ import annotations

import numpy as np

from color_modem_tpu_torch.dsp.design import resample_matrix
from color_modem_tpu_torch.modem.mac_plan import MacPlan


def _resample(row: np.ndarray, n_out: int) -> np.ndarray:
    if row.shape[-1] == n_out:
        return row.astype(np.float64)
    return row.astype(np.float64) @ resample_matrix(row.shape[-1], n_out).astype(
        np.float64
    )


def _duobinary_line(bits) -> np.ndarray:
    """Stateful per-symbol precoder: the sequential form of the closed-form
    prefix parity in modem/mac.duobinary_levels."""
    p_prev = 0
    out = np.zeros(len(bits), dtype=np.float64)
    for k, b in enumerate(bits):
        p = p_prev ^ int(b)
        out[k] = 0.5 * ((2.0 * p - 1.0) + (2.0 * p_prev - 1.0))
        p_prev = p
    return out


def encode_line(
    plan: MacPlan, y: np.ndarray, u: np.ndarray, v: np.ndarray,
    gline: int, payload=None,
) -> np.ndarray:
    """One scanline: (W,) Y/U/V components -> (1296,) MAC line."""
    cfg = plan.cfg
    n_sync = len(cfg.line_sync_word)
    cap = cfg.data_symbols - n_sync
    if payload is None:
        payload = [0] * cap
    payload = list(payload) + [0] * (cap - len(payload))
    bits = list(cfg.line_sync_word) + payload

    line = np.full(cfg.samples_per_line, cfg.pedestal, dtype=np.float64)

    d = _duobinary_line(bits)
    spb = cfg.samples_per_symbol
    if spb == 1:
        # D-MAC: one symbol per grid sample, no interpolation (the
        # duobinary correlation is the spectrum shaping)
        shaped = d
    else:
        up = np.zeros(spb * cfg.data_symbols, dtype=np.float64)
        up[0::spb] = d
        shaped = np.convolve(
            up, plan.halfband.astype(np.float64), mode="same"
        )
    line[cfg.data_start : cfg.data_start + spb * cfg.data_symbols] = (
        cfg.pedestal + cfg.data_amplitude * shaped
    )

    c = u if gline % 2 == 0 else v
    line[cfg.chroma_start : cfg.chroma_start + cfg.chroma_len] = (
        cfg.pedestal + cfg.chroma_gain * _resample(c, cfg.chroma_len)
    )
    line[cfg.luma_start : cfg.luma_start + cfg.luma_len] = _resample(
        y, cfg.luma_len
    )
    return line


def encode_frame(plan: MacPlan, rgb: np.ndarray, gline0: int = 0,
                 payload=None) -> np.ndarray:
    """(3, L, W) RGB -> (L, 1296), looping per scanline."""
    ycc = np.einsum("ij,jlw->ilw", plan.rgb_to_ycc, rgb.astype(np.float64))
    n_lines = rgb.shape[1]
    out = np.zeros((n_lines, plan.cfg.samples_per_line), dtype=np.float64)
    for l in range(n_lines):
        pl = None if payload is None else payload[l]
        out[l] = encode_line(
            plan, ycc[0, l], ycc[1, l], ycc[2, l], gline0 + l, pl
        )
    return out


def _decode_line_components(plan: MacPlan, line: np.ndarray):
    """One line -> (y (W,), c (W,)) before line-sequential reassembly."""
    cfg = plan.cfg
    clamp = line[cfg.clamp_start : cfg.clamp_start + cfg.clamp_len]
    line = line.astype(np.float64) - (clamp.mean() - cfg.pedestal)
    y = _resample(line[cfg.luma_start : cfg.luma_start + cfg.luma_len],
                  plan.width)
    c = _resample(
        (line[cfg.chroma_start : cfg.chroma_start + cfg.chroma_len]
         - cfg.pedestal) / cfg.chroma_gain,
        plan.width,
    )
    return y, c


def decode_frame(plan: MacPlan, sig: np.ndarray, gline0: int = 0) -> np.ndarray:
    """(L, 1296) -> (3, L, W) RGB in [0,1], explicit chroma line store.

    The missing component on each line is the average of the two vertical
    neighbors' transmitted chroma; frame edges reflect (neighbor(0) = 1,
    neighbor(L-1) = L-2), matching the framework-wide edge rule.
    """
    n_lines = sig.shape[0]
    ys = np.zeros((n_lines, plan.width), dtype=np.float64)
    cs = np.zeros((n_lines, plan.width), dtype=np.float64)
    for l in range(n_lines):
        ys[l], cs[l] = _decode_line_components(plan, sig[l])

    u = np.zeros_like(cs)
    v = np.zeros_like(cs)
    for l in range(n_lines):
        prev_l = l - 1 if l > 0 else min(1, n_lines - 1)
        next_l = l + 1 if l < n_lines - 1 else max(n_lines - 2, 0)
        interp = 0.5 * (cs[prev_l] + cs[next_l])
        if (gline0 + l) % 2 == 0:
            u[l], v[l] = cs[l], interp
        else:
            u[l], v[l] = interp, cs[l]

    ycc = np.stack([ys, u, v])
    rgb = np.einsum("ij,jlw->ilw", plan.ycc_to_rgb, ycc)
    return np.clip(rgb, 0.0, 1.0)


def decode_data_line(plan: MacPlan, line: np.ndarray):
    """One line -> (sync_ok, payload bits list) via per-symbol decisions."""
    cfg = plan.cfg
    clamp = line[cfg.clamp_start : cfg.clamp_start + cfg.clamp_len]
    line = line.astype(np.float64) - (clamp.mean() - cfg.pedestal)
    spb = cfg.samples_per_symbol
    burst = line[cfg.data_start : cfg.data_start + spb * cfg.data_symbols]
    bits = []
    for k in range(cfg.data_symbols):
        d = (burst[spb * k] - cfg.pedestal) / cfg.data_amplitude
        bits.append(1 if abs(d) < 0.5 else 0)
    n_sync = len(cfg.line_sync_word)
    sync_ok = tuple(bits[:n_sync]) == tuple(cfg.line_sync_word)
    return sync_ok, bits[n_sync:]
