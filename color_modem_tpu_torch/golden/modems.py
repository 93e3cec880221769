"""GOLDEN ORACLE — frozen per-scanline NumPy modems.

The port's own copy of ``color_modem_tpu/golden/modems.py``, which holds
the JAX package to the same oracle: a deliberately naive, sequential,
per-scanline implementation of the signal chain (per-line
``modulate``/``demodulate`` with 1-line instance state), NumPy float64
throughout.  The port's pipelines and kernels are held to it on the card
(``chip_smoke.py`` phase 4k), where the JAX package is not installed.

RULES: NumPy only, no torch arithmetic and no JAX; clarity over speed;
FROZEN: its outputs equal the JAX package's oracle bit for bit on the same
inputs (``tests/test_torch_golden.py``), and nobody changes it to match a
pipeline.

Filter taps and phase ramps come from the caller's plan: a port
:class:`~color_modem_tpu_torch.modem.plan.QamPlan` or ``FmPlan`` keeps the
float64 designs its float32 buffers were made from in ``plan.host``, and
:func:`host_plan` reads those, under the JAX ``ModemPlan``'s field names.
Identical taps keep this oracle a check on the pipeline math, not on two
filter designs.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from color_modem_tpu_torch.standards.base import FmParams, QamParams

TWO_PI = 2.0 * np.pi

#: the scalars a port plan carries besides its host arrays
_PLAN_SCALARS = ("cfg", "n_samples", "fs", "theta", "f_center", "fm_margin", "fm_luma_est")


def host_plan(plan):
    """The float64 view of ``plan`` that the oracle reads: a port plan's
    ``host`` arrays (the float64 designs, not its float32 buffers) and its
    scalars, under the JAX ``ModemPlan``'s field names.  An object with no
    ``host`` is taken to be such a view already."""
    host = getattr(plan, "host", None)
    if host is None:
        return plan
    scalars = {k: getattr(plan, k) for k in _PLAN_SCALARS if hasattr(plan, k)}
    return SimpleNamespace(**host, **scalars)


def conv_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """The golden filtering primitive: zero-padded 'same' linear convolution."""
    return np.convolve(x, taps, mode="same")


def conv_same_held(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Held-edge 'same' convolution — the BASEBAND boundary rule (A.4 note).

    The analog signal continues through blanking, so a baseband filter's
    neighborhood beyond the active line is ~the edge value, not zero; a
    zero edge puts a full-scale step through SECAM's long-tailed emphasis
    filters and corrupts ~60 samples per line end.  Carrier-band filters
    (anticloche/bell/notch) keep the zero rule — holding one carrier
    sample would extend a DC, not a carrier.
    """
    h = (len(taps) - 1) // 2
    xp = np.pad(x, (h, h), mode="edge")
    return np.convolve(xp, taps, mode="same")[h : h + len(x)]


def line_phase0_exact(cpl_num: int, cpl_den: int, gline: int) -> float:
    """Exact line-start subcarrier phase via Python big-int arithmetic."""
    return TWO_PI * ((cpl_num * gline) % cpl_den) / cpl_den


class GoldenQamModem:
    """NTSC / PAL / NIIR line modem (SURVEY.md A.2/A.3/A.5, C1-C3, C5).

    Per-line protocol on *components*: the frame layer applies colorimetry.
    ``modulate_components(gline, y, c1, c2) -> composite`` and
    ``demodulate_components(gline, composite) -> (y, c1, c2)`` (notch path).
    """

    def __init__(self, plan):
        plan = host_plan(plan)
        assert isinstance(plan.cfg.chroma, QamParams)
        self.plan = plan
        self.p: QamParams = plan.cfg.chroma
        self.ramp = np.asarray(plan.ramp, dtype=np.float64)

    # -- phase law ----------------------------------------------------------
    def carrier_phase(self, gline: int) -> np.ndarray:
        cfg = self.plan.cfg
        phi0 = line_phase0_exact(cfg.cpl_num, cfg.cpl_den, gline)
        return phi0 + self.ramp + self.plan.theta

    def v_sign(self, gline: int) -> float:
        if not self.p.v_switch:
            return 1.0
        return 1.0 if gline % 2 == 0 else -1.0

    def is_reference_line(self, gline: int) -> bool:
        """NIIR: odd lines carry the unmodulated reference carrier (A.5)."""
        return self.p.reference_amplitude is not None and gline % 2 == 1

    # -- encode -------------------------------------------------------------
    def modulate_components(self, gline, y, c1, c2) -> np.ndarray:
        phi = self.carrier_phase(gline)
        if self.is_reference_line(gline):
            chroma = self.p.reference_amplitude * np.sin(phi)
        else:
            c1f = conv_same(c1, self.plan.c1_lpf)
            c2f = conv_same(c2, self.plan.c2_lpf)
            chroma = c1f * np.sin(phi) + self.v_sign(gline) * c2f * np.cos(phi)
        return y + chroma

    # -- decode (notch separation + product detector) ------------------------
    def separate_notch(self, composite):
        chroma_band = conv_same(composite, self.plan.chroma_bpf)
        return composite - chroma_band, chroma_band

    def demodulate_carrier(self, gline, chroma_band):
        """Product-detect a chroma-band signal into (c1, c2) baseband."""
        phi = self.carrier_phase(gline)
        c1 = conv_same(2.0 * chroma_band * np.sin(phi), self.plan.c1_lpf)
        c2 = self.v_sign(gline) * conv_same(
            2.0 * chroma_band * np.cos(phi), self.plan.c2_lpf
        )
        return c1, c2

    def demodulate_components(self, gline, composite):
        y, chroma_band = self.separate_notch(composite)
        c1, c2 = self.demodulate_carrier(gline, chroma_band)
        return y, c1, c2


class GoldenSecamModem:
    """SECAM line modem (SURVEY.md A.4, C4).

    Per line: select D'R (odd gline) or D'B (even), LPF, pre-emphasize,
    frequency-modulate (phase = cumulative sum of instantaneous frequency,
    restarted each line), apply the HF anti-cloche, add to luma.

    Decode: bell takeoff -> quadrature mix to f_center -> LPF ->
    quadrature FM discriminator (amplitude-invariant, i.e. an ideal limiter)
    -> de-emphasis -> LPF.  Line pairing (each line carries only one
    component; the other comes from the neighbor) happens in the frame layer.
    """

    def __init__(self, plan):
        plan = host_plan(plan)
        assert isinstance(plan.cfg.chroma, FmParams)
        self.plan = plan
        self.p: FmParams = plan.cfg.chroma

    @staticmethod
    def is_r_line(gline: int) -> bool:
        return gline % 2 == 1

    def _f0_dev(self, gline: int):
        if self.is_r_line(gline):
            return self.p.f0r, self.p.dev_r
        return self.p.f0b, self.p.dev_b

    def modulate_components(self, gline, y, dr, db) -> np.ndarray:
        plan = self.plan
        d = dr if self.is_r_line(gline) else db
        d = conv_same_held(d, plan.comp_lpf)
        d = conv_same_held(d, plan.preemph)
        f0, dev = self._f0_dev(gline)
        f_inst = f0 + dev * d
        # per-line phase integral, MIDPOINT rule: phi[n] corresponds to
        # f_inst at exactly sample n, so the decoder's symmetric-derivative
        # discriminator reads the component with zero group delay (the
        # rectangle rule put it a half-sample early: +13.3 deg/MHz measured)
        phi = TWO_PI * (np.cumsum(f_inst) - 0.5 * f_inst) / plan.fs
        carrier = np.cos(phi)
        chroma = conv_same(carrier, plan.anticloche)
        return y + chroma

    def _extend_blanking(self, gline, composite):
        """Reconstruct the blanking neighborhoods (modem/secam.py
        ``extend_blanking``): both margins carry the line's luma pedestal
        (mean of the K edge samples — the carrier averages out); the left
        margin adds the undeviated rest carrier, whose phase at sample 0
        is a shared modem convention."""
        plan = self.plan
        m = plan.fm_margin
        k = plan.fm_luma_est
        lum_l = composite[:k].mean()
        lum_r = composite[-k:].mean()
        parity = 1 if self.is_r_line(gline) else 0
        left = lum_l + np.asarray(plan.fm_margin_carrier, np.float64)[parity]
        right = np.full(m, lum_r)
        return np.concatenate([left, composite, right])

    def demodulate_component(self, gline, composite):
        """Returns (luma, d_hat) where d_hat is THIS line's D'R or D'B."""
        plan = self.plan
        m = plan.fm_margin
        n = len(composite)
        ext = self._extend_blanking(gline, composite)
        mix_ext = np.asarray(plan.mix_ramp_ext, np.float64)
        takeoff = conv_same(ext, plan.bell_takeoff)
        luma = (ext - conv_same(ext, plan.luma_notch))[m : m + n]
        # quadrature mix to the band center, then LPF -> analytic I/Q
        i = conv_same(2.0 * takeoff * np.cos(mix_ext), plan.mix_lpf)
        q = conv_same(-2.0 * takeoff * np.sin(mix_ext), plan.mix_lpf)
        di = conv_same(i, plan.diff)
        dq = conv_same(q, plan.diff)
        a2 = np.maximum(i * i + q * q, 1e-9)  # the "limiter": amplitude cancels
        f_inst = plan.f_center + (i * dq - q * di) / (TWO_PI * a2) * plan.fs
        f0, dev = self._f0_dev(gline)
        d_hat = (f_inst - f0) / dev
        d_hat = conv_same(d_hat, plan.deemph)
        d_hat = conv_same(d_hat, plan.demod_lpf)
        return luma, d_hat[m : m + n]
