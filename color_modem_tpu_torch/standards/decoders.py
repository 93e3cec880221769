"""Decoder registry: which decoders apply to which standard (K13).

Port of ``color_modem_tpu/standards/decoders.py``: decoder eligibility and
comb spacing are properties of the *standard*, so the port keeps its own
copy of the same tables and rules.
"""

from __future__ import annotations

from color_modem_tpu_torch.standards.base import StandardConfig

#: 'delayline' is the PAL-D decoder realized as baseband U/V averaging over
#: adjacent lines — equivalent to the hardware subcarrier delay-line trick
#: under ideal demodulation; 'avg' is the reference's chroma-averaging
#: wrapper, the same operation applied to any QAM standard [MEM-M].
#: 'combA' is the ADAPTIVE comb (soft-switching, like late-generation TV
#: chips): blends the up/down line differences by local smoothed energy,
#: so vertical color transitions take the matching neighbor instead of
#: averaging across the edge; plain tensor code outside the decode kernel.
QAM_DECODERS = ("notch", "comb2", "comb3", "combA", "delayline", "avg")
#: adaptive-comb soft-switch regularizers (equal to the JAX package's, so
#: the two stay float-comparable).  EPS is an absolute
#: floor; BIAS adds a chroma-scale term to both complement energies so the
#: blend stays at the symmetric comb (w=1/2) unless mismatch evidence is
#: comparable to the chroma itself — without it, smooth content (near-zero
#: in-band luma) lets complement NOISE swing the weights and inject the
#: single-sided combs' asymmetry error (measured: -10 dB on smooth scenes).
ADAPTIVE_EPS = 1e-9
#: swept 0.25/0.1/0.05 on the edge + smooth fixtures: smooth PSNR is flat
#: across the range (the chroma-scale bias dominates the near-zero
#: complements there regardless), edge PSNR rises as the bias drops
#: (36.1/38.5/39.7 dB vs comb3's 31.0)
ADAPTIVE_BIAS = 0.05
#: FM (SECAM) decoders: 'notch' is the bell/discriminator path; 'avg' adds
#: the reference's chroma-averaging wrapper on top — the assembled Dr/Db
#: planes average with the opposite-parity neighbor line, which (because
#: consecutive assembled lines share one component and differ in the other)
#: averages each component over its two nearest carrier lines [MEM-M: the
#: reference's ColorAveragingModem wraps ANY base modem].  NIIR gets the
#: same pair, with the averaging applied AFTER reference-line normalization
#: (averaging raw demod output would mix chroma and reference measurements).
#: 'interp' (SECAM only) replaces the copy-pairing with linear
#: interpolation between BOTH adjacent carrier lines — beyond-reference
#: quality, +12 dB on the pairing floor (modem/secam.pair_components_interp).
FM_DECODERS = ("notch", "avg", "interp")
NIIR_DECODERS = ("notch", "avg")
#: 'comb3d' — TEMPORAL comb: the chroma phase also inverts at 1-2 FRAME
#: spacing (NTSC: 227.5 cyc/line * 525 lines = half-integer cycles/frame),
#: so combing along the batched frame axis separates static content
#: perfectly.  Only expressible because frames are an array axis here — the
#: reference's per-line streaming design cannot reach across frames.


#: Combs require the chroma phase to flip ~180 deg at the comb spacing; past
#: this error (in cycles, 0.05 = 18 deg) a comb corrupts hue instead of
#: separating, so it is excluded rather than offered as a footgun.
COMB_FLIP_TOL = 0.05


def comb_flip_error(cfg: StandardConfig) -> float:
    """Distance (cycles) of the best comb spacing's phase step from 180 deg."""
    return min(
        abs((p * cfg.cpl_num / cfg.cpl_den) % 1.0 - 0.5) for p in (1, 2)
    )


def temporal_comb_spacing(cfg: StandardConfig) -> int | None:
    """Frame spacing at which the WHOLE chroma flips sign, or None.

    Exact integer arithmetic on the rational phase law:
    NTSC/NIIR-family (half-integer cycles per frame) -> 1 frame;
    PAL/PAL-M/PAL-N -> 2 frames; none within 2 frames -> None.

    For V-switch standards the spacing must also preserve the per-line V
    sign (p * total_lines even): a 180-deg carrier flip with a V-switch
    parity flip negates U but not V, and a temporal comb would cancel the
    V channel instead of luma.
    """
    for p in (1, 2):
        frac = (p * cfg.cpl_num * cfg.total_lines) % cfg.cpl_den / cfg.cpl_den
        if abs(frac - 0.5) > COMB_FLIP_TOL:
            continue
        if getattr(cfg.chroma, "v_switch", False) and (
            p * cfg.total_lines
        ) % 2 != 0:
            continue
        return p
    return None


def allowed_decoders(cfg: StandardConfig) -> tuple:
    """Decoders meaningful for a standard (SURVEY.md K13, A.6).

    SECAM is FM — the notch path plus post-assembly chroma averaging
    ('avg').  NIIR alternates chroma and reference-carrier lines, so
    cross-line combs would mix the two streams (and its fsc gives no
    180-deg flip at spacing 2 either): notch, plus 'avg' applied after the
    reference normalization.  Standards whose phase law never flips ~180
    deg at 1- or 2-line
    spacing (NTSC-4.43: 22.4 deg off at best — measured 7.5 dB WORSE than
    notch) get no comb variants; baseband averaging (delayline/avg) doesn't
    depend on the carrier phase law and stays.
    """
    if cfg.is_fm:
        return FM_DECODERS
    if cfg.chroma.reference_amplitude is not None:
        return NIIR_DECODERS
    if comb_flip_error(cfg) > COMB_FLIP_TOL:
        base = tuple(d for d in QAM_DECODERS if not d.startswith("comb"))
    else:
        base = QAM_DECODERS
    if temporal_comb_spacing(cfg) is not None:
        base = base + ("comb3d",)
        if "combA" in base:
            # motion-adaptive 3D comb: needs both the spatial flip (for
            # its combA half) and the temporal flip
            base = base + ("comb3dA",)
    return base


def comb_spacing(cfg: StandardConfig) -> int:
    """Line spacing at which the chroma phase flips ~180 deg (A.6).

    NTSC: frac(cpl)=0.5 -> 1 line.  PAL: frac(2*cpl)=0.5032 -> 2 lines.
    """
    best_p, best_err = 1, 1.0
    for p in (1, 2):
        frac = (p * cfg.cpl_num / cfg.cpl_den) % 1.0
        err = abs(frac - 0.5)
        if err < best_err:
            best_p, best_err = p, err
    return best_p
