"""Standard configuration factories: NTSC, PAL, SECAM, NIIR.

Port of ``color_modem_tpu/standards/__init__.py``; each factory returns a
configuration equal, field for field, to its JAX counterpart's.

Constants per SURVEY.md Appendix A (ITU-R BT.470 / BT.1700).  The reference
embeds these in its modem modules (``color_modem/ntsc.py`` etc., unverified —
SURVEY.md §0.2); here each standard is one frozen config object.

The common ``t_active = 720 / 13.5 MHz`` (the BT.601 convention) maps the
default 720-sample row onto exactly fs = 13.5 MHz, giving fs/fsc = 3.77 (NTSC)
and 3.05 (PAL) — both above the 2.5x floor required by SURVEY.md A.1.  Wider
rows raise fs proportionally (1440 px -> 27 MHz); filter tap counts scale
with fs (modem/plan.REF_FS) so accuracy holds across widths.  For SECAM the
extra sideband headroom at 27 MHz (~6.2 MHz sidebands vs the 6.75 MHz
Nyquist at 720) was MEASURED worth < 0.2 dB once the round-2 boundary fixes
landed — both widths sit at the FM chain's ~35 dB (notch) / 38.5 dB
(interp) limit, enforced in tests/test_roundtrip.py at both widths.
"""

from __future__ import annotations

import dataclasses

from color_modem_tpu_torch.standards.base import (
    FmParams,
    QamParams,
    StandardConfig,
    diff_row,
    make_matrices,
)

#: BT.601 active-line duration: 720 samples at 13.5 MHz.
T_ACTIVE_601 = 720.0 / 13.5e6


def NTSC(
    *,
    equiband: bool = False,
    i_bandwidth: float = 1.3e6,
    q_bandwidth: float = 0.6e6,
) -> StandardConfig:
    """NTSC 525/29.97 (SURVEY.md A.2).

    fsc = 455/2 * fh = 315/88 MHz; chroma phase advances exactly 227.5 cycles
    per line, so it flips 180 deg line-to-line — the property 2-line combs
    exploit.  ``equiband=True`` selects the 0.6 MHz equiband I/Q
    simplification mentioned in A.2.
    """
    fh = 4.5e6 / 286.0                      # 15734.2657... Hz
    fsc = 455.0 / 2.0 * fh                  # 3.5795454... MHz = 315/88 MHz
    if equiband:
        i_bandwidth = q_bandwidth = 0.6e6
    # Published YIQ rows (BT.1700); inverse computed exactly at config time.
    fwd, inv = make_matrices(
        (0.5959, -0.2746, -0.3213),
        (0.2115, -0.5227, 0.3112),
    )
    return StandardConfig(
        name="ntsc",
        fh=fh,
        total_lines=525,
        active_lines=480,
        t_active=T_ACTIVE_601,
        cpl_num=455,
        cpl_den=2,
        rgb_to_ycc=fwd,
        ycc_to_rgb=inv,
        chroma=QamParams(
            fsc=fsc,
            c1_bandwidth=i_bandwidth,
            c2_bandwidth=q_bandwidth,
            phase_offset_deg=33.0,
            v_switch=False,
            chroma_band=1.3e6,
        ),
    )


def PAL() -> StandardConfig:
    """PAL 625/25 (SURVEY.md A.3).

    fsc = (1135/4 + 1/625) * fh = 4.43361875 MHz — the +25 Hz offset is kept
    exactly via cpl = 709379/2500 cycles/line.  V sign alternates each line
    (the V-switch), which the delay-line decoder exploits.
    """
    fh = 15625.0
    # cpl = 1135/4 + 1/625 = (1135*625 + 4) / 2500 = 709379/2500
    cpl_num, cpl_den = 709379, 2500
    fsc = cpl_num / cpl_den * fh            # 4.43361875 MHz exactly
    fwd, inv = make_matrices(
        diff_row("B", 0.492),               # U = 0.492 (B - Y)
        diff_row("R", 0.877),               # V = 0.877 (R - Y)
    )
    return StandardConfig(
        name="pal",
        fh=fh,
        total_lines=625,
        active_lines=576,
        t_active=T_ACTIVE_601,
        cpl_num=cpl_num,
        cpl_den=cpl_den,
        rgb_to_ycc=fwd,
        ycc_to_rgb=inv,
        chroma=QamParams(
            fsc=fsc,
            c1_bandwidth=1.3e6,
            c2_bandwidth=1.3e6,
            phase_offset_deg=0.0,
            v_switch=True,
            chroma_band=1.3e6,
        ),
    )


def SECAM() -> StandardConfig:
    """SECAM 625/25, SECAM III/L FM chroma (SURVEY.md A.4).

    Line-alternate FM: odd global lines carry D'R (rest 282*fh = 4.40625 MHz,
    +280 kHz/unit), even lines D'B (272*fh = 4.25 MHz, +230 kHz/unit).  The
    LF video pre-emphasis corner is f1 = 85 kHz; the HF "anti-cloche"
    amplitude pre-emphasis is G(f) = M0 (1+16jF)/(1+1.26jF) with
    F = f/f0 - f0/f, f0 = 4.286 MHz, M0 = 0.115.
    """
    fh = 15625.0
    fwd, inv = make_matrices(
        diff_row("R", -1.902),              # D'R = -1.902 (R - Y)
        diff_row("B", 1.505),               # D'B =  1.505 (B - Y)
    )
    return StandardConfig(
        name="secam",
        fh=fh,
        total_lines=625,
        active_lines=576,
        t_active=T_ACTIVE_601,
        cpl_num=0,                          # FM: phase restarts each line
        cpl_den=1,
        rgb_to_ycc=fwd,
        ycc_to_rgb=inv,
        chroma=FmParams(
            f0r=282.0 * fh,                 # 4.40625 MHz
            f0b=272.0 * fh,                 # 4.25 MHz
            dev_r=280e3,
            dev_b=230e3,
            component_bandwidth=1.3e6,
            preemph_f1=85e3,
            bell_f0=4.286e6,
            bell_m0=0.115,
            bell_k_num=16.0,
            bell_k_den=1.26,
            demod_lpf=1.3e6,
        ),
    )


def NIIR(*, reference_amplitude: float = 0.30) -> StandardConfig:
    """NIIR / "SECAM IV" 625/25 (SURVEY.md A.5, [MEM-M/L]).

    QAM-family chroma where alternate lines carry an unmodulated reference
    carrier; the decoder stores the reference line and uses its measured
    complex amplitude to normalize the gain/phase of the modulated lines.
    Exact upstream constants are unavailable (empty reference mount,
    SURVEY.md §0); this implements the A.5 description atop the QAM core with
    fsc = 283.5 * fh (~4.43 MHz, 180 deg/line progression) and PAL U/V
    colorimetry.
    """
    fh = 15625.0
    cpl_num, cpl_den = 567, 2               # 283.5 cycles/line
    fsc = cpl_num / cpl_den * fh            # 4.4296875 MHz
    fwd, inv = make_matrices(
        diff_row("B", 0.492),
        diff_row("R", 0.877),
    )
    return StandardConfig(
        name="niir",
        fh=fh,
        total_lines=625,
        active_lines=576,
        t_active=T_ACTIVE_601,
        cpl_num=cpl_num,
        cpl_den=cpl_den,
        rgb_to_ycc=fwd,
        ycc_to_rgb=inv,
        chroma=QamParams(
            fsc=fsc,
            c1_bandwidth=1.3e6,
            c2_bandwidth=1.3e6,
            phase_offset_deg=0.0,
            v_switch=False,
            chroma_band=1.3e6,
            reference_amplitude=reference_amplitude,
        ),
    )


def NTSC443() -> StandardConfig:
    """NTSC-4.43 hybrid: NTSC 525/29.97 scan + YIQ colorimetry with the PAL
    subcarrier frequency (used by multi-standard VCRs/monitors).

    Exact cpl = fsc/fh = 4433618.75 / (4.5e6/286) = 101441197/360000, but
    that denominator overflows the NCO's int32 modular phase law (den must
    stay <= 46341, dsp/nco.line_phase0).  The stored rational is the best
    int32-safe continued-fraction approximant: error 1.05e-10 cycles/line,
    i.e. ~2.1 degrees of accumulated subcarrier phase per HOUR of video
    (the previously used 2254249/8000 drifted 126 deg/second).
    """
    base = NTSC()
    cpl_num, cpl_den = 7476498, 26533
    fsc = 4433618.75
    return dataclasses.replace(
        base,
        name="ntsc443",
        cpl_num=cpl_num,
        cpl_den=cpl_den,
        chroma=dataclasses.replace(base.chroma, fsc=fsc),
    )


def PAL_M() -> StandardConfig:
    """PAL-M (Brazil): 525/29.97 scan, PAL chroma at fsc = 227.25 * fh =
    3.57561187 MHz (cpl = 909/4)."""
    fh = 4.5e6 / 286.0
    cpl_num, cpl_den = 909, 4
    fsc = cpl_num / cpl_den * fh
    base = PAL()
    return dataclasses.replace(
        base,
        name="pal_m",
        fh=fh,
        total_lines=525,
        active_lines=480,
        cpl_num=cpl_num,
        cpl_den=cpl_den,
        chroma=dataclasses.replace(base.chroma, fsc=fsc),
    )


def PAL60() -> StandardConfig:
    """PAL-60 ("pseudo-PAL"): NTSC 525/29.97 scan with full PAL chroma
    (YUV + V-switch) at the PAL-B/G subcarrier — the playback format of
    PAL VCRs / consoles outputting through NTSC-rate raster, and NTSC
    material dubbed for PAL displays.

    Shares NTSC-4.43's subcarrier geometry: cpl = 4433618.75/(4.5e6/286),
    stored as the int32-safe continued-fraction approximant 7476498/26533
    (see :func:`NTSC443` — error 1.05e-10 cycles/line).  The phase law
    never flips ~180 deg at 1-2 line spacing, so the decoder registry
    offers the baseband paths (notch / delayline / avg), not carrier combs
    — matching real PAL-60 receivers, which use the delay-line decoder.
    """
    base = PAL()
    fh = 4.5e6 / 286.0
    return dataclasses.replace(
        base,
        name="pal60",
        fh=fh,
        total_lines=525,
        active_lines=480,
        cpl_num=7476498,
        cpl_den=26533,
        chroma=dataclasses.replace(base.chroma, fsc=4433618.75),
    )


def PAL_N() -> StandardConfig:
    """PAL-N (Argentina/Paraguay/Uruguay): 625/25 scan, fsc = 3.58205625 MHz
    (cpl = 573129/2500, the same +25 Hz-style offset trick as PAL-B/G)."""
    base = PAL()
    cpl_num, cpl_den = 573129, 2500
    fsc = cpl_num / cpl_den * base.fh
    return dataclasses.replace(
        base,
        name="pal_n",
        cpl_num=cpl_num,
        cpl_den=cpl_den,
        chroma=dataclasses.replace(base.chroma, fsc=fsc),
    )


ALL_STANDARDS = {
    "ntsc": NTSC,
    "pal": PAL,
    "secam": SECAM,
    "niir": NIIR,
    "ntsc443": NTSC443,
    "pal_m": PAL_M,
    "pal_n": PAL_N,
    "pal60": PAL60,
}

__all__ = [
    "NTSC",
    "PAL",
    "SECAM",
    "NIIR",
    "NTSC443",
    "PAL_M",
    "PAL_N",
    "PAL60",
    "ALL_STANDARDS",
    "StandardConfig",
    "QamParams",
    "FmParams",
]
