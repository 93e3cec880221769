"""GOLDEN ORACLE frame layer — sequential per-line loops (SURVEY.md §4.2).

The port's copy of ``color_modem_tpu/golden/frame.py`` (see
``golden/modems.py``): it takes a port plan and reads its float64 host
designs through :func:`~color_modem_tpu_torch.golden.modems.host_plan`.

Mirrors the reference's image layer (SURVEY.md §1 L4, §3.1-3.4): a Python
``for line in range(height)`` loop over the per-line modems, with the 1-line
cross-line dependencies (SECAM/NIIR pairing, PAL delay-line, combs) expressed
as explicit neighbor-index logic.  NumPy float64 only; FROZEN (see
golden/modems.py header).

Arrays are channels-first ``(3, L, N)`` to match the JAX pipeline layout.
"""

from __future__ import annotations

import numpy as np

from color_modem_tpu_torch.golden.modems import (
    GoldenQamModem,
    GoldenSecamModem,
    conv_same,
    host_plan,
)
from color_modem_tpu_torch.standards.base import FmParams, QamParams
from color_modem_tpu_torch.standards.decoders import (  # noqa: F401  (re-export)
    FM_DECODERS,
    QAM_DECODERS,
    allowed_decoders,
    comb_spacing,
)


def _reflect(idx: int, n: int) -> int:
    if idx < 0:
        return -idx
    if idx >= n:
        return 2 * (n - 1) - idx
    return idx


def _neighbor(l: int, n_lines: int) -> int:
    """Opposite-parity partner line: previous, except the first line pairs
    with the next (both choices always have opposite parity)."""
    return l - 1 if l >= 1 else l + 1


def encode_frame(plan, rgb: np.ndarray, frame: int = 0) -> np.ndarray:
    """(3, L, N) gamma-corrected RGB in [0,1] -> (L, N) composite."""
    plan = host_plan(plan)
    rgb = np.asarray(rgb, dtype=np.float64)
    _, n_lines, _ = rgb.shape
    ycc = np.einsum("dc,cln->dln", plan.rgb_to_ycc, rgb)
    cfg = plan.cfg
    if isinstance(cfg.chroma, QamParams):
        modem = GoldenQamModem(plan)
    else:
        modem = GoldenSecamModem(plan)
    comp = np.empty((n_lines, plan.n_samples), dtype=np.float64)
    for l in range(n_lines):
        g = frame * cfg.total_lines + l
        comp[l] = modem.modulate_components(g, ycc[0, l], ycc[1, l], ycc[2, l])
    return comp


def decode_frame(
    plan, comp: np.ndarray, frame: int = 0, decoder: str = "notch"
) -> np.ndarray:
    """(L, N) composite -> (3, L, N) RGB, clamped to [0,1]."""
    plan = host_plan(plan)
    comp = np.asarray(comp, dtype=np.float64)
    cfg = plan.cfg
    allowed = allowed_decoders(cfg)
    if decoder not in allowed:
        raise ValueError(
            f"{cfg.name} supports decoders {allowed}, got {decoder!r}"
        )
    if decoder in ("comb3d", "comb3dA"):
        # temporal: crosses frames, which this per-frame entry point cannot
        # represent — use decode_sequence on the (F, L, N) composite stack
        raise NotImplementedError(
            "decode_frame decodes one frame at a time; use "
            "golden.decode_sequence for the temporal combs"
        )
    if isinstance(cfg.chroma, FmParams):
        ycc = _decode_secam(plan, comp, frame, decoder)
    else:
        ycc = _decode_qam(plan, comp, frame, decoder)
    rgb = np.einsum("cd,dln->cln", plan.ycc_to_rgb, ycc)
    return np.clip(rgb, 0.0, 1.0)


def _decode_qam(plan, comp, frame, decoder):
    cfg = plan.cfg
    modem = GoldenQamModem(plan)
    n_lines = comp.shape[0]
    p = comb_spacing(cfg)

    luma = np.empty_like(comp)
    c1 = np.empty_like(comp)
    c2 = np.empty_like(comp)
    for l in range(n_lines):
        g = frame * cfg.total_lines + l
        if decoder == "comb2":
            prev = comp[_reflect(l - p, n_lines)]
            chroma_band = conv_same((comp[l] - prev) / 2.0, plan.chroma_bpf)
            y = comp[l] - chroma_band
        elif decoder == "comb3":
            prev = comp[_reflect(l - p, n_lines)]
            nxt = comp[_reflect(l + p, n_lines)]
            chroma_band = conv_same(
                (2.0 * comp[l] - prev - nxt) / 4.0, plan.chroma_bpf
            )
            y = comp[l] - chroma_band
        elif decoder == "combA":
            # adaptive (soft-switching) comb — same math as
            # separate.comb.separate_adaptive, per scanline: blend the
            # up/down differences by the COMB COMPLEMENTS' energies (the
            # band-limited sum cancels chroma only for a matching neighbor)
            from color_modem_tpu_torch.standards.decoders import (
                ADAPTIVE_BIAS,
                ADAPTIVE_EPS,
            )

            prev = comp[_reflect(l - p, n_lines)]
            nxt = comp[_reflect(l + p, n_lines)]
            d1 = conv_same((comp[l] - prev) / 2.0, plan.chroma_bpf)
            d2 = conv_same((comp[l] - nxt) / 2.0, plan.chroma_bpf)
            k1 = conv_same((comp[l] + prev) / 2.0, plan.chroma_bpf)
            k2 = conv_same((comp[l] + nxt) / 2.0, plan.chroma_bpf)
            e1 = conv_same(k1 * k1, plan.comb_sel_lpf)
            e2 = conv_same(k2 * k2, plan.comb_sel_lpf)
            bias = ADAPTIVE_BIAS * conv_same(
                d1 * d1 + d2 * d2, plan.comb_sel_lpf
            ) + ADAPTIVE_EPS
            w1 = (e2 + bias) / (e1 + e2 + 2.0 * bias)
            chroma_band = w1 * d1 + (1.0 - w1) * d2
            y = comp[l] - chroma_band
        else:  # notch / delayline / avg all separate with the sample-axis notch
            y, chroma_band = modem.separate_notch(comp[l])
        luma[l] = y
        c1[l], c2[l] = modem.demodulate_carrier(g, chroma_band)

    qp: QamParams = cfg.chroma
    if decoder in ("delayline", "avg") and qp.reference_amplitude is None:
        c1, c2 = _average_neighbor(c1), _average_neighbor(c2)

    if qp.reference_amplitude is not None:
        c1, c2 = _niir_normalize(plan, c1, c2, frame)
        if decoder == "avg":
            # NIIR chroma averaging follows the reference normalization:
            # the raw demod output alternates chroma and reference-carrier
            # measurements per line, which must not be mixed by averaging
            c1, c2 = _average_neighbor(c1), _average_neighbor(c2)
    return np.stack([luma, c1, c2])


def _average_neighbor(c: np.ndarray) -> np.ndarray:
    """c'[l] = (c[l] + c[_neighbor(l)]) / 2 — the chroma-averaging wrapper."""
    n_lines = c.shape[0]
    out = np.empty_like(c)
    for l in range(n_lines):
        out[l] = 0.5 * (c[l] + c[_neighbor(l, n_lines)])
    return out


def _niir_normalize(plan, c1, c2, frame):
    """NIIR reference-line normalization (SURVEY.md A.5, K10).

    Even global lines carry chroma, odd lines the unmodulated reference
    carrier (demodulating to (A_ref, 0)).  Each output line takes the chroma
    measurement from the nearest chroma line and divides by the complex
    reference measurement from the nearest reference line, cancelling channel
    gain/phase errors.
    """
    cfg = plan.cfg
    a_ref = cfg.chroma.reference_amplitude
    n_lines = c1.shape[0]
    z = c1 + 1j * c2
    out = np.empty_like(z)
    for l in range(n_lines):
        g = frame * cfg.total_lines + l
        m = _neighbor(l, n_lines)
        if g % 2 == 0:  # chroma line; neighbor is reference
            zc, zr = z[l], z[m]
        else:
            zc, zr = z[m], z[l]
        denom = np.where(np.abs(zr) < 1e-6, a_ref, zr)
        out[l] = zc * (a_ref / denom)
    return out.real.copy(), out.imag.copy()


def _frame_prev(f: int, n_frames: int, p: int) -> int:
    """Frame index ``p`` before ``f`` under the phase-safe edge rule of
    separate.stencil.prev_reflect_frames: a missing top frame borrows from
    ``f + p`` (an odd multiple of the comb spacing away, so its chroma
    phase is opposite — an index reflection would pair an edge frame with
    its own parity and halve its chroma)."""
    return f - p if f >= p else f + p


def _frame_next(f: int, n_frames: int, p: int) -> int:
    return f + p if f + p < n_frames else f - p


def decode_sequence(
    plan,
    comps: np.ndarray,
    frame0: int = 0,
    decoder: str = "comb3d",
) -> np.ndarray:
    """(F, L, N) composite stack -> (F, 3, L, N) RGB — the MULTI-frame oracle.

    Temporal decoders (comb3d, comb3dA) comb along the frame axis, which the
    per-frame :func:`decode_frame` cannot represent; this is their golden
    mirror: sequential per-line NumPy loops over a small frame stack, frame
    neighbors per the phase-safe edge rule (see :func:`_frame_prev`), line
    neighbors per ``_reflect``.  Non-temporal decoders fall through to
    :func:`decode_frame` per frame (convenience, same numbers).
    """
    plan = host_plan(plan)
    comps = np.asarray(comps, dtype=np.float64)
    if comps.ndim != 3:
        raise ValueError(f"need a (F, L, N) stack, got {comps.shape}")
    if decoder not in ("comb3d", "comb3dA"):
        return np.stack([
            decode_frame(plan, comps[f], frame=frame0 + f, decoder=decoder)
            for f in range(comps.shape[0])
        ])
    cfg = plan.cfg
    if decoder not in allowed_decoders(cfg):
        raise ValueError(
            f"{cfg.name} supports decoders {allowed_decoders(cfg)}, "
            f"got {decoder!r}"
        )
    from color_modem_tpu_torch.standards.decoders import (
        ADAPTIVE_BIAS,
        ADAPTIVE_EPS,
        temporal_comb_spacing,
    )

    pt = temporal_comb_spacing(cfg)
    n_frames, n_lines, _ = comps.shape
    if n_frames < 2 * pt:
        raise ValueError(f"temporal comb needs >= {2 * pt} frames")
    p = comb_spacing(cfg)
    modem = GoldenQamModem(plan)
    out = np.empty((n_frames, 3, n_lines, plan.n_samples))
    for f in range(n_frames):
        fp, fn = _frame_prev(f, n_frames, pt), _frame_next(f, n_frames, pt)
        for l in range(n_lines):
            g = (frame0 + f) * cfg.total_lines + l
            cur = comps[f, l]
            if decoder == "comb3d":
                chroma_band = conv_same(
                    (2.0 * cur - comps[fp, l] - comps[fn, l]) / 4.0,
                    plan.chroma_bpf,
                )
            else:  # comb3dA — 4 candidates, inverse-squared-energy blend
                neighbors = (
                    comps[f, _reflect(l - p, n_lines)],
                    comps[f, _reflect(l + p, n_lines)],
                    comps[fp, l],
                    comps[fn, l],
                )
                ds = [
                    conv_same((cur - nb) / 2.0, plan.chroma_bpf)
                    for nb in neighbors
                ]
                es = [
                    conv_same(
                        conv_same((cur + nb) / 2.0, plan.chroma_bpf) ** 2,
                        plan.comb_sel_lpf,
                    )
                    for nb in neighbors
                ]
                bias = ADAPTIVE_BIAS * conv_same(
                    sum(d * d for d in ds) / 2.0, plan.comb_sel_lpf
                ) + ADAPTIVE_EPS
                inv = [1.0 / (e + bias) ** 2 for e in es]
                chroma_band = sum(
                    w * d for w, d in zip(inv, ds)
                ) / sum(inv)
            out[f, 0, l] = cur - chroma_band
            out[f, 1, l], out[f, 2, l] = modem.demodulate_carrier(
                g, chroma_band
            )
    rgb = np.einsum("cd,fdln->fcln", plan.ycc_to_rgb, out)
    return np.clip(rgb, 0.0, 1.0)


def _decode_secam(plan, comp, frame, decoder="notch"):
    cfg = plan.cfg
    modem = GoldenSecamModem(plan)
    n_lines = comp.shape[0]
    luma = np.empty_like(comp)
    v = np.empty_like(comp)       # this line's demodulated component
    is_r = np.empty(n_lines, dtype=bool)
    for l in range(n_lines):
        g = frame * cfg.total_lines + l
        luma[l], v[l] = modem.demodulate_component(g, comp[l])
        is_r[l] = modem.is_r_line(g)
    dr = np.empty_like(comp)
    db = np.empty_like(comp)
    for l in range(n_lines):
        if decoder == "interp":
            # linear interpolation between BOTH adjacent carrier lines
            # (beyond-reference 'interp'; reflected edges like the stencils)
            o = 0.5 * (
                v[_reflect(l - 1, n_lines)] + v[_reflect(l + 1, n_lines)]
            )
        else:
            m = _neighbor(l, n_lines)  # opposite-parity partner (A.4)
            o = v[m]
        dr[l] = v[l] if is_r[l] else o
        db[l] = o if is_r[l] else v[l]
    if decoder == "avg":
        # chroma-averaging wrapper on the ASSEMBLED planes: consecutive
        # assembled lines share one component and differ in the other, so
        # this averages each component over its two nearest carrier lines
        # (standards/decoders.py FM_DECODERS note)
        dr, db = _average_neighbor(dr), _average_neighbor(db)
    return np.stack([luma, dr, db])
