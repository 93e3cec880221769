"""Chroma/luma separation: the sample-axis notch, the line-axis combs, the
temporal comb and the adaptive combs.

At the comb spacing ``p`` (1 line for NTSC, 2 for PAL) the subcarrier is
about 180 degrees out of phase, so a line difference cancels luma; at
``temporal_comb_spacing`` frames the whole chroma flips, so a frame
difference does.  Port of ``color_modem_tpu/separate/comb.py``.  The
stencils stay outside the decode kernel, as in the JAX package: plain tensor
slicing here, and on the kernel backend one CUDA pass for the line stencil
of 'comb2' and 'comb3' (``kernels/comb.py``, whose plain version is this
module's :func:`line_stencil`).  The adaptive combs (``combA``,
``comb3dA``) blend their estimates by data-dependent weights; the JAX
package runs them as plain array code on every backend, and so does the
port.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.standards.decoders import (
    ADAPTIVE_BIAS,
    ADAPTIVE_EPS,
    comb_spacing,
    temporal_comb_spacing,
)
from color_modem_tpu_torch.dsp.apply import fir_same
from color_modem_tpu_torch.modem.plan import QamPlan
from color_modem_tpu_torch.separate.stencil import (
    next_reflect,
    next_reflect_frames,
    prev_reflect,
    prev_reflect_frames,
)

#: the separations :func:`separate` offers
SEPARATORS = ("notch", "comb2", "comb3", "comb3d", "combA", "comb3dA")
#: the decoders whose separation is the adaptive blend, not a stencil + BPF
ADAPTIVE = ("combA", "comb3dA")
#: the decoders whose stencil is :func:`line_stencil`
LINE_COMBS = ("comb2", "comb3")


def _temporal_spacing(plan: QamPlan, comp: torch.Tensor, decoder: str) -> int:
    pt = temporal_comb_spacing(plan.cfg)
    if pt is None:
        raise ValueError(f"{plan.cfg.name}: no temporal comb spacing")
    if comp.dim() < 3:
        raise ValueError(
            f"{decoder} needs a batched (frames, lines, samples) block: "
            "the frame axis is what it combs along"
        )
    return pt


def line_stencil(x: torch.Tensor, p: int, decoder: str) -> torch.Tensor:
    """The stencil signal of ``decoder`` ('comb2' or 'comb3') over the line
    axis at comb spacing ``p``, the edges reflected: ``(x[l] - x[l-p]) / 2``
    or ``(2 x[l] - x[l-p] - x[l+p]) / 4``."""
    if decoder == "comb2":
        return (x - prev_reflect(x, p)) / 2.0
    return (2.0 * x - prev_reflect(x, p) - next_reflect(x, p)) / 4.0


def stencil_signal(plan: QamPlan, comp: torch.Tensor, decoder: str) -> torch.Tensor:
    """The signal whose sample-axis BPF is the chroma band: line differences
    for the combs, frame differences for 'comb3d', the composite itself for
    the notch (and for 'delayline'/'avg', which average after
    demodulation)."""
    if decoder == "comb3d":
        pt = _temporal_spacing(plan, comp, decoder)
        return (
            2.0 * comp - prev_reflect_frames(comp, pt) - next_reflect_frames(comp, pt)
        ) / 4.0
    if decoder in LINE_COMBS:
        return line_stencil(comp, comb_spacing(plan.cfg), decoder)
    return comp


def separate(plan: QamPlan, comp: torch.Tensor, decoder: str):
    """(..., L, N) composite -> (luma, chroma_band)."""
    if decoder == "combA":
        return separate_adaptive(plan, comp)
    if decoder == "comb3dA":
        return separate_adaptive_3d(plan, comp)
    chroma_band = fir_same(stencil_signal(plan, comp, decoder), plan.chroma_bpf_mat)
    return comp - chroma_band, chroma_band


def separate_adaptive(plan: QamPlan, comp: torch.Tensor):
    """Soft-switching adaptive comb ('combA').

    The up and down line differences ``d1``, ``d2`` are blended with
    weights inversely proportional to the smoothed energy of their comb
    complements (the band-limited SUM with the same neighbour, which
    cancels chroma exactly when that neighbour carries the same chroma),
    plus a chroma-scale bias.  The JAX package's order of operations.
    """
    p = comb_spacing(plan.cfg)
    bpf, sel = plan.chroma_bpf_mat, plan.comb_sel_lpf_mat
    prev = prev_reflect(comp, p)
    nxt = next_reflect(comp, p)
    d1 = fir_same((comp - prev) / 2.0, bpf)
    d2 = fir_same((comp - nxt) / 2.0, bpf)
    k1 = fir_same((comp + prev) / 2.0, bpf)
    k2 = fir_same((comp + nxt) / 2.0, bpf)
    e1 = fir_same(k1 * k1, sel)
    e2 = fir_same(k2 * k2, sel)
    bias = ADAPTIVE_BIAS * fir_same(d1 * d1 + d2 * d2, sel) + ADAPTIVE_EPS
    w1 = (e2 + bias) / (e1 + e2 + 2.0 * bias)
    chroma_band = w1 * d1 + (1.0 - w1) * d2
    return comp - chroma_band, chroma_band


def separate_adaptive_3d(plan: QamPlan, comp: torch.Tensor):
    """Motion-adaptive 3D comb ('comb3dA').

    Four estimates compete per sample: the up/down line differences and the
    previous/next frame differences.  Each is weighted by the inverse
    SQUARED smoothed energy of its comb complement plus the chroma-scale
    bias, so static content converges to the temporal comb and moving
    content to the spatial one.
    """
    pt = _temporal_spacing(plan, comp, "comb3dA")
    p = comb_spacing(plan.cfg)
    bpf, sel = plan.chroma_bpf_mat, plan.comb_sel_lpf_mat
    neighbors = [
        prev_reflect(comp, p),
        next_reflect(comp, p),
        prev_reflect_frames(comp, pt),
        next_reflect_frames(comp, pt),
    ]
    ds = [fir_same((comp - nb) / 2.0, bpf) for nb in neighbors]
    es = [fir_same(fir_same((comp + nb) / 2.0, bpf) ** 2, sel) for nb in neighbors]
    bias = ADAPTIVE_BIAS * fir_same(sum(d * d for d in ds) / 2.0, sel) + ADAPTIVE_EPS
    inv = [1.0 / (e + bias) ** 2 for e in es]
    denom = sum(inv)
    chroma_band = sum(w * d for w, d in zip(inv, ds)) / denom
    return comp - chroma_band, chroma_band
