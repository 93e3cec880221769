"""Batched frame pipeline: RGB <-> composite <-> RGB.

Port of ``color_modem_tpu/frame/pipeline.py``: every standard, with every
decoder ``allowed_decoders`` offers it.  ``backend`` names a row of
:data:`STAGES`, the one place that picks each stage's implementation:

* ``"kernel"`` — the wrappers of the CUDA kernels in ``kernels/qam.py``,
  ``kernels/secam.py``, ``kernels/colorimetry.py`` and ``kernels/comb.py``
  (on a CUDA tensor the kernel; on a CPU tensor the wrapper runs its plain
  version);
* ``"plain"`` — the plain PyTorch versions in ``modem/qam.py``,
  ``modem/secam.py``, ``separate/comb.py`` and ``dsp/colorimetry.py``, on
  every device, so that the plain backend on the card stays a witness of
  the kernels.

The adaptive combs ('combA', 'comb3dA') separate with a data-dependent
blend that has no kernel in the JAX package either: on both backends they
take the plain separation and product detector, and only the encode runs
the kernel.  The line stencil of 'comb2' and 'comb3' is a stage of its own
(one CUDA pass on the kernel backend) in front of the separated
demodulation; 'comb3d' keeps its plain frame stencil, and the notch and
averaging decoders hand the composite itself to the demodulation.  After
the QAM demodulation come, in the JAX package's order, the burst phase and
gain hooks and NIIR normalisation.  The averaging decoders' delay line, on
QAM chroma and on SECAM's D'R/D'B alike, is one step with the decoder's
matrix (one CUDA pass on the kernel backend), after all of these.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from color_modem_tpu_torch.standards.decoders import allowed_decoders, comb_spacing
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, delayline_mat3
from color_modem_tpu_torch.dsp.nco import global_line_index
from color_modem_tpu_torch.frame.raster import add_raster, make_raster, strip_raster
from color_modem_tpu_torch.kernels import colorimetry as colour_k
from color_modem_tpu_torch.kernels import comb as comb_k
from color_modem_tpu_torch.kernels import qam as qam_k
from color_modem_tpu_torch.kernels import secam as secam_k
from color_modem_tpu_torch.modem import niir, qam, secam
from color_modem_tpu_torch.modem.plan import FmPlan, QamPlan, plan_on
from color_modem_tpu_torch.separate.comb import (ADAPTIVE, LINE_COMBS, line_stencil, separate,
                                                 stencil_signal)
from color_modem_tpu_torch.utils.tracing import span

#: decoders that average the decoded chroma over adjacent lines
AVERAGING = ("delayline", "avg")


Plan = QamPlan | FmPlan


class Stages(NamedTuple):
    """One backend's function for each stage that has a kernel; each takes
    the arguments of the kernel wrapper in the ``"kernel"`` row."""

    qam_encode: Callable
    qam_demodulate: Callable
    secam_encode: Callable
    secam_decode: Callable
    line_stencil: Callable
    colour_matrix: Callable
    delayline_matrix: Callable


def _stencil_pass(comp: torch.Tensor, p: int, decoder: str) -> torch.Tensor:
    """The kernel backend's line stencil, one pass inside its span."""
    with span("cm.pipeline.stencil"):
        return comb_k.comb_stencil(comp, p, decoder)


#: each backend's stages
STAGES = {
    "kernel": Stages(qam_k.encode, qam_k.demodulate_separated, secam_k.encode, secam_k.decode,
                     _stencil_pass, colour_k.colour_matrix, colour_k.delayline_matrix),
    "plain": Stages(qam.encode, qam.demodulate_separated, secam.encode, secam.decode,
                    line_stencil, apply_mat3, delayline_mat3),
}
BACKENDS = tuple(STAGES)


def check_decoder(plan: Plan, decoder: str) -> None:
    allowed = allowed_decoders(plan.cfg)
    if decoder not in allowed:
        raise ValueError(
            f"{plan.cfg.name} supports decoders {allowed}, got {decoder!r}"
        )


def _check_backend(backend: str) -> Stages:
    """``backend``'s row of :data:`STAGES`; an unknown one raises."""
    if backend not in STAGES:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return STAGES[backend]


def encode_block(plan: Plan, rgb: torch.Tensor, gline: torch.Tensor,
                 backend: str = "kernel") -> torch.Tensor:
    """(..., 3, L, N) RGB in [0,1] + (..., L) absolute lines -> (..., L, N)."""
    impl = _check_backend(backend)
    ycc = impl.colour_matrix(plan.rgb_to_ycc, rgb.to(torch.float32))
    enc = impl.secam_encode if plan.cfg.is_fm else impl.qam_encode
    return enc(plan, ycc, gline)


def _decode_fm(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor,
               decoder: str, impl: Stages) -> torch.Tensor:
    pairing = "interp" if decoder == "interp" else "copy"
    return impl.secam_decode(plan, comp, gline, pairing)


def _demodulate_qam(plan: QamPlan, comp: torch.Tensor, gline: torch.Tensor,
                    decoder: str, impl: Stages) -> torch.Tensor:
    """(..., L, N) composite -> (..., 3, L, N) ``[y, c1, c2]``."""
    if decoder in ADAPTIVE:
        luma, chroma_band = separate(plan, comp, decoder)
        return torch.stack([luma, *qam.demodulate_carrier(plan, chroma_band, gline)],
                           dim=-3)
    if decoder in LINE_COMBS:
        sep = impl.line_stencil(comp, comb_spacing(plan.cfg), decoder)
    else:
        sep = stencil_signal(plan, comp, decoder)
    return impl.qam_demodulate(plan, sep, comp, gline)


def _correct_chroma(plan: QamPlan, ycc: torch.Tensor, gline: torch.Tensor,
                    phase_err: torch.Tensor | None,
                    chroma_gain: torch.Tensor | None) -> torch.Tensor:
    """The steps after the product detector, in the JAX package's order:
    phase counter-rotation, chroma gain and NIIR normalisation (the
    delay-line averaging comes after, with the decoder's matrix).  ``ycc``
    comes back as it is when none applies."""
    is_niir = plan.chroma.reference_amplitude is not None
    if phase_err is None and chroma_gain is None and not is_niir:
        return ycc
    luma, c1, c2 = ycc.unbind(-3)
    if phase_err is not None:
        # a carrier phase error d rotates (c1, s*c2) by d; rotate back
        d = phase_err[..., None].to(torch.float32)
        s = qam.v_sign(plan, gline)[..., None]
        cd, sd = torch.cos(d), torch.sin(d)
        c1, c2 = cd * c1 + s * sd * c2, -s * sd * c1 + cd * c2
    if chroma_gain is not None:
        g = chroma_gain[..., None].to(torch.float32)
        c1, c2 = g * c1, g * c2
    if is_niir:
        c1, c2 = niir.normalize(plan, c1, c2, gline)
    return torch.stack([luma, c1, c2], dim=-3)


def decode_block(
    plan: Plan,
    comp: torch.Tensor,
    gline: torch.Tensor,
    decoder: str = "notch",
    backend: str = "kernel",
    phase_err: torch.Tensor | None = None,
    chroma_gain: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., L, N) composite -> (..., 3, L, N) RGB, clamped to [0,1].

    ``phase_err``: per-line subcarrier phase error (..., L) in rad, which
    the decoder counter-rotates; ``chroma_gain``: per-line chroma gain
    correction (..., L), the ACC / colour-killer hook
    (``frame/raster.py::decode_burst_locked``).  QAM only: SECAM's FM
    chroma has no burst to key on.
    """
    check_decoder(plan, decoder)
    impl = _check_backend(backend)
    comp = comp.to(torch.float32)
    if plan.cfg.is_fm:
        if phase_err is not None or chroma_gain is not None:
            raise ValueError("phase_err and chroma_gain apply to QAM standards only")
        ycc = _decode_fm(plan, comp, gline, decoder, impl)
    else:
        ycc = _demodulate_qam(plan, comp, gline, decoder, impl)
        ycc = _correct_chroma(plan, ycc, gline, phase_err, chroma_gain)
    if decoder in AVERAGING:
        # NIIR's after its normalisation: raw demod alternates chroma and reference
        with span("cm.pipeline.delayline"):
            return impl.delayline_matrix(plan.ycc_to_rgb, ycc)
    return impl.colour_matrix(plan.ycc_to_rgb, ycc, clamp=True)


def roundtrip_block(plan: Plan, rgb: torch.Tensor, gline: torch.Tensor,
                    decoder: str = "notch", backend: str = "kernel") -> torch.Tensor:
    comp = encode_block(plan, rgb, gline, backend)
    return decode_block(plan, comp, gline, decoder, backend)


def frame_line_index(plan: Plan, frame0, n_frames: int, n_lines: int,
                     device: torch.device | str) -> torch.Tensor:
    """(B, L) absolute line index array for a frame batch starting at frame0."""
    return global_line_index(frame0, n_frames, n_lines, plan.total_lines, device)


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``.  The factories default to ``"cuda"``; on a
    machine without CUDA that raises here, before any work, and a CPU run
    passes ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def make_pipeline(plan: Plan, decoder: str = "notch", backend: str = "kernel",
                  device: torch.device | str = "cuda", raster: bool = False):
    """Closures over a fixed plan, on a copy of it on ``device``
    (:func:`~color_modem_tpu_torch.modem.plan.plan_on`; the caller's plan
    stays where it is).

    Returns ``(encode, decode, roundtrip)``; each takes a ``(B, ...)`` batch
    (tensor or array) and ``frame0``, the index of the first frame, which
    drives the NTSC 4-field / PAL 8-field phase sequence and the SECAM
    D'R/D'B line parity across batches.  ``raster``: ``encode`` emits full
    lines with sync and colour burst in the blanking interval and
    ``decode`` strips it (``frame/raster.py``); ``roundtrip`` skips both,
    since ``strip(add(x)) == x`` exactly.
    """
    check_decoder(plan, decoder)
    _check_backend(backend)
    device = resolve_device(device)
    plan = plan_on(plan, device)
    rp = make_raster(plan) if raster else None

    def _input(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def encode(rgb, frame0=0):
        with span("cm.pipeline.encode"):
            rgb = _input(rgb)
            b, _, l, _ = rgb.shape
            g = frame_line_index(plan, frame0, b, l, device)
            comp = encode_block(plan, rgb, g, backend)
            return comp if rp is None else add_raster(plan, rp, comp, g)

    @torch.inference_mode()
    def decode(comp, frame0=0):
        with span("cm.pipeline.decode"):
            comp = _input(comp)
            b, l = comp.shape[0], comp.shape[1]
            g = frame_line_index(plan, frame0, b, l, device)
            if rp is not None:
                comp = strip_raster(rp, comp)
            return decode_block(plan, comp, g, decoder, backend)

    @torch.inference_mode()
    def roundtrip(rgb, frame0=0):
        with span("cm.pipeline.roundtrip"):
            rgb = _input(rgb)
            b, _, l, _ = rgb.shape
            g = frame_line_index(plan, frame0, b, l, device)
            return roundtrip_block(plan, rgb, g, decoder, backend)

    return encode, decode, roundtrip
