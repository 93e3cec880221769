"""Batched frame pipeline: RGB <-> composite <-> RGB.

Port of ``color_modem_tpu/frame/pipeline.py`` for the QAM family with the
notch/comb2/comb3 decoders, and for SECAM with notch/avg/interp.
``backend``:

* ``"kernel"`` — the CUDA kernels of ``kernels/qam.py`` and
  ``kernels/secam.py`` on a CUDA device (on the CPU, the same wrappers run
  their plain versions);
* ``"plain"`` — the plain PyTorch modems of ``modem/qam.py`` and
  ``modem/secam.py``.

QAM delay-line averaging, NIIR normalisation and the burst phase/gain hooks
are ROADMAP.md queue 1 item 3 and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import torch

from color_modem_tpu.standards.decoders import allowed_decoders
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu_torch.dsp.nco import global_line_index
from color_modem_tpu_torch.kernels import qam as qam_k
from color_modem_tpu_torch.kernels import secam as secam_k
from color_modem_tpu_torch.modem import qam, secam
from color_modem_tpu_torch.modem.plan import FmPlan, QamPlan
from color_modem_tpu_torch.separate.comb import separate, stencil_signal
from color_modem_tpu_torch.separate.delayline import average_with_neighbor

BACKENDS = ("kernel", "plain")
_QUEUE_ITEM_3 = "is not ported yet (ROADMAP.md queue 1 item 3)"


Plan = QamPlan | FmPlan


def check_decoder(plan: Plan, decoder: str) -> None:
    allowed = allowed_decoders(plan.cfg)
    if decoder not in allowed:
        raise ValueError(
            f"{plan.cfg.name} supports decoders {allowed}, got {decoder!r}"
        )


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def encode_block(plan: Plan, rgb: torch.Tensor, gline: torch.Tensor,
                 backend: str = "kernel") -> torch.Tensor:
    """(..., 3, L, N) RGB in [0,1] + (..., L) absolute lines -> (..., L, N)."""
    _check_backend(backend)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb.to(torch.float32))
    if plan.cfg.is_fm:
        enc = secam_k.encode if backend == "kernel" else secam.encode
    else:
        enc = qam_k.encode if backend == "kernel" else qam.encode
    return enc(plan, ycc, gline)


def _decode_fm(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor,
               decoder: str, backend: str) -> torch.Tensor:
    pairing = "interp" if decoder == "interp" else "copy"
    dec = secam_k.decode if backend == "kernel" else secam.decode
    ycc = dec(plan, comp, gline, pairing)
    if decoder == "avg":
        # chroma averaging on the assembled D'R/D'B planes, outside the
        # kernel, the same on both backends
        ycc = torch.cat([ycc[..., :1, :, :], average_with_neighbor(ycc[..., 1:, :, :])],
                        dim=-3)
    return ycc


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

    ``phase_err``/``chroma_gain`` are QAM-only hooks: SECAM's FM chroma has
    no burst to key on.
    """
    check_decoder(plan, decoder)
    _check_backend(backend)
    comp = comp.to(torch.float32)
    if plan.cfg.is_fm:
        if phase_err is not None or chroma_gain is not None:
            raise ValueError("phase_err and chroma_gain apply to QAM standards only")
        return clamp01(apply_mat3(plan.ycc_to_rgb,
                                  _decode_fm(plan, comp, gline, decoder, backend)))
    if phase_err is not None or chroma_gain is not None:
        raise NotImplementedError(f"the burst phase/gain correction {_QUEUE_ITEM_3}")
    if decoder in ("delayline", "avg"):
        raise NotImplementedError(f"chroma averaging ({decoder!r}) {_QUEUE_ITEM_3}")
    if plan.chroma.reference_amplitude is not None:
        raise NotImplementedError(f"NIIR reference-line normalisation {_QUEUE_ITEM_3}")
    if backend == "kernel":
        sep = stencil_signal(plan, comp, decoder)
        ycc = qam_k.demodulate_separated(plan, sep, comp, gline)
    else:
        luma, chroma_band = separate(plan, comp, decoder)
        c1, c2 = qam.demodulate_carrier(plan, chroma_band, gline)
        ycc = torch.stack([luma, c1, c2], dim=-3)
    return clamp01(apply_mat3(plan.ycc_to_rgb, ycc))


def roundtrip_block(plan: Plan, rgb: torch.Tensor, gline: torch.Tensor,
                    decoder: str = "notch", backend: str = "kernel") -> torch.Tensor:
    comp = encode_block(plan, rgb, gline, backend)
    return decode_block(plan, comp, gline, decoder, backend)


def frame_line_index(plan: Plan, frame0, n_frames: int, n_lines: int,
                     device: torch.device | str) -> torch.Tensor:
    """(B, L) absolute line index array for a frame batch starting at frame0."""
    return global_line_index(frame0, n_frames, n_lines, plan.total_lines, device)


def make_pipeline(plan: Plan, decoder: str = "notch", backend: str = "kernel",
                  device: torch.device | str = "cpu"):
    """Closures over a fixed plan, moved to ``device`` (in place).

    Returns ``(encode, decode, roundtrip)``; each takes a ``(B, ...)`` batch
    (tensor or array) and ``frame0``, the index of the first frame, which
    drives the NTSC 4-field / PAL 8-field phase sequence and the SECAM
    D'R/D'B line parity across batches.
    """
    check_decoder(plan, decoder)
    _check_backend(backend)
    device = torch.device(device)
    plan = plan.to(device)

    def _input(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def encode(rgb, frame0=0):
        rgb = _input(rgb)
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l, device)
        return encode_block(plan, rgb, g, backend)

    @torch.inference_mode()
    def decode(comp, frame0=0):
        comp = _input(comp)
        b, l = comp.shape[0], comp.shape[1]
        g = frame_line_index(plan, frame0, b, l, device)
        return decode_block(plan, comp, g, decoder, backend)

    @torch.inference_mode()
    def roundtrip(rgb, frame0=0):
        rgb = _input(rgb)
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l, device)
        return roundtrip_block(plan, rgb, g, decoder, backend)

    return encode, decode, roundtrip
