"""Standards conversion: decode one standard's composite, encode another's.

Port of ``color_modem_tpu/frame/transcode.py``.  Decode with the source
standard's best line-local decoder (the source kernels on
``backend="kernel"``), resample the active raster between line counts
(480 <-> 576) with the width resampler's windowed-sinc matmul applied along
the line axis, clamp to [0, 1] (the resample's sinc ringing overshoots),
and re-encode with the destination's phase law (the destination kernels).
Frames map one to one by index (held-frame rate conversion), as in the JAX
package.

    conv = make_transcoder(plan_ntsc, plan_pal, device="cuda")
    pal_composite = conv(ntsc_composite, frame0)
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.standards.decoders import allowed_decoders
from color_modem_tpu_torch.dsp.colorimetry import clamp01
from color_modem_tpu_torch.dsp.resample import resample_width
from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline
from color_modem_tpu_torch.frame.pipeline import (
    Plan,
    _check_backend,
    decode_block,
    encode_block,
    frame_line_index,
    resolve_device,
)
from color_modem_tpu_torch.modem.plan import plan_on


def resample_lines(x: torch.Tensor, l_out: int) -> torch.Tensor:
    """(..., L, N) -> (..., l_out, N): anti-aliased vertical resampling."""
    return resample_width(x.transpose(-1, -2), l_out).transpose(-1, -2)


def best_decoder(plan: Plan) -> str:
    """The best line-local decoder the standard offers (comb3 > delayline >
    notch); the temporal comb needs a frame sequence and is left to
    explicit callers."""
    offered = allowed_decoders(plan.cfg)
    for d in ("comb3", "delayline", "notch"):
        if d in offered:
            return d
    return offered[0]


def _resample_raster(rgb: torch.Tensor, l_dst: int, n_dst: int) -> torch.Tensor:
    """Decoded source RGB -> the destination raster, clamped to [0, 1]."""
    return clamp01(resample_width(resample_lines(rgb, l_dst), n_dst))


def transcode_block(plan_src: Plan, plan_dst: Plan, comp: torch.Tensor,
                    g_src: torch.Tensor, g_dst: torch.Tensor,
                    decoder: str | None = None, backend: str = "kernel") -> torch.Tensor:
    """(..., L_src, N_src) source composite -> (..., L_dst, N_dst); ``g_dst``
    (..., L_dst) defines the destination raster."""
    rgb = decode_block(plan_src, comp, g_src, decoder or best_decoder(plan_src), backend)
    rgb = _resample_raster(rgb, g_dst.shape[-1], plan_dst.n_samples)
    return encode_block(plan_dst, rgb, g_dst, backend)


def make_transcoder(plan_src: Plan, plan_dst: Plan, decoder: str | None = None,
                    backend: str = "kernel", device: torch.device | str = "cuda"):
    """``(comp_src (B, L, N), frame0) -> comp_dst`` closure; frame
    ``frame0+i`` of the source drives frame ``frame0+i`` of the
    destination's phase sequence.  It runs on copies of both plans on
    ``device``; the caller's plans stay where they are."""
    _check_backend(backend)
    device = resolve_device(device)
    plan_src, plan_dst = plan_on(plan_src, device), plan_on(plan_dst, device)

    @torch.inference_mode()
    def transcode(comp, frame0=0):
        comp = torch.as_tensor(comp, dtype=torch.float32, device=device)
        b, l = comp.shape[0], comp.shape[-2]
        g_src = frame_line_index(plan_src, frame0, b, l, device)
        l_dst = round(l * plan_dst.cfg.active_lines / plan_src.cfg.active_lines)
        g_dst = frame_line_index(plan_dst, frame0, b, l_dst, device)
        return transcode_block(plan_src, plan_dst, comp, g_src, g_dst, decoder, backend)

    return transcode


def make_interlaced_transcoder(plan_src: Plan, plan_dst: Plan, decoder: str | None = None,
                               backend: str = "kernel", device: torch.device | str = "cuda"):
    """Field-sequential converter: (2B, L/2, N) source fields -> (2B, L'/2,
    N) destination fields.  Decodes the source fields (weaving the frame),
    resamples the woven raster to an even line count, and re-splits it with
    the destination's field line numbering."""
    _, dec_src, _ = make_interlaced_pipeline(
        plan_src, decoder or best_decoder(plan_src), backend, device)
    enc_dst, _, _ = make_interlaced_pipeline(plan_dst, "notch", backend, device)

    @torch.inference_mode()
    def transcode(comp_fields, frame0=0):
        rgb = dec_src(comp_fields, frame0)
        l_dst = 2 * round(rgb.shape[-2] * plan_dst.cfg.active_lines
                          / plan_src.cfg.active_lines / 2)
        return enc_dst(_resample_raster(rgb, l_dst, plan_dst.n_samples), frame0)

    return transcode
