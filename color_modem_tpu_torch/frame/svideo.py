"""S-Video (separate Y/C) transmission.

Port of ``color_modem_tpu/frame/svideo.py``.  Composite video's cross-colour
and cross-luminance exist because luma and modulated chroma share one wire;
S-Video keeps them on two.  The encode runs the full composite encoder
(``encode_block``, so the encode kernel on ``backend="kernel"``) and splits
it: ``C = composite - Y``, so ``Y + C`` is the composite to float32
rounding.  The decoder is the ideal S-Video receiver: luma passes
untouched, and chroma demodulates straight off the clean carrier with the
plain product detector (or the plain SECAM discriminator and interpolated
pairing), with no separation stage.  So the decode runs no modem kernel, as
in the JAX package: the decode kernel band-passes its input, and this
receiver does not.  Its ``backend`` picks the colour matrix alone
(``frame/pipeline.py::STAGES``).
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.frame.pipeline import (
    Plan,
    _check_backend,
    encode_block,
    frame_line_index,
    resolve_device,
)
from color_modem_tpu_torch.modem import niir, qam, secam
from color_modem_tpu_torch.modem.plan import plan_on


def encode_yc(plan: Plan, rgb: torch.Tensor, gline: torch.Tensor,
              backend: str = "kernel") -> torch.Tensor:
    """(..., 3, L, N) RGB -> (..., 2, L, N) stacked (Y, C) planes; Y is the
    matrix luma before any filtering."""
    colour = _check_backend(backend).colour_matrix
    y = colour(plan.rgb_to_ycc, rgb.to(torch.float32))[..., 0, :, :]
    comp = encode_block(plan, rgb, gline, backend)
    return torch.stack([y, comp - y], dim=-3)


def decode_yc(plan: Plan, yc: torch.Tensor, gline: torch.Tensor,
              backend: str = "kernel") -> torch.Tensor:
    """(..., 2, L, N) (Y, C) planes -> (..., 3, L, N) RGB in [0, 1]."""
    y, c = yc[..., 0, :, :], yc[..., 1, :, :]
    if plan.cfg.is_fm:
        _, v = secam.demodulate_lines(plan, c, gline)
        c1, c2 = secam.pair_components_interp(v, gline)
    else:
        c1, c2 = qam.demodulate_carrier(plan, c, gline)
        if plan.chroma.reference_amplitude is not None:
            c1, c2 = niir.normalize(plan, c1, c2, gline)
    colour = _check_backend(backend).colour_matrix
    return colour(plan.ycc_to_rgb, torch.stack([y, c1, c2], dim=-3), clamp=True)


def make_svideo_pipeline(plan: Plan, backend: str = "kernel",
                         device: torch.device | str = "cuda"):
    """``(encode, decode, roundtrip)`` closures like ``make_pipeline``'s,
    over ``(B, 2, L, N)`` Y/C signals, on a copy of the plan on ``device``."""
    _check_backend(backend)
    device = resolve_device(device)
    plan = plan_on(plan, device)

    def _input(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def _lines(x, frame0) -> torch.Tensor:
        return frame_line_index(plan, frame0, x.shape[0], x.shape[-2], device)

    @torch.inference_mode()
    def encode(rgb, frame0=0):
        rgb = _input(rgb)
        return encode_yc(plan, rgb, _lines(rgb, frame0), backend)

    @torch.inference_mode()
    def decode(yc, frame0=0):
        yc = _input(yc)
        return decode_yc(plan, yc, _lines(yc, frame0), backend)

    @torch.inference_mode()
    def roundtrip(rgb, frame0=0):
        rgb = _input(rgb)
        g = _lines(rgb, frame0)
        return decode_yc(plan, encode_yc(plan, rgb, g, backend), g, backend)

    return encode, decode, roundtrip
