"""2:1 interlaced fields.

Port of ``color_modem_tpu/frame/interlace.py``.  Each frame is transmitted
as two fields, the even rows first, then the odd rows, and every effect
driven by the line number (the NTSC 4-field and PAL 8-field sequences, the
SECAM D'R/D'B alternation, comb spacing) follows the TRANSMITTED line order.
No new modem code is needed, because ``encode_block``/``decode_block`` take
an absolute line index per row:

* a frame batch ``(B, 3, L, N)`` splits into field blocks
  ``(2B, 3, L/2, N)``, each field a contiguous run of transmitted lines;
* field ``p`` of frame ``f`` gets ``g = f*total_lines + p*field_offset + r``
  with ``field_offset = (total_lines+1)//2`` (NTSC 263, PAL/SECAM 313);
* the line combs and delay lines then comb adjacent transmitted lines, two
  rows apart in the woven frame.

The temporal combs ('comb3d', 'comb3dA') comb SAME-PARITY fields: the batch
is regrouped parity-major, ``(2B, L/2, N)`` -> ``(2, B, L/2, N)`` with the
line map regrouped to match, so the frame stencil's axis -3 runs over
same-parity fields one frame apart and the two parity groups stay
independent.  The decode kernel sees the regrouped planes in their logical
order (``kernels/qam.py::demodulate_separated`` makes them contiguous, and
``phase_cols`` reads the regrouped line map in the same order).
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.nco import frame_indices
from color_modem_tpu_torch.frame.pipeline import (
    Plan,
    _check_backend,
    check_decoder,
    decode_block,
    encode_block,
    resolve_device,
)
from color_modem_tpu_torch.frame.raster import add_raster, make_raster, strip_raster
from color_modem_tpu_torch.modem.plan import plan_on


def field_offset(plan: Plan) -> int:
    """Absolute line number offset of field 2's first active row."""
    return (plan.total_lines + 1) // 2


def split_fields(frames: torch.Tensor) -> torch.Tensor:
    """(B, ..., L, N) -> (2B, ..., L/2, N), field-sequential, top field
    first (the transmission order).  L must be even."""
    l = frames.shape[-2]
    if l % 2 != 0:
        raise ValueError(f"interlacing needs an even line count, got {l}")
    pair = torch.stack([frames[..., 0::2, :], frames[..., 1::2, :]], dim=1)
    return pair.reshape((-1,) + tuple(pair.shape[2:]))


def weave_fields(fields: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_fields`: (2B, ..., L/2, N) -> (B, ..., L, N)."""
    b2 = fields.shape[0]
    if b2 % 2 != 0:
        raise ValueError(f"field-sequential batch must be even, got {b2}")
    pair = fields.reshape((b2 // 2, 2) + tuple(fields.shape[1:]))
    # rows interleave: out[..., 2r+p, :] = pair[:, p, ..., r, :]
    pair = torch.movedim(pair, 1, -2)  # (B, ..., L/2, 2, N)
    return pair.reshape(tuple(pair.shape[:-3]) + (-1, pair.shape[-1]))


def field_line_index(plan: Plan, frame0, n_frames: int, n_rows: int,
                     device: torch.device | str) -> torch.Tensor:
    """(2B, L/2) int32 absolute line indices of a field-sequential batch:
    block ``2f+p`` row ``r`` is line ``(frame0+f)*total_lines +
    p*field_offset + r``."""
    f = frame_indices(frame0, n_frames, device)
    p = torch.arange(2, dtype=torch.int32, device=device)
    r = torch.arange(n_rows, dtype=torch.int32, device=device)
    g = (f[:, None, None] * plan.total_lines + p[None, :, None] * field_offset(plan)
         + r[None, None, :])
    return g.reshape(2 * n_frames, n_rows)


def _decode_fields(plan: Plan, comp_fields: torch.Tensor, g: torch.Tensor,
                   decoder: str, backend: str) -> torch.Tensor:
    """(2B, L/2, N) field-sequential composite -> (B, 3, L, N) woven RGB."""
    if decoder not in ("comb3d", "comb3dA"):
        return weave_fields(decode_block(plan, comp_fields, g, decoder, backend))
    b2, rows, n = comp_fields.shape
    # parity-major regroup: axis -3 becomes "same-parity frames"
    cp = comp_fields.reshape(b2 // 2, 2, rows, n).transpose(0, 1)
    gp = g.reshape(b2 // 2, 2, rows).transpose(0, 1)
    out = decode_block(plan, cp, gp, decoder, backend)
    return weave_fields(out.transpose(0, 1).reshape(b2, 3, rows, n))


def make_interlaced_pipeline(plan: Plan, decoder: str = "notch", backend: str = "kernel",
                             device: torch.device | str = "cuda", raster: bool = False):
    """Closures between RGB frames and field-sequential composite, over a
    fixed plan, on a copy of it on ``device`` (the caller's plan stays).

    ``encode(rgb (B, 3, L, N), frame0) -> (2B, L/2, N)`` composite fields in
    transmission order; ``decode`` weaves the two decoded fields back into
    frames; ``roundtrip`` composes both.  'comb3d'/'comb3dA' decode
    parity-major and need at least ``2 * temporal_comb_spacing`` frames.
    ``raster``: sync and burst in each line's blanking interval, on the
    per-field line maps; ``roundtrip`` skips it, since ``strip(add(x)) ==
    x`` exactly.
    """
    check_decoder(plan, decoder)
    _check_backend(backend)
    device = resolve_device(device)
    plan = plan_on(plan, device)
    rp = make_raster(plan) if raster else None

    def _input(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def _encode(rgb, frame0):
        fields = split_fields(rgb)
        g = field_line_index(plan, frame0, rgb.shape[0], fields.shape[-2], device)
        return encode_block(plan, fields, g, backend), g

    @torch.inference_mode()
    def encode(rgb, frame0=0):
        comp, g = _encode(_input(rgb), frame0)
        return comp if rp is None else add_raster(plan, rp, comp, g)

    @torch.inference_mode()
    def decode(comp_fields, frame0=0):
        comp_fields = _input(comp_fields)
        if rp is not None:
            comp_fields = strip_raster(rp, comp_fields)
        g = field_line_index(plan, frame0, comp_fields.shape[0] // 2,
                             comp_fields.shape[-2], device)
        return _decode_fields(plan, comp_fields, g, decoder, backend)

    @torch.inference_mode()
    def roundtrip(rgb, frame0=0):
        comp, g = _encode(_input(rgb), frame0)
        return _decode_fields(plan, comp, g, decoder, backend)

    return encode, decode, roundtrip
