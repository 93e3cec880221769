"""Field-rate interlacing and motion-adaptive deinterlacing.

Port of ``color_modem_tpu/frame/deinterlace.py``.  Real 2:1 broadcast
samples each FIELD at its own instant, so weaving two fields of a moving
scene interleaves two instants (combing):

* :func:`fields_from_framerate` builds the transmitted field sequence from
  frames sampled at field rate;
* :func:`weave` / :func:`bob` are the two classic reconstructions;
* :func:`deinterlace` blends them per sample, gated by same-parity field
  motion, into a full-height frame for every field instant.

Display-side RGB processing on tensors; no kernel in either package.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.frame.interlace import weave_fields
from color_modem_tpu_torch.frame.nr import box_smooth


def fields_from_framerate(rgb2x: torch.Tensor) -> torch.Tensor:
    """(2B, 3, L, N) frames at FIELD rate -> (2B, 3, L/2, N) fields: field
    ``2i`` carries the even rows of instant ``2i``, field ``2i+1`` the odd
    rows of instant ``2i+1``."""
    l = rgb2x.shape[-2]
    if rgb2x.shape[0] % 2 != 0 or l % 2 != 0:
        raise ValueError("needs an even number of field-rate frames and rows")
    pair = torch.stack([rgb2x[0::2, :, 0::2], rgb2x[1::2, :, 1::2]], dim=1)
    return pair.reshape((-1,) + tuple(pair.shape[2:]))


def weave(fields: torch.Tensor) -> torch.Tensor:
    """(2B, 3, L/2, N) fields -> (B, 3, L, N): interleave field pairs (exact
    on static content, combs on motion)."""
    return weave_fields(fields)


def _interleave(even_rows: torch.Tensor, odd_rows: torch.Tensor) -> torch.Tensor:
    """(..., L/2, N) twice -> (..., L, N), rows alternating even, odd."""
    pair = torch.stack([even_rows, odd_rows], dim=-2)
    return pair.reshape(tuple(pair.shape[:-3]) + (-1, pair.shape[-1]))


def _parity(b2: int, device) -> torch.Tensor:
    """(2B, 1, 1, 1) bool, True on bottom fields (odd rows)."""
    return (torch.arange(b2, device=device) % 2 == 1)[:, None, None, None]


def _line_neighbours(x: torch.Tensor):
    """The line above and below each line of a field, edges clamped."""
    prev_line = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    next_line = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    return prev_line, next_line


def bob(fields: torch.Tensor) -> torch.Tensor:
    """(2B, 3, L/2, N) fields -> (2B, 3, L, N): line-double every field at
    its own instant (linear interpolation between its lines, placed by
    parity).  No combing, half the vertical resolution."""
    own = fields
    prev_line, next_line = _line_neighbours(own)
    bottom = _parity(own.shape[0], own.device)
    # top fields: odd row 2k+1 = avg(own k, own k+1); bottom fields: even
    # row 2k = avg(own k-1, own k)
    fill_down = 0.5 * (own + next_line)
    fill_up = 0.5 * (own + prev_line)
    return _interleave(torch.where(bottom, fill_up, own), torch.where(bottom, own, fill_down))


def deinterlace(fields: torch.Tensor, sigma: float = 0.02,
                spatial_smooth: int = 9) -> torch.Tensor:
    """(2B, 3, L/2, N) fields -> (2B, 3, L, N) motion-adaptive frames.

    The missing rows come from the temporal neighbour field (weave, exact if
    static) where the same-parity field difference is noise-sized, and from
    the vertical interpolation (bob) where it is picture-sized.  ``sigma``
    is the expected noise on the decoded planes, as in
    ``frame/nr.py::temporal_nr``.
    """
    b2 = fields.shape[0]
    if b2 % 2 != 0 or b2 < 4:
        raise ValueError(
            "needs a field-sequential batch of >= 4 fields (even count): "
            "the same-parity motion metric compares fields two instants "
            f"apart, got {b2}"
        )
    x = fields.to(torch.float32)
    # the other parity's previous field (the first field borrows its successor)
    neighbor = torch.cat([x[1:2], x[:-1]], dim=0)
    # same-parity motion metric: fields two instants apart
    same_par_prev = torch.cat([x[2:4], x[:-2]], dim=0)
    d = ((x - same_par_prev) ** 2).mean(dim=1, keepdim=True)
    d = box_smooth(box_smooth(d, spatial_smooth, -1), spatial_smooth, -2)
    noise_floor = 4.0 * sigma * sigma
    w_static = (2.0 * noise_floor) / (
        2.0 * noise_floor + torch.clamp_min(d - noise_floor, 0.0) + 1e-9
    )
    prev_line, next_line = _line_neighbours(x)
    bottom = _parity(b2, x.device)
    bob_fill = torch.where(bottom, 0.5 * (x + prev_line), 0.5 * (x + next_line))
    blend = w_static * neighbor + (1.0 - w_static) * bob_fill
    return _interleave(torch.where(bottom, blend, x), torch.where(bottom, x, blend))
