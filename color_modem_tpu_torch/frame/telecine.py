"""3:2 pulldown (telecine) and its inverse.

Port of ``color_modem_tpu/frame/telecine.py``.  Film runs at 24 frames/s
and NTSC at about 60 fields/s: every 4 film frames map onto 10 fields in the
2:3:2:3 cadence, field parity alternating top, bottom, top, ...:

    position:  0    1    2    3    4    5    6    7    8    9
    field:     A_t  A_b  B_t  B_b  B_t  C_b  C_t  D_b  D_t  D_b

Positions 4 and 9 repeat positions 2 and 7, so the repeated-field signature
lands on stream indices congruent mod 5.  Inverse telecine finds that
cadence, drops the duplicates and weaves the film frames back exactly.

A field-sequential batch is ``(F, 3, L/2, N)`` with top fields (even rows)
at even indices.  Telecine and reassembly are gathers and the cadence
metric a batched reduction, on the tensors' device; the phase decision is
made on the host from one readback, because the trim offset changes
shapes.
"""

from __future__ import annotations

import numpy as np
import torch

#: film-frame index feeding each of the 10 field positions (A=0 .. D=3)
_FRAME_OF_FIELD = (0, 0, 1, 1, 1, 2, 2, 3, 3, 3)

#: reassembly: (top, bottom) field positions of the four film frames
#: (positions 4 and 9 are the dropped duplicates)
_PAIRS = ((0, 1), (2, 3), (6, 5), (8, 7))


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def telecine(film) -> torch.Tensor:
    """Film frames (4K, 3, L, N) -> field sequence (10K, 3, L/2, N)."""
    film = _as_f32(film)
    f, c, l, n = film.shape
    if f % 4 != 0 or l % 2 != 0:
        raise ValueError("telecine needs a multiple of 4 frames, even rows")
    picked = film.reshape(f // 4, 4, c, l, n)[:, list(_FRAME_OF_FIELD)]
    top = (torch.arange(10, device=film.device) % 2 == 0)[None, :, None, None, None]
    fields = torch.where(top, picked[..., 0::2, :], picked[..., 1::2, :])
    return fields.reshape(-1, c, l // 2, n)


def cadence_metric(fields) -> torch.Tensor:
    """(F,) mean squared difference of each field to the previous
    same-parity field (two back); the first two read +inf.  A true 3:2
    duplicate scores 0 on a clean chain."""
    x = _as_f32(fields)
    d = ((x[2:] - x[:-2]) ** 2).mean(dim=(1, 2, 3))
    return torch.cat([torch.full((2,), float("inf"), device=x.device), d])


def detect_pulldown_phase(fields) -> tuple[int, float]:
    """``(phase, confidence)``: the cadence position (even, 0-8) of the
    stream's first field, and the ratio of the second-best to the best
    residue-class score (>> 1 for film, about 1 for video).  One readback."""
    d = cadence_metric(fields).cpu().numpy()
    if d.shape[0] < 12:
        raise ValueError("need >= 12 fields to detect a 3:2 cadence")
    idx = np.arange(d.shape[0])
    scores = np.array([
        float(np.mean(d[(idx % 5 == c) & np.isfinite(d)]))
        if np.any((idx % 5 == c) & np.isfinite(d)) else np.inf
        for c in range(5)
    ])
    c = int(np.argmin(scores))
    # the phase is the even p in 0..8 with (4 - p) % 5 == c
    phase = next(p for p in (0, 2, 4, 6, 8) if (4 - p) % 5 == c)
    rest = np.delete(scores, c)
    return phase, float(np.min(rest) / max(float(scores[c]), 1e-12))


def inverse_telecine(fields, phase: int | None = None) -> torch.Tensor:
    """Field sequence (F, 3, L/2, N) -> progressive film (4K', 3, L, N):
    detect the cadence when ``phase`` is omitted, trim the partial groups at
    both ends, drop the duplicates and weave each film frame's pair."""
    if phase is None:
        phase, _ = detect_pulldown_phase(fields)
    if phase % 2 != 0 or not 0 <= phase <= 8:
        raise ValueError(f"phase must be even in 0..8, got {phase}")
    x = _as_f32(fields)
    skip = (10 - phase) % 10
    usable = (x.shape[0] - skip) // 10 * 10
    if usable <= 0:
        raise ValueError(
            f"no complete 10-field group after trimming {skip} leading "
            f"fields (got {x.shape[0]})"
        )
    g = x[skip : skip + usable].reshape(usable // 10, 10, *x.shape[1:])
    tops = g[:, [p[0] for p in _PAIRS]]
    bots = g[:, [p[1] for p in _PAIRS]]
    pair = torch.stack([tops, bots], dim=-2)  # (K, 4, 3, L/2, 2, N)
    film = pair.reshape(tuple(pair.shape[:-3]) + (-1, pair.shape[-1]))
    return film.reshape((-1,) + tuple(film.shape[2:]))
