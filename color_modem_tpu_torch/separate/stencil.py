"""Line- and frame-axis shifts, as in ``color_modem_tpu/separate/stencil.py``.

Line edges reflect (line -1 maps to line +1), the golden oracle's
``_reflect`` rule.  Frame edges do not: see :func:`prev_reflect_frames`.
"""

from __future__ import annotations

import torch


def prev_reflect(x: torch.Tensor, p: int) -> torch.Tensor:
    """y[..., l, :] = x[..., l-p, :], reflecting at the top: y[l<p] = x[p-l]."""
    if p < 1:
        raise ValueError("p must be >= 1")
    head = x[..., 1 : p + 1, :].flip(-2)
    return torch.cat([head, x[..., :-p, :]], dim=-2)


def next_reflect(x: torch.Tensor, p: int) -> torch.Tensor:
    """y[..., l, :] = x[..., l+p, :], reflecting at the bottom."""
    if p < 1:
        raise ValueError("p must be >= 1")
    n = x.shape[-2]
    tail = x[..., n - p - 1 : n - 1, :].flip(-2)
    return torch.cat([x[..., p:, :], tail], dim=-2)


def _check_frames(x: torch.Tensor, p: int) -> None:
    if p < 1:
        raise ValueError("p must be >= 1")
    if x.shape[-3] < 2 * p:
        raise ValueError(f"temporal comb needs >= {2*p} frames per block")


def prev_reflect_frames(x: torch.Tensor, p: int) -> torch.Tensor:
    """Frame-axis (-3) shift, "the frame p before me", with phase-safe edges.

    The temporal comb cancels against a frame an odd multiple of ``p``
    away, whose chroma phase is opposite.  So the first ``p`` frames borrow
    ``x[t+p]``, not the index reflection ``x[p-t]`` (at p=2 that pairs
    frame 1 with a frame of its own parity).
    """
    _check_frames(x, p)
    return torch.cat([x[..., p : 2 * p, :, :], x[..., :-p, :, :]], dim=-3)


def next_reflect_frames(x: torch.Tensor, p: int) -> torch.Tensor:
    """Frame-axis "the frame p after me"; see :func:`prev_reflect_frames`."""
    _check_frames(x, p)
    n = x.shape[-3]
    return torch.cat([x[..., p:, :, :], x[..., n - 2 * p : n - p, :, :]], dim=-3)
