"""Temporal noise reduction (3D NR) on decoded frames.

Port of ``color_modem_tpu/frame/nr.py``.  Successive frames are averaged
wherever the scene is static (noise is uncorrelated from frame to frame,
the picture is not), gated by a motion detector so moving objects do not
ghost.  It works on decoded RGB, so it composes with every standard and
decoder, SECAM included.  Display-side tensor code: the JAX package has no
Pallas kernel for it, and the port has no CUDA kernel.

    clean = temporal_nr(decoded_frames, sigma=0.02)
"""

from __future__ import annotations

import numpy as np
import torch

from color_modem_tpu_torch.separate.stencil import next_reflect_frames, prev_reflect_frames


def box_smooth(x: torch.Tensor, width: int, axis: int) -> torch.Tensor:
    """O(n) cumulative-sum box filter along one axis, edges held."""
    if width % 2 != 1:
        raise ValueError(f"box width must be odd, got {width}")
    pad = width // 2
    xm = torch.movedim(x, axis, -1)
    lead = xm.shape[:-1]
    xp = torch.cat([xm.new_zeros(*lead, 1), xm[..., :1].expand(*lead, pad), xm,
                    xm[..., -1:].expand(*lead, pad)], dim=-1)
    c = torch.cumsum(xp, dim=-1)
    return torch.movedim((c[..., width:] - c[..., :-width]) / width, -1, axis)


def lower_quartile(d: torch.Tensor) -> torch.Tensor:
    """The 25th percentile of all of ``d`` with linear interpolation, as
    ``jnp.percentile(d, 25)`` computes it (position ``0.25 * (n - 1)`` in
    float32), as a 0-dim tensor on ``d``'s device.  A sort, not
    ``torch.quantile``, which refuses more than 2^24 elements."""
    flat = torch.sort(d.reshape(-1)).values
    n = flat.numel()
    pos = np.float32(0.25) * (np.float32(n) - np.float32(1.0))
    low = int(np.floor(pos))
    high = min(int(np.ceil(pos)), n - 1)
    w_high = np.float32(pos - np.float32(low))
    w_low = np.float32(np.float32(1.0) - w_high)
    return flat[low] * float(w_low) + flat[high] * float(w_high)


def temporal_nr(rgb: torch.Tensor, sigma: float | None = None,
                spatial_smooth: int = 9) -> torch.Tensor:
    """(B, 3, L, N) decoded frames -> noise-reduced frames.

    ``sigma`` is the expected per-channel noise standard deviation on the
    decoded planes; ``None`` estimates the floor from the lower quartile of
    the motion metric (static regions dominate it; a whole-frame pan
    defeats it, so prefer an explicit ``sigma``).  Where the local
    mean-square frame difference is noise-sized the three-frame average
    applies; as it grows picture-sized the gate closes continuously and the
    current frame passes through.
    """
    if rgb.dim() < 4:
        raise ValueError("temporal_nr needs a (frames, 3, L, N) batch")
    # the frame stencils shift axis -3; put channels in front: (3, B, L, N)
    x = rgb.to(torch.float32).transpose(0, 1)
    prev = prev_reflect_frames(x, 1)
    nxt = next_reflect_frames(x, 1)

    # AGC/flicker compensation: match each neighbour's global mean to the
    # current frame's before differencing and averaging.  The means sum in
    # float64: a float32 reduction's order depends on the batch size on
    # CUDA, and the gate amplifies its 3e-8 into 6e-7 of output, which
    # would make the video runner's output depend on the chunk size.
    def _frame_mean(t):
        return t.mean(dim=(0, -1, -2), keepdim=True, dtype=torch.float64).to(torch.float32)

    def _match(nb):
        return nb * (_frame_mean(x) / torch.clamp_min(_frame_mean(nb), 1e-6))

    prev, nxt = _match(prev), _match(nxt)
    d = ((x - prev) ** 2 + (x - nxt) ** 2).mean(dim=0, keepdim=True)
    d = box_smooth(box_smooth(d, spatial_smooth, -1), spatial_smooth, -2)
    # two uncorrelated noise differences give E[d] = 4 sigma^2
    eps = np.float32(1e-9)
    if sigma is None:
        noise_floor = lower_quartile(d)
        thr = 2.0 * noise_floor + float(eps)
    else:  # float32 scalars, as the JAX package's
        nf = np.float32(4.0 * sigma * sigma)
        noise_floor, thr = float(nf), float(np.float32(2.0) * nf + eps)
    w = thr / (thr + torch.clamp_min(d - noise_floor, 0.0))
    out = w * (prev + x + nxt) / 3.0 + (1.0 - w) * x
    return out.transpose(0, 1)
