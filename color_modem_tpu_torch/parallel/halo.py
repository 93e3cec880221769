"""Halo exchange over the line-block and frame rings.

Port of ``color_modem_tpu/parallel/halo.py``.  Every cross-line dependency
of the decode path is a stencil of at most 2 lines, plus at most 1 line of
averaging or pairing after the demodulation, so a rank that owns a
contiguous block of lines needs only a few neighbour lines (the "halo")
from the blocks beside it.  :func:`halo_extend` fetches them in one batch
of point-to-point sends and receives inside the ring's group (the JAX
package's pair of ``ppermute``\\ s), and fixes up the two global edges with
the rule the unsharded stencils use, so sharded and unsharded pipelines
agree line for line.

A rank on a ring of one concatenates its edge lines and sends nothing.
Ranks of a gloo mesh that compute on a card exchange through the host
(``Mesh.staged``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from color_modem_tpu_torch.parallel.mesh import FRAME_AXIS, LINE_AXIS, Mesh, from_comm, to_comm


def _lines(x: torch.Tensor, sl: slice) -> torch.Tensor:
    """Slice along the line axis (second-to-last)."""
    return x[..., sl, :]


def _frames(x: torch.Tensor, sl: slice) -> torch.Tensor:
    return x[..., sl, :, :]


def ring_exchange(mesh: Mesh, axis: str, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Send ``to_prev`` to the ring neighbour before this rank and
    ``to_next`` to the one after it; return what they sent
    ``(from_prev, from_next)``, None past either end of the ring (the ring
    does not wrap: the global edges take their edge rule instead)."""
    idx, n = mesh.index(axis), mesh.size(axis)
    group = mesh.group(axis)
    ops, recv = [], {}
    for side, peer, payload in (("prev", idx - 1, to_prev), ("next", idx + 1, to_next)):
        if not 0 <= peer < n:
            continue
        g_peer = dist.get_global_rank(group, peer)
        send = to_comm(mesh, payload)
        recv[side] = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, g_peer, group))
        ops.append(dist.P2POp(dist.irecv, recv[side], g_peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    got = {k: from_comm(mesh, v) for k, v in recv.items()}
    return got.get("prev"), got.get("next")


def halo_extend(x: torch.Tensor, h: int, mesh: Mesh, axis: str = LINE_AXIS,
                edge: str = "reflect") -> torch.Tensor:
    """Extend this rank's line block with ``h`` neighbour lines on each side.

    ``x`` is the rank's block ``(..., L_blk, N)``; the result is
    ``(..., L_blk + 2h, N)``.  Interior block boundaries receive the true
    neighbour lines over the ``axis`` ring; the global top and bottom
    edges receive ``edge``-rule lines:

    * ``"reflect"`` — lines ``1..h`` reversed, matching the single-stencil
      ``prev_reflect``/``next_reflect`` rule (combs, pairing, delay line).
    * ``"copy"`` — lines ``0..h-1`` in order.  Required by decoders that
      CHAIN two 1-line prev-stencils (FM/NIIR 'avg': pairing or
      normalisation, then neighbour averaging): running the chain
      block-locally on a copy-extended block reproduces the unsharded
      chain at the global top edge (ext[h-1] = x[h-1] is the pos-h
      neighbour and its own chained value uses raw x[h-2], exactly what the
      unsharded second stencil reads), which the reflect rule does not.
    """
    if h < 1:
        raise ValueError("halo must be >= 1")
    n = x.shape[-2]
    if n < h + 1:
        raise ValueError(f"line block of {n} lines too small for halo {h}")
    if edge == "reflect":
        top_edge = _lines(x, slice(1, h + 1)).flip(-2)
        bot_edge = _lines(x, slice(n - h - 1, n - 1)).flip(-2)
    elif edge == "copy":
        top_edge, bot_edge = _lines(x, slice(0, h)), _lines(x, slice(n - h, n))
    else:
        raise ValueError(f"edge must be 'reflect' or 'copy', got {edge!r}")
    if mesh.size(axis) == 1:
        return torch.cat([top_edge, x, bot_edge], dim=-2)
    # my top h lines become the previous block's bottom halo, my bottom h
    # lines the next block's top halo
    from_prev, from_next = ring_exchange(mesh, axis, _lines(x, slice(0, h)),
                                         _lines(x, slice(n - h, n)))
    top = top_edge if from_prev is None else from_prev
    bot = bot_edge if from_next is None else from_next
    return torch.cat([top, x, bot], dim=-2)


def halo_extend_lines(v: torch.Tensor, h: int, mesh: Mesh, axis: str = LINE_AXIS,
                      edge: str = "reflect") -> torch.Tensor:
    """:func:`halo_extend` for per-line (not per-sample) arrays ``(..., L)``."""
    return halo_extend(v[..., None], h, mesh, axis, edge)[..., 0]


def crop_halo(x: torch.Tensor, h: int) -> torch.Tensor:
    """Drop the halo lines after block-local processing."""
    return _lines(x, slice(h, x.shape[-2] - h))


# --- frame-axis halos (the temporal comb over the data-parallel axis) -------


def halo_extend_frames(x: torch.Tensor, h: int, mesh: Mesh,
                       axis: str = FRAME_AXIS) -> torch.Tensor:
    """Extend this rank's FRAME block (axis -3) with ``h`` neighbour frames
    per side.

    Interior block boundaries receive the true neighbour frames over the
    ``axis`` ring; the two global edges substitute frames an odd multiple
    of the comb spacing away (``x[t+h]`` / ``x[t-h]``), matching
    ``separate/stencil.py::prev_reflect_frames``: an index reflection would
    pair an edge frame with its own chroma parity and halve its chroma.
    """
    if h < 1:
        raise ValueError("halo must be >= 1")
    n = x.shape[-3]
    if n < 2 * h:
        raise ValueError(f"frame block of {n} frames too small for halo {h}")
    top_edge = _frames(x, slice(h, 2 * h))
    bot_edge = _frames(x, slice(n - 2 * h, n - h))
    if mesh.size(axis) == 1:
        return torch.cat([top_edge, x, bot_edge], dim=-3)
    from_prev, from_next = ring_exchange(mesh, axis, _frames(x, slice(0, h)),
                                         _frames(x, slice(n - h, n)))
    top = top_edge if from_prev is None else from_prev
    bot = bot_edge if from_next is None else from_next
    return torch.cat([top, x, bot], dim=-3)


def crop_halo_frames(x: torch.Tensor, h: int) -> torch.Tensor:
    """Drop the halo frames after block-local processing."""
    return _frames(x, slice(h, x.shape[-3] - h))
