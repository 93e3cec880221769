"""The rank mesh: one process (rank) per ``(frame, lineblk)`` position.

Port of ``color_modem_tpu/parallel/mesh.py`` onto ``torch.distributed``.
The JAX layer is SPMD inside one process over a ``Mesh(("frame",
"lineblk"))``; here every mesh position is a rank of its own, and a rank
holds one block of the batch:

* ``"frame"``  — data parallelism over the frame batch: frames are
  independent, so no steady-state collective crosses this axis (the
  temporal combs' frame halos excepted);
* ``"lineblk"`` — context parallelism over scanline blocks: each rank owns
  a contiguous block of lines and exchanges 1-4 line halos with its ring
  neighbours (``parallel/halo.py``).  The closed-form NCO means no
  sequential state crosses a block boundary, only stencil halos do.

The sample axis is never split: every FIR runs along samples, so a sample
split would need overlap-save halos on every filter, while the line
stencils are 1-4 lines deep.  For the same reason no stage re-shards with
an ``all_to_all`` between line- and sample-split layouts.

The mesh is ``init_device_mesh`` over the process group, with the frame
and line rings as its two sub-groups.  The backend is chosen when the mesh
is made and recorded on it:

* ``"nccl"`` needs one card per rank (NCCL refuses two ranks on one GPU);
* ``"gloo"`` moves host tensors.  Its ranks may all compute on one card;
  the halo and gather code then copies the few lines it exchanges to the
  host and back (:attr:`Mesh.staged`), decided from the backend and the
  compute device, never by catching an error.

A composite block is ``(B/F, L/Lb, N)``, an RGB block ``(B/F, 3, L/Lb, N)``;
:func:`local_block` takes a rank's block from a global array and
:func:`gather_blocks` assembles the global array on rank 0.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

FRAME_AXIS = "frame"
LINE_AXIS = "lineblk"
#: the flattened grid, frame-major: every rank of the mesh in one ring
FLAT = "flat"
BACKENDS = ("nccl", "gloo")
#: how long a collective waits for its peers before the group gives up
TIMEOUT = datetime.timedelta(seconds=600)

#: layout -> the axes of the global array that the frame and line axes
#: split (None: not split)
LAYOUTS = {
    "composite": (0, 1),   # (B, L, N)
    "rgb": (0, 2),         # (B, 3, L, N)
    "frames": (0, None),   # (B, ...): frames only, replicated over lineblk
}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def free_port() -> int:
    """A localhost port the OS hands out (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_backend(backend: str, world: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        local = _env_int("LOCAL_WORLD_SIZE", world)
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(
                f"backend 'nccl' needs one card per rank: {local} ranks on this "
                f"host, {cards} CUDA device(s), and NCCL refuses two ranks on one "
                "GPU; use backend='gloo' to share a card"
            )


def init_distributed(backend: str) -> None:
    """Join the process group from the torchrun environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    Without ``RANK`` and ``WORLD_SIZE`` the process is a group of one on a
    free localhost port.  Already initialised: the group's backend must be
    ``backend``.  ``"nccl"`` with more ranks on a host than cards raises
    ``ValueError``; it never turns into ``"gloo"``.
    """
    world = _env_int("WORLD_SIZE", 1)
    _check_backend(backend, world)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"process group runs {have!r}, not {backend!r}")
        return
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT") or str(free_port())
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=_env_int("RANK", 0),
        world_size=world, timeout=TIMEOUT,
    )


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(frame, lineblk)`` rank mesh, as this rank sees it."""

    device_mesh: object
    backend: str
    #: the device this rank computes on
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip((FRAME_AXIS, LINE_AXIS), self.device_mesh.mesh.shape))

    def size(self, axis: str) -> int:
        """The ring's length (``lax.axis_size``); ``FLAT``: every rank."""
        if axis == FLAT:
            return self.size(FRAME_AXIS) * self.size(LINE_AXIS)
        return self.device_mesh.size(self.device_mesh.mesh_dim_names.index(axis))

    def index(self, axis: str) -> int:
        """This rank's position on ``axis`` (``lax.axis_index``); on
        ``FLAT``, frame-major, which is its global rank."""
        if axis == FLAT:
            return self.index(FRAME_AXIS) * self.size(LINE_AXIS) + self.index(LINE_AXIS)
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The ring of ranks along ``axis`` through this rank."""
        if axis == FLAT:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    @property
    def n_ranks(self) -> int:
        return self.size(FLAT)

    @property
    def staged(self) -> bool:
        """Whether exchanged tensors go through the host: a gloo group whose
        ranks compute on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _rank_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the mesh on the CPU")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def mesh_shape(frame: int | None, lineblk: int | None, n: int) -> tuple[int, int]:
    """The ``(frame, lineblk)`` sizes of a mesh over ``n`` ranks, the JAX
    package's defaults filled in; raises ``ValueError`` when they do not
    cover the ranks exactly."""
    if frame is None and lineblk is None:
        frame, lineblk = n, 1
    elif frame is None:
        frame = n // lineblk
    elif lineblk is None:
        lineblk = n // frame
    if frame * lineblk > n or frame < 1 or lineblk < 1:
        raise ValueError(f"mesh {frame}x{lineblk} needs more than {n} ranks")
    if frame * lineblk != n:
        raise ValueError(f"mesh {frame}x{lineblk} leaves ranks out of {n}: every "
                         "rank holds one block")
    return frame, lineblk


def make_mesh(frame: int | None = None, lineblk: int | None = None, *,
              backend: str, device: torch.device | str | None = None) -> Mesh:
    """Build a ``(frame, lineblk)`` mesh over every rank of the process group
    (joined first through :func:`init_distributed` when needed).

    With no sizes, every rank goes on the frame axis (pure data
    parallelism, no collectives); give ``lineblk`` to carve out context
    parallelism.  Unlike the JAX mesh, which may leave devices out, the
    rank mesh covers every rank: each rank holds one block.  ``device``:
    where this rank computes, by default ``cuda:LOCAL_RANK % device_count``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    init_distributed(backend)
    frame, lineblk = mesh_shape(frame, lineblk, dist.get_world_size())
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the mesh's own device type is where its collectives' tensors live
    comm_type = "cuda" if backend == "nccl" else "cpu"
    dm = init_device_mesh(comm_type, (frame, lineblk), mesh_dim_names=(FRAME_AXIS, LINE_AXIS))
    return Mesh(dm, backend, device)


def pad_to_multiple(x, axis: int, multiple: int):
    """Reflect-pad ``x`` along ``axis`` so its size divides the mesh axis.

    Returns (padded, original_size).  Sharded pipelines require the sharded
    axes to divide evenly; callers crop the output back.

    Reflect (not edge) padding on the LINE axis matters for correctness, not
    just shape: the bottom real line's comb/delay-line stencil reads the
    first padded line, and reflection supplies exactly the line the
    unsharded pipeline's edge reflection (separate.stencil.next_reflect)
    would read, so padded-then-cropped equals unpadded.  Edge padding would
    hand it a duplicate of itself and halve its chroma estimate.  For the
    frame axis both modes are fine (frames are independent).
    """
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    # reflect can pad at most size-1; only the first padded line is ever
    # read by a real line's stencil, so the fallback mode is inconsequential
    mode = "reflect" if 1 < size > rem else "edge"
    return np.pad(np.asarray(x), pad, mode=mode), size


# --- blocks of a global array -------------------------------------------------


def _block_slices(mesh: Mesh, shape, layout: str, fi: int, li: int) -> tuple:
    fa, la = LAYOUTS[layout]
    sl = [slice(None)] * len(shape)
    for ax, size, i in ((fa, mesh.size(FRAME_AXIS), fi), (la, mesh.size(LINE_AXIS), li)):
        if ax is None:
            continue
        if shape[ax] % size:
            raise ValueError(f"{layout} axis {ax} of {shape[ax]} does not divide the "
                             f"mesh's {size} blocks")
        n = shape[ax] // size
        sl[ax] = slice(i * n, (i + 1) * n)
    return tuple(sl)


def local_block(mesh: Mesh, x, layout: str = "rgb") -> torch.Tensor:
    """This rank's block of the global array ``x`` (a tensor or an array),
    float32 on the mesh's device.  ``layout``: ``"composite"`` (B, L, N),
    ``"rgb"`` (B, 3, L, N) or ``"frames"`` (B, ...; frames only)."""
    sl = _block_slices(mesh, x.shape, layout, mesh.index(FRAME_AXIS), mesh.index(LINE_AXIS))
    blk = x[sl]
    if isinstance(blk, torch.Tensor):
        return blk.to(device=mesh.device, dtype=torch.float32).contiguous()
    return torch.tensor(np.ascontiguousarray(blk, np.float32), device=mesh.device)


def line_block(mesh: Mesh, full: torch.Tensor) -> torch.Tensor:
    """This rank's line block of frames that hold every line (axis -2), on
    the device they are on."""
    n = full.shape[-2] // mesh.size(LINE_AXIS)
    j = mesh.index(LINE_AXIS)
    return full[..., j * n : (j + 1) * n, :].contiguous()


@contextlib.contextmanager
def staging():
    """The host copies of a gloo exchange on a card: the one intended host
    sync of a rank's step.  ``torch.cuda``'s sync debug mode is suspended
    over them, so a caller can watch the rest of the step with
    ``set_sync_debug_mode("error")``."""
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def to_comm(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the process group moves it: contiguous, on the host when the
    mesh is staged."""
    if mesh.staged:
        with staging():
            return t.to("cpu")
    return t.contiguous()


def from_comm(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A received tensor back on the rank's device."""
    if mesh.staged:
        with staging():
            return t.to(mesh.device)
    return t


def _assemble(mesh: Mesh, blocks: list, layout: str) -> torch.Tensor:
    fa, la = LAYOUTS[layout]
    nf, nl = mesh.size(FRAME_AXIS), mesh.size(LINE_AXIS)
    shape = list(blocks[0].shape)
    shape[fa] *= nf
    if la is not None:
        shape[la] *= nl
    out = blocks[0].new_empty(shape)
    for r, blk in enumerate(blocks):
        fi, li = divmod(r, nl)
        if la is None and li:
            continue  # a replica over the line ring
        out[_block_slices(mesh, shape, layout, fi, li)] = blk
    return out


def gather_blocks(mesh: Mesh, blk: torch.Tensor, layout: str = "rgb") -> torch.Tensor | None:
    """Assemble every rank's block into the global array on rank 0 (on its
    device); the other ranks get None.  Every rank must call it."""
    send = to_comm(mesh, blk)
    bufs = [torch.empty_like(send) for _ in range(mesh.n_ranks)] if dist.get_rank() == 0 \
        else None
    dist.gather(send, bufs, dst=0)
    if bufs is None:
        return None
    return from_comm(mesh, _assemble(mesh, bufs, layout))


def ring_all_gather(mesh: Mesh, axis: str, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every ``axis`` ring member's ``t``, concatenated along ``dim`` in ring
    order, on every member."""
    if mesh.size(axis) == 1:
        return t
    send = to_comm(mesh, t)
    bufs = [torch.empty_like(send) for _ in range(mesh.size(axis))]
    dist.all_gather(bufs, send, group=mesh.group(axis))
    return from_comm(mesh, torch.cat(bufs, dim=dim))
