"""YUV4MPEG2 (.y4m) video file I/O: real clips through the video runner.

Port of ``color_modem_tpu/frame/y4m.py``.  The format is a text header and
fixed-size raw planar frames, the uncompressed interchange every tool
speaks (``ffmpeg -i clip.mp4 clip.y4m``):

    src, n, h, w = y4m_source("clip.y4m")       # FrameSource for process_video
    write_y4m("out.y4m", frames_iter, fps=(30000, 1001))

Colourspaces: C420jpeg / C420mpeg2 / C420paldv (alike: the half-sample
chroma siting difference is far below the modem's chroma bandwidth),
C422, C444, and the header-less default (C420jpeg per spec).  Conversion is
BT.601 studio range (16-235 luma, 16-240 chroma): RGB in [0, 1] <-> 8-bit
YCbCr.  Chroma upsampling is nearest-neighbour; the encoder's chroma
low-pass band-limits it again at once.

Frames are fixed-size, so ``source(start, count)`` is a seek and a read:
random access with no index and no state, what the resumable runner
needs.  Everything here runs on the host and hands back NumPy arrays: the
runner uploads them on its own thread and stream.  The writer emits C444,
so a decode -> write -> read round trip costs only the 8-bit quantisation
(~45 dB), not a chroma subsample.
"""

from __future__ import annotations

import os

import numpy as np

from color_modem_tpu_torch import native

#: BT.601 luma weights and studio-range scaling (the Y4M convention).
_KR, _KG, _KB = 0.299, 0.587, 0.114


def _rgb_to_ycbcr8(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(..., 3, H, W) RGB in [0,1] -> three (..., H, W) uint8 planes."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    y = _KR * r + _KG * g + _KB * b
    cb = (b - y) / (2.0 * (1.0 - _KB))
    cr = (r - y) / (2.0 * (1.0 - _KR))
    y8 = np.clip(16.0 + 219.0 * y + 0.5, 0, 255).astype(np.uint8)
    cb8 = np.clip(128.0 + 224.0 * cb + 0.5, 0, 255).astype(np.uint8)
    cr8 = np.clip(128.0 + 224.0 * cr + 0.5, 0, 255).astype(np.uint8)
    return y8, cb8, cr8


_CHROMA_SHAPES = {
    "420jpeg": (2, 2),
    "420mpeg2": (2, 2),
    "420paldv": (2, 2),
    "420": (2, 2),
    "422": (1, 2),
    "444": (1, 1),
}


def _parse_header(line: bytes):
    parts = line.decode("ascii", "replace").strip().split(" ")
    if parts[0] != "YUV4MPEG2":
        raise ValueError(f"not a YUV4MPEG2 file (header {parts[0]!r})")
    w = h = None
    fps = (25, 1)
    cs = "420jpeg"
    for tok in parts[1:]:
        if not tok:
            continue
        key, val = tok[0], tok[1:]
        if key == "W":
            w = int(val)
        elif key == "H":
            h = int(val)
        elif key == "F":
            num, den = val.split(":")
            fps = (int(num), int(den))
        elif key == "C":
            cs = val
    if w is None or h is None:
        raise ValueError("y4m header missing W or H")
    if cs not in _CHROMA_SHAPES:
        raise ValueError(f"unsupported y4m colorspace C{cs}")
    return w, h, fps, cs


def y4m_info(path: str):
    """Header probe: (width, height, (fps_num, fps_den), colorspace,
    n_frames)."""
    with open(path, "rb") as f:
        header = f.readline()
        w, h, fps, cs = _parse_header(header)
        marker = f.readline()
        if not marker.startswith(b"FRAME"):
            raise ValueError("y4m: expected FRAME after the header")
    sv, sh = _CHROMA_SHAPES[cs]
    frame_bytes = w * h + 2 * (w // sh) * (h // sv)
    stride = len(marker) + frame_bytes
    total = os.path.getsize(path)
    n = (total - len(header)) // stride
    if (total - len(header)) % stride:
        raise ValueError(
            "y4m: non-constant frame size (per-frame parameters are not "
            "supported: re-mux with ffmpeg)"
        )
    return w, h, fps, cs, int(n)


def y4m_source(path: str):
    """Open a .y4m clip as a random-access FrameSource.

    Returns ``(source, n_frames, height, width)`` where
    ``source(start, count) -> (count, 3, H, W) float32 RGB in [0, 1]``,
    the :data:`frame.video.FrameSource` protocol, resume-safe because a
    fixed frame size makes every read a pure seek.
    """
    w, h, fps, cs, n_frames = y4m_info(path)
    sv, sh = _CHROMA_SHAPES[cs]
    cw, ch = w // sh, h // sv
    frame_bytes = w * h + 2 * cw * ch
    with open(path, "rb") as f:
        header_len = len(f.readline())
        marker_len = len(f.readline())
    stride = marker_len + frame_bytes

    def source(start: int, count: int) -> np.ndarray:
        if start < 0 or start + count > n_frames:
            raise ValueError(
                f"y4m: frames [{start}, {start + count}) out of range "
                f"(clip has {n_frames})"
            )
        # one contiguous read for the whole chunk (a seek per frame is
        # slower than over-reading the count marker lines), then the
        # native threaded decoder (NumPy path inside) does the
        # planar-YCbCr -> CHW-float32 conversion in one call
        with open(path, "rb") as f:
            f.seek(header_len + start * stride)
            raw = f.read(count * stride)
        return native.y4m_to_rgb(
            raw, count, stride, marker_len, h, w, ch, cw, sv, sh
        )

    return source, n_frames, h, w


def prefetch_source(source, n_frames: int, depth: int = 1):
    """Wrap a FrameSource with background read-ahead (the data loader).

    The chunked video runner (``frame/video.py``) reads sequential windows;
    this wrapper overlaps the next window's disk read and decode with the
    device's work on the current one: a double-buffered loader with one
    worker thread and no change of behaviour.  ``wrapped(start, count)``
    returns exactly ``source(start, count)``, sequential or not (a miss
    reads synchronously and primes the next window).  The worker touches
    only host memory: the caller uploads what it gets on its own thread,
    so the device work stays on the caller's stream.
    """
    import concurrent.futures as cf

    pool = cf.ThreadPoolExecutor(max_workers=depth)
    pending: dict[tuple[int, int], cf.Future] = {}

    def wrapped(start: int, count: int) -> np.ndarray:
        key = (start, count)
        fut = pending.pop(key, None)
        out = fut.result() if fut is not None else source(start, count)
        nxt = start + count
        nxt_count = min(count, n_frames - nxt)
        if nxt_count > 0 and (nxt, nxt_count) not in pending:
            pending[(nxt, nxt_count)] = pool.submit(source, nxt, nxt_count)
        return out

    return wrapped


def write_y4m(path: str, frames, fps=(30000, 1001)) -> int:
    """Stream (B, 3, H, W) float32 RGB batches (any iterable of host arrays)
    to a C444 .y4m file; returns the frame count.  C444 keeps the
    write -> read round trip at pure 8-bit quantisation (~45 dB) with no
    chroma subsample."""
    n = 0
    with open(path, "wb") as f:
        for batch in frames:
            batch = np.asarray(batch, np.float32)
            if batch.ndim == 3:
                batch = batch[None]
            if n == 0:
                _, _, h, w = batch.shape
                f.write(
                    f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 "
                    f"C444\n".encode("ascii")
                )
            y8, cb8, cr8 = _rgb_to_ycbcr8(batch)
            for i in range(batch.shape[0]):
                f.write(b"FRAME\n")
                f.write(y8[i].tobytes())
                f.write(cb8[i].tobytes())
                f.write(cr8[i].tobytes())
            n += batch.shape[0]
    return n
