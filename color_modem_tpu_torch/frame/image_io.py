"""Image file I/O: Pillow or the native codec <-> channels-first floats.

Port of ``color_modem_tpu/frame/image_io.py``.  Arrays are ``(3, L, N)``
float32 in [0, 1] (gamma-corrected R'G'B' as stored in the file: the
modems work on gamma-corrected signals), host NumPy arrays on both sides.

``.ppm`` paths go through the native C++ codec
(``color_modem_tpu_torch/native``); every other format goes through
Pillow, imported when the module is, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from color_modem_tpu_torch import native

try:
    from PIL import Image

    HAVE_PIL = True
except ImportError:  # pragma: no cover - a host without Pillow
    HAVE_PIL = False


def _require_pil():
    if not HAVE_PIL:
        raise RuntimeError("Pillow is required for image file I/O")


def load_rgb(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Load an image file -> (3, L, N) float32 in [0, 1].

    ``size`` is (samples, lines), i.e. (width, height); when given, the
    image is resampled (Lanczos) to it.
    """
    if path.endswith(".ppm") and size is None:
        return native.rgb8_to_chw_f32(native.read_ppm(path)[None])[0]
    _require_pil()
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.LANCZOS)
    arr = np.asarray(img, dtype=np.float32) / 255.0  # (L, N, 3)
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def save_rgb(path: str, rgb: np.ndarray) -> None:
    """(3, L, N) float in [0,1] -> image file."""
    rgb = np.asarray(rgb, dtype=np.float32)
    if path.endswith(".ppm"):
        native.write_ppm(path, native.chw_f32_to_rgb8(rgb[None])[0])
        return
    _require_pil()
    arr = np.clip(rgb, 0.0, 1.0)
    arr = (arr.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_gif(path: str, frames: list, duration_ms: int = 125) -> None:
    """[(3, L, N) float in [0,1], ...] -> looping animated GIF (the
    gallery's dot-crawl animation: the chroma phase sequence shows only in
    motion)."""
    _require_pil()
    imgs = []
    for rgb in frames:
        arr = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
        arr = (arr.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
        imgs.append(Image.fromarray(arr))
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=duration_ms, loop=0)


def save_composite(path: str, comp: np.ndarray, lo: float = -0.4, hi: float = 1.4) -> None:
    """(L, N) composite signal -> grayscale visualisation.

    The composite swings below 0 and above 1 (chroma excursions); the
    default window keeps them visible instead of clipping.
    """
    _require_pil()
    arr = (np.clip((np.asarray(comp) - lo) / (hi - lo), 0.0, 1.0) * 255.0 + 0.5)
    Image.fromarray(arr.astype(np.uint8), mode="L").save(path)
