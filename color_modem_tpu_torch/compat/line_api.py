"""Reference-compatible per-line modem API.

Port of ``color_modem_tpu/compat/line_api.py``.  The reference's central
protocol:

    modem.modulate(frame, line, r, g, b)      # 3x(N,) scanline -> (N,) composite
    modem.demodulate(frame, line, composite)  # (N,) composite -> 3x(N,)

``NtscModem``, ``PalModem``, ``SecamModem``, ``NiirModem`` and the
wrappers ``SimpleCombModem``, ``Simple3DCombModem``, ``ColorAveragingModem``
and ``DelayLinePalModem`` keep that protocol as thin stateful shims over
the block functions, so line-level code written for the reference runs
unchanged.  Lines go in and come out as NumPy arrays; the work runs on
``device`` (the card unless the caller asks for the CPU).

``modulate`` runs :func:`~color_modem_tpu_torch.frame.pipeline.encode_block`
with the ``kernel`` backend on a (1, 3, 1, N) block: on the card it
launches the QAM or SECAM encode kernel on one line.  ``demodulate`` runs
the plain modem functions (the notch separation and product detector, the
SECAM line demodulator), as the JAX package's does.

Cross-line state is streaming and causal: the first line of a stream pairs
with itself, where the batch pipeline reflects to line 1, so the first
demodulated line can differ from ``frame/pipeline.py``; every later line
matches it (``tests/test_torch_compat.py``).  ``Simple3DCombModem`` needs
the next line, so it runs one line late (``latency = 1``).  The batch
pipeline has none of these seams; this layer is for API parity, not
throughput.
"""

from __future__ import annotations

import numpy as np
import torch

from color_modem_tpu_torch.frame.pipeline import encode_block, resolve_device
from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
from color_modem_tpu_torch.modem import qam
from color_modem_tpu_torch.modem import secam as secam_mod
from color_modem_tpu_torch.modem.plan import make_plan, plan_on
from color_modem_tpu_torch.standards import NIIR, NTSC, PAL, SECAM
from color_modem_tpu_torch.utils.upload import upload


def _g(plan, frame: int, line: int) -> int:
    return frame * plan.total_lines + line


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _LineModemBase:
    """Shared protocol plumbing: single-line blocks and colorimetry on the
    modem's device."""

    latency = 0

    def __init__(self, plan, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.plan = plan_on(plan, self.device)

    def _line(self, x) -> torch.Tensor:
        """(N,) host samples -> (1, 1, N) float32 on the device."""
        return upload(np.asarray(x, np.float32), self.device).reshape(1, 1, -1)

    def _gline(self, frame: int, line: int) -> torch.Tensor:
        return torch.full((1, 1), _g(self.plan, frame, line), dtype=torch.int32,
                          device=self.device)

    # -- encode: line-local for every standard ------------------------------
    @torch.inference_mode()
    def modulate(self, frame: int, line: int, r, g, b) -> np.ndarray:
        """3x(N,) scanline -> (N,) composite (reference protocol)."""
        rgb = upload(np.stack([np.asarray(r), np.asarray(g), np.asarray(b)]).astype(np.float32),
                     self.device)[None, :, None, :]          # (1, 3, 1, N)
        return _host(encode_block(self.plan, rgb, self._gline(frame, line), "kernel"))[0, 0]

    def demodulate(self, frame: int, line: int, composite) -> tuple:
        y, c1, c2 = self.demodulate_components(frame, line, composite)
        return _components_to_rgb(self, y, c1, c2)

    @torch.inference_mode()
    def to_rgb(self, y, c1, c2) -> np.ndarray:
        """(N,) components -> (3, N) RGB, clamped."""
        ycc = upload(np.stack([np.asarray(y), np.asarray(c1), np.asarray(c2)]).astype(
            np.float32), self.device)[None, :, None, :]
        return _host(colour_matrix(self.plan.ycc_to_rgb, ycc, clamp=True))[0, :, 0]

    def reset(self) -> None:
        """Drop cross-line streaming state (start of a new image or field)."""


class QamLineModem(_LineModemBase):
    """NTSC/PAL/NIIR per-line modem with the notch separation."""

    def __init__(self, plan, device: torch.device | str = "cuda"):
        super().__init__(plan, device)
        self._is_niir = plan.cfg.chroma.reference_amplitude is not None
        self._prev_z = None  # NIIR: the previous line's (c1, c2) measurement

    def reset(self) -> None:
        self._prev_z = None

    # hooks reused by the comb and averaging wrappers
    @torch.inference_mode()
    def separate(self, composite):
        luma, cb = qam.separate_notch(self.plan, self._line(composite))
        return _host(luma)[0, 0], _host(cb)[0, 0]

    @torch.inference_mode()
    def demodulate_carrier(self, frame: int, line: int, chroma_band):
        c1, c2 = qam.demodulate_carrier(self.plan, self._line(chroma_band),
                                        self._gline(frame, line))
        return _host(c1)[0, 0], _host(c2)[0, 0]

    def demodulate_components(self, frame: int, line: int, composite):
        luma, cb = self.separate(composite)
        c1, c2 = self.demodulate_carrier(frame, line, cb)
        if self._is_niir:
            c1, c2 = self._niir_step(frame, line, c1, c2)
        return luma, c1, c2

    def _niir_step(self, frame: int, line: int, c1, c2):
        """Streaming reference-line normalisation: pair with the previous
        line's measurement (first line: no correction)."""
        a_ref = self.plan.cfg.chroma.reference_amplitude
        z, prev = (c1, c2), self._prev_z
        self._prev_z = z
        if prev is None:
            return (c1, c2) if _g(self.plan, frame, line) % 2 == 0 else (
                np.zeros_like(c1), np.zeros_like(c2))
        if _g(self.plan, frame, line) % 2 == 0:
            zc, zr = z, prev
        else:
            zc, zr = prev, z
        # a vanishing reference measurement falls back to the nominal
        # (A_ref, 0), i.e. no correction, as modem/niir.py::normalize does
        zr0, zr1 = zr
        weak = (zr0 ** 2 + zr1 ** 2) < 1e-12
        zr0 = np.where(weak, a_ref, zr0)
        zr1 = np.where(weak, 0.0, zr1)
        den = zr0 ** 2 + zr1 ** 2
        u = a_ref * (zc[0] * zr0 + zc[1] * zr1) / den
        v = a_ref * (zc[1] * zr0 - zc[0] * zr1) / den
        return u, v


def make_line_modem(standard: str, samples: int = 720, device: torch.device | str = "cuda"):
    """Per-line modem for any registered standard, variants included
    (ntsc443, pal_m, pal_n, pal60 share the QAM machinery and differ only
    in config); SECAM goes to its FM modem."""
    from color_modem_tpu_torch.standards import ALL_STANDARDS

    cfg = ALL_STANDARDS[standard]()
    if cfg.is_fm:  # secam is the only FM standard
        return SecamModem(samples, device=device)
    return QamLineModem(make_plan(cfg, samples), device)


class NtscModem(QamLineModem):
    """NTSC parameterisation of the QAM core."""

    def __init__(self, samples: int = 720, device: torch.device | str = "cuda", **cfg_kw):
        super().__init__(make_plan(NTSC(**cfg_kw), samples), device)


class PalModem(QamLineModem):
    """PAL-S (simple) decoder; wrap in DelayLinePalModem for PAL-D."""

    def __init__(self, samples: int = 720, device: torch.device | str = "cuda"):
        super().__init__(make_plan(PAL(), samples), device)


class NiirModem(QamLineModem):
    """NIIR / SECAM IV."""

    def __init__(self, samples: int = 720, device: torch.device | str = "cuda", **cfg_kw):
        super().__init__(make_plan(NIIR(**cfg_kw), samples), device)


class SecamModem(_LineModemBase):
    """SECAM FM line modem with 1-line component pairing."""

    def __init__(self, samples: int = 720, device: torch.device | str = "cuda"):
        super().__init__(make_plan(SECAM(), samples), device)
        self._prev_v = None

    def reset(self) -> None:
        self._prev_v = None

    @torch.inference_mode()
    def demodulate_components(self, frame: int, line: int, composite):
        luma, v = secam_mod.demodulate_lines(self.plan, self._line(composite),
                                             self._gline(frame, line))
        luma, v = _host(luma)[0, 0], _host(v)[0, 0]
        other = v if self._prev_v is None else self._prev_v
        self._prev_v = v
        if _g(self.plan, frame, line) % 2 == 1:  # D'R line
            return luma, v, other
        return luma, other, v


class SimpleCombModem:
    """2-line comb wrapper: chroma from the difference with the previous
    composite line, luma from the sum."""

    latency = 0

    def __init__(self, base: QamLineModem):
        self.base = base
        self.plan = base.plan
        self._prev = None

    def reset(self):
        self._prev = None
        self.base.reset()

    def modulate(self, frame, line, r, g, b):
        return self.base.modulate(frame, line, r, g, b)

    def demodulate(self, frame, line, composite):
        comp = np.asarray(composite, dtype=np.float32)
        prev = comp if self._prev is None else self._prev
        self._prev = comp
        _, cb = self.base.separate((comp - prev) / 2.0)
        luma = comp - cb
        c1, c2 = self.base.demodulate_carrier(frame, line, cb)
        return _components_to_rgb(self.base, luma, c1, c2)


class Simple3DCombModem:
    """3-line comb wrapper: needs the next line, so the stream runs one
    line late (``latency = 1``; output n is for input n-1).  Feed one extra
    (replicated) line at the end of the image to drain."""

    latency = 1

    def __init__(self, base: QamLineModem):
        self.base = base
        self.plan = base.plan
        self._buf = []  # [(frame, line, comp), ...], at most 3

    def reset(self):
        self._buf = []
        self.base.reset()

    def modulate(self, frame, line, r, g, b):
        return self.base.modulate(frame, line, r, g, b)

    def demodulate(self, frame, line, composite):
        comp = np.asarray(composite, dtype=np.float32)
        self._buf.append((frame, line, comp))
        if len(self._buf) == 1:  # prime: the first output reflects
            self._buf.insert(0, (frame, line, comp))
        if len(self._buf) > 3:
            self._buf.pop(0)
        (_, _, prev), (fc, lc, cur) = self._buf[0], self._buf[1]
        nxt = self._buf[2][2] if len(self._buf) > 2 else cur
        _, cb = self.base.separate((2.0 * cur - prev - nxt) / 4.0)
        luma = cur - cb
        c1, c2 = self.base.demodulate_carrier(fc, lc, cb)
        return _components_to_rgb(self.base, luma, c1, c2)


class ColorAveragingModem:
    """Chroma-averaging wrapper: averages the demodulated chroma with the
    previous line's.  Around PalModem it is the PAL delay-line decoder;
    around any base modem it halves the vertical chroma resolution: QAM,
    SECAM (the assembled D'R/D'B pair) and NIIR (the normalised chroma),
    as the batch pipeline's 'avg' decoder does."""

    latency = 0

    def __init__(self, base):
        self.base = base
        self.plan = base.plan
        self._prev = None

    def reset(self):
        self._prev = None
        self.base.reset()

    def modulate(self, frame, line, r, g, b):
        return self.base.modulate(frame, line, r, g, b)

    def demodulate(self, frame, line, composite):
        y, c1, c2 = self.base.demodulate_components(frame, line, composite)
        prev = (c1, c2) if self._prev is None else self._prev
        self._prev = (c1, c2)
        return _components_to_rgb(self.base, y, 0.5 * (c1 + prev[0]), 0.5 * (c2 + prev[1]))


def DelayLinePalModem(samples: int = 720,
                      device: torch.device | str = "cuda") -> ColorAveragingModem:
    """PAL-D: the delay-line decoder."""
    return ColorAveragingModem(PalModem(samples, device))


def _components_to_rgb(base: _LineModemBase, y, c1, c2):
    rgb = base.to_rgb(y, c1, c2)
    return rgb[0], rgb[1], rgb[2]


class ImageModem:
    """Reference-style image layer over any line modem: loops scanlines
    through the per-line protocol.  For throughput use
    ``frame/pipeline.py``."""

    def __init__(self, modem):
        self.modem = modem

    def modulate_image(self, rgb: np.ndarray, frame: int = 0) -> np.ndarray:
        rgb = np.asarray(rgb, dtype=np.float32)
        _, n_lines, _ = rgb.shape
        self.modem.reset()
        return np.stack([self.modem.modulate(frame, l, rgb[0, l], rgb[1, l], rgb[2, l])
                         for l in range(n_lines)])

    def demodulate_image(self, comp: np.ndarray, frame: int = 0) -> np.ndarray:
        comp = np.asarray(comp, dtype=np.float32)
        n_lines = comp.shape[0]
        self.modem.reset()
        lat = getattr(self.modem, "latency", 0)
        out = [self.modem.demodulate(frame, l, comp[l]) for l in range(n_lines)]
        for _ in range(lat):  # drain by replicating the last line
            out.append(self.modem.demodulate(frame, n_lines - 1, comp[-1]))
        rgb = np.stack([np.stack(ch) for ch in zip(*out[lat:])])
        return np.clip(rgb, 0.0, 1.0)
