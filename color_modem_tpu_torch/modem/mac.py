"""D2-MAC: the time-multiplexed analog components modem.

Port of ``color_modem_tpu/modem/mac.py``.  Each 64 us line of 1296
samples at 20.25 MHz carries a duobinary data burst, then one
3:1 time-compressed colour-difference component (U on even absolute
lines, V on odd) and the 3:2 time-compressed luminance.  There is no
subcarrier, so no cross-colour.

* Every function works on a whole ``(..., L, N)`` block plus the absolute
  line index ``gline``: no per-line loop, no state.
* Time compression and expansion are the windowed-sinc resampling matrix
  (``dsp/resample.py``, one full-float32 product per segment).
* Duobinary precoding ``p_k = b_0 xor ... xor b_k`` is ``cumsum(bits) mod
  2``.  The burst is shaped by a half-band interpolator whose even-offset
  taps are zero, so symbol centres pass exactly and a clean channel
  decodes with no bit error.
* The missing line-sequential component is the mean of the two vertical
  neighbours, with the reflect rule at the block's top and bottom.
* The packet sound is NICAM-728 bit frames (``frame/nicam.py``) laid
  head-first across the bursts' payload (:func:`pack_sound`).

Checked against the JAX package and the frozen oracle ``golden/mac.py``
(``tests/test_torch_mac.py``).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from color_modem_tpu_torch.dsp.apply import fir_same, toeplitz_same
from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.dsp.resample import resample_width
from color_modem_tpu_torch.frame.nicam import FRAME_BITS, nicam_frames, parse_frames
from color_modem_tpu_torch.frame.pipeline import STAGES, resolve_device
from color_modem_tpu_torch.modem.mac_plan import (  # noqa: F401  (re-exports)
    MacConfig,
    MacPlan,
    halfband_taps,
    make_mac_plan,
)
from color_modem_tpu_torch.separate.stencil import next_reflect, prev_reflect

#: the colour matrices of the kernel backend: one CUDA pass on a CUDA tensor
_colour_matrix = STAGES["kernel"].colour_matrix


@lru_cache(maxsize=16)
def _on_device(plan: MacPlan, device: torch.device):
    """float32 colour matrices, the burst shaper's (spb*K, spb*K) Toeplitz
    matrix and the line sync word on ``device``, uploaded once per (plan,
    device)."""
    cfg = plan.cfg
    n_burst = cfg.samples_per_symbol * cfg.data_symbols
    return (
        torch.tensor(plan.rgb_to_ycc, dtype=torch.float32, device=device),
        torch.tensor(plan.ycc_to_rgb, dtype=torch.float32, device=device),
        torch.tensor(toeplitz_same(plan.halfband, n_burst), device=device),
        torch.tensor(cfg.line_sync_word, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# duobinary data burst
# ---------------------------------------------------------------------------

def duobinary_levels(bits: torch.Tensor) -> torch.Tensor:
    """(..., K) bits in {0, 1} -> (..., K) duobinary levels in {-1, 0, +1}.

    Precoded duobinary: ``p_k`` the prefix parity, ``a_k = 2 p_k - 1``,
    ``d_k = (a_k + a_{k-1}) / 2`` with ``a_{-1} = -1``; bit 1 always maps
    to level 0 and bit 0 to +-1, so a receiver error does not propagate.
    """
    b = bits.to(torch.float32)
    p = torch.remainder(torch.cumsum(b, dim=-1), 2.0)
    a = 2.0 * p - 1.0
    a_prev = torch.cat([torch.full_like(a[..., :1], -1.0), a[..., :-1]], dim=-1)
    return 0.5 * (a + a_prev)


def duobinary_bits(levels: torch.Tensor) -> torch.Tensor:
    """Inverse decision rule: bit = 1 iff the 3-level sample is near 0."""
    return (torch.abs(levels) < 0.5).to(torch.int32)


def _burst_signal(plan: MacPlan, bits: torch.Tensor) -> torch.Tensor:
    """(..., L, K) bits -> (..., L, spb*K) shaped burst around 0.  D2
    (spb=2): zero-stuffed to the grid and half-band shaped; D-MAC (spb=1):
    every grid sample is a symbol, with no filter."""
    cfg = plan.cfg
    d = duobinary_levels(bits)
    if cfg.samples_per_symbol == 1:
        return f32(cfg.data_amplitude) * d
    spb = cfg.samples_per_symbol
    up = d.new_zeros(*d.shape[:-1], spb * cfg.data_symbols)
    up[..., 0::spb] = d
    shaped = fir_same(up, _on_device(plan, d.device)[2])   # even samples kept
    return f32(cfg.data_amplitude) * shaped


def line_bits(plan: MacPlan, payload: torch.Tensor | None, n_lines_shape,
              device: torch.device | str | None = None) -> torch.Tensor:
    """Per-line burst bits: the sync word, then the payload zero-padded to
    capacity.  ``payload``: (..., L, <= capacity) bits or None; returns
    (..., L, data_symbols) int32 on ``device``, which defaults to the
    payload's device, else to ``"cuda"`` (raising without CUDA, as the
    factories do)."""
    cfg = plan.cfg
    cap = cfg.data_symbols - len(cfg.line_sync_word)
    if device is None:
        device = (payload.device if isinstance(payload, torch.Tensor)
                  else resolve_device("cuda"))
    if payload is None:
        payload = torch.zeros(*n_lines_shape, cap, dtype=torch.int32, device=device)
    payload = torch.as_tensor(payload, dtype=torch.int32, device=device)
    if payload.shape[-1] > cap:
        raise ValueError(f"payload {payload.shape[-1]} bits > capacity {cap}")
    if payload.shape[-1] < cap:
        payload = torch.nn.functional.pad(payload, (0, cap - payload.shape[-1]))
    sync = _on_device(plan, torch.device(device))[3]
    return torch.cat([sync.expand(*payload.shape[:-1], len(sync)), payload], dim=-1)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def chroma_is_u(gline: torch.Tensor) -> torch.Tensor:
    """Line-sequential colour: even absolute lines carry U, odd carry V."""
    return torch.remainder(gline, 2) == 0


def encode(plan: MacPlan, rgb: torch.Tensor, gline: torch.Tensor,
           payload_bits: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 3, L, W) RGB in [0, 1] + (..., L) absolute lines -> (..., L,
    1296) MAC lines.

    Levels: luminance 0..1, colour difference ``0.5 + chroma_gain * c``,
    data ``0.5 +- 0.4``, every segment inside [0, 1].
    """
    cfg = plan.cfg
    dev = rgb.device
    ycc = _colour_matrix(_on_device(plan, dev)[0], rgb.to(torch.float32))
    y, u, v = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    c_sel = torch.where(chroma_is_u(gline)[..., None], u, v)

    luma_seg = resample_width(y, cfg.luma_len)
    chroma_seg = f32(cfg.pedestal) + f32(cfg.chroma_gain) * resample_width(
        c_sel, cfg.chroma_len)
    bits = line_bits(plan, payload_bits, gline.shape, dev)
    burst = f32(cfg.pedestal) + _burst_signal(plan, bits)
    burst = burst.expand(*y.shape[:-1], burst.shape[-1])
    n_burst = cfg.samples_per_symbol * cfg.data_symbols

    def gap(n):
        return torch.full((*y.shape[:-1], n), f32(cfg.pedestal), dtype=torch.float32,
                          device=dev)

    return torch.cat([
        burst,                                        # [0, 210)
        gap(cfg.chroma_start - n_burst),              # clamp + guard
        chroma_seg,                                   # [235, 584)
        gap(cfg.luma_start - (cfg.chroma_start + cfg.chroma_len)),
        luma_seg,                                     # [586, 1283)
        gap(cfg.samples_per_line - (cfg.luma_start + cfg.luma_len)),
    ], dim=-1)


def _seg(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    return x[..., start : start + length]


def clamp_correction(plan: MacPlan, sig: torch.Tensor) -> torch.Tensor:
    """Per-line DC error over the clamp period, (..., L, 1)."""
    cfg = plan.cfg
    clamp = _seg(sig, cfg.clamp_start, cfg.clamp_len)
    return torch.mean(clamp, dim=-1, keepdim=True) - f32(cfg.pedestal)


def decode_components(plan: MacPlan, sig: torch.Tensor, gline: torch.Tensor):
    """(..., L, 1296) -> (y, u, v), each (..., L, W), before the RGB matrix.

    The missing line-sequential component is the mean of the two vertical
    neighbours (the receiver's chroma line store), reflected at the edges.
    """
    cfg = plan.cfg
    sig = sig.to(torch.float32) - clamp_correction(plan, sig.to(torch.float32))
    y = resample_width(_seg(sig, cfg.luma_start, cfg.luma_len), plan.width)
    c = resample_width(
        (_seg(sig, cfg.chroma_start, cfg.chroma_len) - f32(cfg.pedestal))
        / f32(cfg.chroma_gain),
        plan.width,
    )
    interp = 0.5 * (prev_reflect(c, 1) + next_reflect(c, 1))
    is_u = chroma_is_u(gline)[..., None]
    return y, torch.where(is_u, c, interp), torch.where(is_u, interp, c)


def decode(plan: MacPlan, sig: torch.Tensor, gline: torch.Tensor) -> torch.Tensor:
    """(..., L, 1296) MAC lines -> (..., 3, L, W) RGB, clamped to [0, 1]."""
    y, u, v = decode_components(plan, sig, gline)
    ycc = torch.stack([y, u, v], dim=-3)
    return _colour_matrix(_on_device(plan, sig.device)[1], ycc, clamp=True)


def decode_data(plan: MacPlan, sig: torch.Tensor):
    """(..., L, 1296) -> (sync_ok (..., L) bool, payload (..., L, cap) bits):
    the burst sampled at symbol centres, levels undone, the duobinary
    decision, and the line sync word checked."""
    cfg = plan.cfg
    sig = sig.to(torch.float32)
    sig = sig - clamp_correction(plan, sig)
    burst = _seg(sig, cfg.data_start, cfg.samples_per_symbol * cfg.data_symbols)
    d = (burst[..., 0 :: cfg.samples_per_symbol] - f32(cfg.pedestal)) / f32(
        cfg.data_amplitude)
    bits = duobinary_bits(d)
    n_sync = len(cfg.line_sync_word)
    sync = _on_device(plan, sig.device)[3]
    sync_ok = torch.all(bits[..., :n_sync] == sync, dim=-1)
    return sync_ok, bits[..., n_sync:]


def roundtrip(plan: MacPlan, rgb: torch.Tensor, gline: torch.Tensor,
              payload_bits: torch.Tensor | None = None) -> torch.Tensor:
    return decode(plan, encode(plan, rgb, gline, payload_bits), gline)


# ---------------------------------------------------------------------------
# MAC packet sound: NICAM-coded audio in the duobinary burst
# ---------------------------------------------------------------------------

def sound_capacity(plan: MacPlan, n_lines: int) -> int:
    """NICAM 728-bit sound frames that fit ``n_lines`` lines of burst
    payload (625 lines x 99 bits at 25 fps is ~1.55 Mb/s, two NICAM
    stereo services' worth)."""
    cap = plan.cfg.data_symbols - len(plan.cfg.line_sync_word)
    return (n_lines * cap) // FRAME_BITS


def pack_sound(plan: MacPlan, left, right, n_lines: int):
    """Stereo audio -> ``(payload (n_lines, cap), n_audio_frames)``.

    ``left``/``right``: float in [-1, 1], length a multiple of 32 with
    ``length // 32 <= sound_capacity``.  The NICAM frames' bits are laid
    head-first across the payload rows; the unused tail is zero."""
    frames = nicam_frames(left, right)               # (F, 728)
    n_f = frames.shape[0]
    cap = plan.cfg.data_symbols - len(plan.cfg.line_sync_word)
    if n_f > sound_capacity(plan, n_lines):
        raise ValueError(
            f"{n_f} NICAM frames need {n_f * FRAME_BITS} bits; {n_lines} lines "
            f"carry {n_lines * cap}")
    flat = frames.reshape(-1)
    payload = torch.nn.functional.pad(flat, (0, n_lines * cap - flat.shape[0]))
    return payload.reshape(n_lines, cap), n_f


def unpack_sound(plan: MacPlan, payload: torch.Tensor, n_audio_frames: int):
    """Inverse of :func:`pack_sound`: payload rows -> ``(left, right,
    report)`` (``frame/nicam.py::parse_frames``)."""
    flat = payload.reshape(-1)[: n_audio_frames * FRAME_BITS]
    return parse_frames(flat.reshape(n_audio_frames, FRAME_BITS))
