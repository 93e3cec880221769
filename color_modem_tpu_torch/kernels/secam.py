"""Fused SECAM FM encode/decode: wrappers of the CUDA kernels in ``csrc/``
and their plain PyTorch versions.

Both kernels run their FIRs on the tensor cores (``csrc/band_fir.cuh``'s
``fir16``: 8 lines x 16 outputs per ``mma.sync``, three TF32 passes) against
the plan's 16x8 band tiles (``FmPlan.<filter>_tiles``).  Where a line's
planes fit one block (720 and 722 samples) each runs as a warp-specialised
pipeline (bulk asynchronous stores, mbarrier handoffs,
``csrc/async_pipe.cuh``); wider lines take the serial kernels (one block
holds the line, all warps on each stage in turn), the decoder cutting lines
its planes cannot hold into spans that each recompute the chain's halo (14
at 2160 samples).  The choice is the launch function's, from the line
width: the arguments are the same.  Lines wider than 2279 samples
(decode) or 2514 (encode) fit no kernel and raise.  On an NVIDIA H100 80GB
HBM3 at 700.00 W (``scripts/torch_kernel_ab.py``, PERF.md section 6):
encode / decode 0.18 / 0.40 ms at 16x576x720, 0.62 / 1.38 ms at
16x576x1440, 0.15 / 1.25 ms at 1x576x2160.

* ``encode_lines`` (``csrc/secam_encode.cu``) replaces
  ``color_modem_tpu/kernels/secam.py::encode``'s kernel: D'R/D'B select,
  held-edge component LPF and pre-emphasis, FM phase scan (midpoint rule),
  carrier, anti-cloche, luma add.
* ``demodulate_lines`` (``csrc/secam_decode.cu``) replaces
  ``demodulate_lines``' kernel and the blanking extension before it: bell
  takeoff and luma notch, quadrature mix, mix LPF and differentiator,
  discriminator, rest-frequency removal, de-emphasis and demod LPF.

Each wrapper checks device, dtype, shape and contiguity.  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises; anything
else raises.  A launch goes through ``kernels/build.py::launch_counted``,
which counts it and hands its outputs to ``utils/debug.py::note_kernel``.
The C arguments of a launch come from :func:`encode_call` /
:func:`demodulate_call`, which ``kernels/sanitize.py`` launches from too.
The per-line parity comes in as a float32 column, 1.0 on D'R lines.  The
cross-line pairing (copy or interp) stays outside the kernel, as in the JAX
package: it is the seam a line-block split would cut.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.apply import fir_same, fir_same_held
from color_modem_tpu_torch.dsp.nco import TWO_PI, f32
from color_modem_tpu_torch.kernels.build import launch_counted
from color_modem_tpu_torch.modem import secam
from color_modem_tpu_torch.modem.plan import FmPlan


def isr_col(gline: torch.Tensor) -> torch.Tensor:
    """(..., L) line indices -> (G*L,) float32, 1.0 on D'R lines."""
    return secam.is_r_line(gline).to(torch.float32).reshape(-1)


def _encode_consts(plan: FmPlan) -> tuple[float, float, float, float]:
    """(f0r_c, f0b_c, devr_c, devb_c): rest frequency about f_center and
    deviation, in rad/sample, float32-rounded."""
    p, k = plan.chroma, TWO_PI / plan.fs
    return (f32((p.f0r - plan.f_center) * k), f32((p.f0b - plan.f_center) * k),
            f32(p.dev_r * k), f32(p.dev_b * k))


def _decode_consts(plan: FmPlan) -> tuple[float, ...]:
    """(fc, fs/2pi, f0r, f0b, devr, devb), float32-rounded."""
    p = plan.chroma
    return tuple(f32(v) for v in (plan.f_center, plan.fs / TWO_PI, p.f0r, p.f0b,
                                  p.dev_r, p.dev_b))


def _select(isr: torch.Tensor, r: float, b: float) -> torch.Tensor:
    """Per-line (G, L, 1) value: ``r`` on D'R lines, ``b`` on D'B lines."""
    return torch.where(isr != 0.0, r, b).to(torch.float32)


def _check(plan: FmPlan, isr: torch.Tensor, n_lines: int,
           **arrays: torch.Tensor) -> torch.device:
    """Validate the line arrays and the parity column; return their device."""
    dev = isr.device
    for name, t in {"isr": isr, **arrays}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, isr on {dev}")
        if name != "isr" and t.shape[-1] != plan.n_samples:
            raise ValueError(
                f"{name}: {t.shape[-1]} samples per line, plan has {plan.n_samples}"
            )
    if tuple(isr.shape) != (n_lines,):
        raise ValueError(f"isr: expected ({n_lines},), got {tuple(isr.shape)}")
    if plan.mix_cos.device != dev:
        raise ValueError(f"plan is on {plan.mix_cos.device}, data on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no SECAM kernel or plain version for device {dev}")
    return dev


# --- encode -----------------------------------------------------------------


def encode_lines_plain(plan: FmPlan, ycc: torch.Tensor,
                       isr: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`encode_lines`: held Toeplitz matmuls,
    ``torch.cumsum``, zero-edged anti-cloche."""
    g, _, l, _ = ycc.shape
    isr = isr.reshape(g, l, 1)
    f0r_c, f0b_c, devr_c, devb_c = _encode_consts(plan)
    d = torch.where(isr != 0.0, ycc[:, 1], ycc[:, 2])
    dpre = fir_same_held(fir_same_held(d, plan.comp_lpf_held), plan.preemph_held)
    df = _select(isr, f0r_c, f0b_c) + _select(isr, devr_c, devb_c) * dpre
    dphi = torch.cumsum(df, dim=-1) - 0.5 * df
    carrier = torch.cos(plan.fm_carrier_ramp + dphi)
    return ycc[:, 0] + fir_same(carrier, plan.anticloche_mat)


def encode_call(plan: FmPlan, ycc: torch.Tensor, isr: torch.Tensor,
                out: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``secam_encode`` but its stream: the tensors
    passed by pointer, in order, and then the scalars."""
    g, _, l, n = ycc.shape
    return ([ycc, isr, plan.fm_carrier_ramp, plan.comp_lpf_tiles, plan.preemph_tiles,
             plan.anticloche_tiles, out],
            (g * l, l, n, plan.comp_lpf.numel(), plan.preemph.numel(),
             plan.anticloche.numel(), *_encode_consts(plan)))


def encode_lines(plan: FmPlan, ycc: torch.Tensor, isr: torch.Tensor) -> torch.Tensor:
    """(G, 3, L, N) (Y, D'R, D'B) + (G*L,) parity -> (G, L, N) composite."""
    if ycc.dim() != 4 or ycc.shape[1] != 3:
        raise ValueError(f"ycc: expected (G, 3, L, N), got {tuple(ycc.shape)}")
    g, _, l, n = ycc.shape
    dev = _check(plan, isr, g * l, ycc=ycc)
    if dev.type == "cpu":
        return encode_lines_plain(plan, ycc, isr)
    out = torch.empty((g, l, n), dtype=torch.float32, device=dev)
    launch_counted("secam_encode", dev, encode_call(plan, ycc, isr, out), out)
    return out


# --- decode -----------------------------------------------------------------


def demodulate_lines_plain(plan: FmPlan, comp: torch.Tensor, isr: torch.Tensor):
    """Plain version of :func:`demodulate_lines`: ``extend_blanking``, then
    the zero-edged Toeplitz chain at N + 2M with the host-built mix rows."""
    g, l, n = comp.shape
    m = plan.fm_margin
    isr = isr.reshape(g, l, 1)
    fc, inv2pi, f0r, f0b, devr, devb = _decode_consts(plan)
    ext = secam.extend_blanking_parity(plan, comp, isr[..., 0] != 0.0)
    takeoff = fir_same(ext, plan.bell_takeoff_mat)
    luma = ext - fir_same(ext, plan.luma_notch_mat)
    i = fir_same(2.0 * takeoff * plan.mix_cos, plan.mix_lpf_mat)
    q = fir_same(-2.0 * takeoff * plan.mix_sin, plan.mix_lpf_mat)
    di, dq = fir_same(i, plan.diff_mat), fir_same(q, plan.diff_mat)
    a2 = torch.clamp_min(i * i + q * q, 1e-9)
    f = fc + (i * dq - q * di) / a2 * inv2pi
    v = (f - _select(isr, f0r, f0b)) / _select(isr, devr, devb)
    v = fir_same(fir_same(v, plan.deemph_mat), plan.demod_lpf_mat)
    return luma[..., m : m + n], v[..., m : m + n]


def demodulate_call(plan: FmPlan, comp: torch.Tensor, isr: torch.Tensor,
                    luma: torch.Tensor, v: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``secam_decode`` but its stream
    (:func:`encode_call`)."""
    if plan.bell_takeoff.numel() != plan.luma_notch.numel():
        raise ValueError("secam_decode takes one tap count for bell_takeoff and luma_notch")
    g, l, n = comp.shape
    return ([comp, isr, plan.fm_margin_carrier, plan.mix_cos, plan.mix_sin,
             plan.bell_takeoff_tiles, plan.luma_notch_tiles, plan.mix_lpf_tiles,
             plan.diff_tiles, plan.deemph_tiles, plan.demod_lpf_tiles, luma, v],
            (g * l, n, plan.fm_margin, plan.fm_luma_est,
             *(t.numel() for t in (plan.bell_takeoff, plan.mix_lpf, plan.diff,
                                   plan.deemph, plan.demod_lpf)),
             *_decode_consts(plan)))


def demodulate_lines(plan: FmPlan, comp: torch.Tensor, isr: torch.Tensor):
    """(G, L, N) composite + (G*L,) parity -> (luma, v), each (G, L, N)."""
    if comp.dim() != 3:
        raise ValueError(f"comp: expected (G, L, N), got {tuple(comp.shape)}")
    g, l, n = comp.shape
    dev = _check(plan, isr, g * l, comp=comp)
    if dev.type == "cpu":
        return demodulate_lines_plain(plan, comp, isr)
    luma = torch.empty((g, l, n), dtype=torch.float32, device=dev)
    v = torch.empty((g, l, n), dtype=torch.float32, device=dev)
    launch_counted("secam_decode", dev, demodulate_call(plan, comp, isr, luma, v),
                   luma, v)
    return luma, v


# --- block-level wrappers mirroring modem/secam.py signatures ---------------


def encode(plan: FmPlan, ycc: torch.Tensor, gline: torch.Tensor) -> torch.Tensor:
    """Kernel twin of ``modem.secam.encode``: (..., 3, L, N) -> (..., L, N)."""
    lead, (l, n) = ycc.shape[:-3], ycc.shape[-2:]
    out = encode_lines(plan, ycc.reshape(-1, 3, l, n).contiguous(), isr_col(gline))
    return out.reshape(*lead, l, n)


def demodulate(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor):
    """Kernel twin of ``modem.secam.demodulate_lines``: (..., L, N) ->
    (luma, v)."""
    lead, (l, n) = comp.shape[:-2], comp.shape[-2:]
    luma, v = demodulate_lines(plan, comp.reshape(-1, l, n).contiguous(),
                               isr_col(gline))
    return luma.reshape(*lead, l, n), v.reshape(*lead, l, n)


def decode(plan: FmPlan, comp: torch.Tensor, gline: torch.Tensor,
           pairing: str = "copy") -> torch.Tensor:
    """Kernel twin of ``modem.secam.decode``: the kernel, then the pairing:
    (..., L, N) -> (..., 3, L, N) (Y, D'R, D'B)."""
    luma, v = demodulate(plan, comp, gline)
    dr, db = secam.pair(v, gline, pairing)
    return torch.stack([luma, dr, db], dim=-3)
