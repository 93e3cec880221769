"""Fused QAM encode/decode: wrappers of the CUDA kernels in ``csrc/`` and
their plain PyTorch versions.

Both kernels run their FIRs on the tensor cores as banded products of 8x8
Toeplitz tiles in three TF32 passes (``csrc/band_fir.cuh``); the tiles are
the plan's ``*_tiles`` buffers, built once on the host.

* ``encode_lines`` (``csrc/qam_encode.cu``) replaces
  ``color_modem_tpu/kernels/qam.py::_encode_kernel`` and ``_encode_kernel_shared``:
  I/Q (U/V) low-pass, angle-addition carrier, V-switch, NIIR reference
  line, luma add.
* ``decode_lines`` (``csrc/qam_decode.cu``) replaces ``_decode_kernel`` and
  ``_decode_kernel_shared``: chroma band-pass, luma = composite - band,
  product detector, two low-passes.

Each wrapper checks device, dtype, shape and contiguity.  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises; anything
else raises.  A launch goes through ``kernels/build.py::launch_counted``,
which counts it and hands its output to ``utils/debug.py::note_kernel``.
The C arguments of a launch come from :func:`encode_call` /
:func:`decode_call`, which ``kernels/sanitize.py`` launches from too.

Line layout: the kernels take ``G`` groups of ``L`` lines, so that the
``(B, 3, L, N)`` component planes are read (encode) and written (decode)
in place, with no interleaving copy.  The cross-line comb stencil stays
outside the kernel, as in the JAX package.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.apply import fir_same
from color_modem_tpu_torch.dsp.nco import f32, line_phase0
from color_modem_tpu_torch.kernels.build import launch_counted
from color_modem_tpu_torch.modem.plan import QamPlan
from color_modem_tpu_torch.modem.qam import reference_line_mask, v_sign


def phase_cols(plan: QamPlan, gline: torch.Tensor) -> torch.Tensor:
    """(..., L) line indices -> (G*L, 3) float32 ``[phi0 + theta, vsign,
    refmask]`` per line, ``theta`` added in float32."""
    phi0 = line_phase0(plan.cpl_num, plan.cpl_den, gline) + f32(plan.theta)
    vs = v_sign(plan, gline)
    ref = reference_line_mask(plan, gline)
    ref = torch.zeros_like(vs) if ref is None else ref.to(torch.float32)
    return torch.stack([phi0, vs, ref], dim=-1).reshape(-1, 3)


def _carrier(phase: torch.Tensor, plan: QamPlan):
    """sin/cos of (per-line phase + ramp) by angle addition, against the
    float64-built ramp rows — what the kernels compute."""
    s0, c0 = torch.sin(phase), torch.cos(phase)
    rc, rs = plan.ramp_cos, plan.ramp_sin
    return s0 * rc + c0 * rs, c0 * rc - s0 * rs


def _ref_amplitude(plan: QamPlan) -> float:
    return f32(plan.chroma.reference_amplitude or 0.0)


def _check(plan: QamPlan, cols: torch.Tensor, n_lines: int,
           **arrays: torch.Tensor) -> torch.device:
    """Validate the line arrays and cols; return their common device."""
    dev = cols.device
    for name, t in {"cols": cols, **arrays}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cols on {dev}")
        if name != "cols" and t.shape[-1] != plan.n_samples:
            raise ValueError(
                f"{name}: {t.shape[-1]} samples per line, plan has {plan.n_samples}"
            )
    if tuple(cols.shape) != (n_lines, 3):
        raise ValueError(f"cols: expected ({n_lines}, 3), got {tuple(cols.shape)}")
    if plan.ramp_cos.device != dev:
        raise ValueError(f"plan is on {plan.ramp_cos.device}, data on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no QAM kernel or plain version for device {dev}")
    return dev


# --- encode -----------------------------------------------------------------


def encode_lines_plain(plan: QamPlan, ycc: torch.Tensor,
                       cols: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`encode_lines`."""
    g, _, l, n = ycc.shape
    phase, vs, ref = (cols[:, k].reshape(g, l, 1) for k in range(3))
    sin, cos = _carrier(phase, plan)
    c1f = fir_same(ycc[:, 1], plan.c1_lpf_mat)
    c2f = fir_same(ycc[:, 2], plan.c2_lpf_mat)
    chroma = c1f * sin + vs * c2f * cos
    chroma = ref * (_ref_amplitude(plan) * sin) + (1.0 - ref) * chroma
    return ycc[:, 0] + chroma


def encode_call(plan: QamPlan, ycc: torch.Tensor, cols: torch.Tensor,
                out: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``qam_encode`` but its stream: the tensors passed
    by pointer, in order, and then the scalars."""
    g, _, l, n = ycc.shape
    return ([ycc, cols, plan.ramp_cos, plan.ramp_sin, plan.c1_lpf_tiles, plan.c2_lpf_tiles,
             out], (g * l, l, n, plan.c1_lpf.numel(), _ref_amplitude(plan)))


def encode_lines(plan: QamPlan, ycc: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(G, 3, L, N) components + (G*L, 3) cols -> (G, L, N) composite."""
    if ycc.dim() != 4 or ycc.shape[1] != 3:
        raise ValueError(f"ycc: expected (G, 3, L, N), got {tuple(ycc.shape)}")
    g, _, l, n = ycc.shape
    dev = _check(plan, cols, g * l, ycc=ycc)
    if dev.type == "cpu":
        return encode_lines_plain(plan, ycc, cols)
    out = torch.empty((g, l, n), dtype=torch.float32, device=dev)
    launch_counted("qam_encode", dev, encode_call(plan, ycc, cols, out), out)
    return out


# --- decode -----------------------------------------------------------------


def decode_lines_plain(plan: QamPlan, sep: torch.Tensor, comp: torch.Tensor,
                       cols: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decode_lines`."""
    g, l, n = comp.shape
    phase, vs = (cols[:, k].reshape(g, l, 1) for k in range(2))
    sin, cos = _carrier(phase, plan)
    cb = fir_same(sep, plan.chroma_bpf_mat)
    c1 = fir_same(2.0 * cb * sin, plan.c1_lpf_mat)
    c2 = vs * fir_same(2.0 * cb * cos, plan.c2_lpf_mat)
    return torch.stack([comp - cb, c1, c2], dim=1)


def decode_call(plan: QamPlan, sep: torch.Tensor, comp: torch.Tensor, cols: torch.Tensor,
                out: torch.Tensor) -> tuple[list, tuple]:
    """The C arguments of ``qam_decode`` but its stream (:func:`encode_call`)."""
    if not plan.c1_lpf.numel() == plan.c2_lpf.numel() == plan.chroma_bpf.numel():
        raise ValueError("qam_decode takes one tap count for all three filters")
    g, l, n = comp.shape
    return ([sep, comp, cols, plan.ramp_cos, plan.ramp_sin, plan.chroma_bpf_tiles,
             plan.c1_lpf_tiles, plan.c2_lpf_tiles, out], (g * l, l, n, plan.c1_lpf.numel()))


def decode_lines(plan: QamPlan, sep: torch.Tensor, comp: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """(G, L, N) separated signal + raw composite, (G*L, 3) cols ->
    (G, 3, L, N) ``[y, c1, c2]``."""
    if comp.dim() != 3 or sep.shape != comp.shape:
        raise ValueError(
            f"sep, comp: expected two (G, L, N), got {tuple(sep.shape)}, "
            f"{tuple(comp.shape)}"
        )
    g, l, n = comp.shape
    dev = _check(plan, cols, g * l, sep=sep, comp=comp)
    if dev.type == "cpu":
        return decode_lines_plain(plan, sep, comp, cols)
    out = torch.empty((g, 3, l, n), dtype=torch.float32, device=dev)
    launch_counted("qam_decode", dev, decode_call(plan, sep, comp, cols, out), out)
    return out


# --- block-level wrappers mirroring modem/qam.py signatures ----------------


def encode(plan: QamPlan, ycc: torch.Tensor, gline: torch.Tensor) -> torch.Tensor:
    """Kernel twin of ``modem.qam.encode``: (..., 3, L, N) -> (..., L, N)."""
    lead, (l, n) = ycc.shape[:-3], ycc.shape[-2:]
    cols = phase_cols(plan, gline)
    out = encode_lines(plan, ycc.reshape(-1, 3, l, n).contiguous(), cols)
    return out.reshape(*lead, l, n)


def demodulate_separated(plan: QamPlan, sep: torch.Tensor, comp: torch.Tensor,
                         gline: torch.Tensor) -> torch.Tensor:
    """Kernel twin of separate + ``demodulate_carrier`` on a block:
    (..., L, N) stencil signal and composite -> (..., 3, L, N) ``[y, c1, c2]``
    (stacked, where the JAX twin returns a tuple: the colour matrix reads
    the planes next)."""
    lead, (l, n) = comp.shape[:-2], comp.shape[-2:]
    cols = phase_cols(plan, gline)
    out = decode_lines(
        plan,
        sep.reshape(-1, l, n).contiguous(),
        comp.reshape(-1, l, n).contiguous(),
        cols,
    )
    return out.reshape(*lead, 3, l, n)
