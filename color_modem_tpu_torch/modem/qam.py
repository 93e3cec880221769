"""QAM chroma modem as plain PyTorch on ``(..., L, N)`` blocks.

Port of ``color_modem_tpu/modem/qam.py``.  The per-line quantities (start
phase, V-switch sign, NIIR reference mask) are tensors indexed by the
absolute line number, so there is no loop and no state.  These are the
plain twins of the CUDA kernels in ``kernels/qam.py``: the ``plain``
pipeline backend runs them, and the tests hold them against the JAX
package's ``xla`` path.
"""

from __future__ import annotations

import torch

from color_modem_tpu_torch.dsp.apply import fir_same
from color_modem_tpu_torch.dsp.nco import f32, line_phase0
from color_modem_tpu_torch.modem.plan import QamPlan


def carrier_phase(plan: QamPlan, gline: torch.Tensor) -> torch.Tensor:
    """phi[..., l, n] for absolute line indices ``gline`` (..., L)."""
    phi0 = line_phase0(plan.cpl_num, plan.cpl_den, gline)  # (..., L)
    return phi0[..., None] + plan.ramp + f32(plan.theta)


def v_sign(plan: QamPlan, gline: torch.Tensor) -> torch.Tensor:
    """PAL V-switch sign per line (+1 everywhere when disabled)."""
    if not plan.chroma.v_switch:
        return torch.ones(gline.shape, dtype=torch.float32, device=gline.device)
    even = torch.remainder(gline, 2) == 0
    return torch.where(even, 1.0, -1.0).to(torch.float32)


def reference_line_mask(plan: QamPlan, gline: torch.Tensor) -> torch.Tensor | None:
    """NIIR: True on lines carrying the unmodulated reference carrier."""
    if plan.chroma.reference_amplitude is None:
        return None
    return torch.remainder(gline, 2) == 1


def encode(plan: QamPlan, ycc: torch.Tensor, gline: torch.Tensor) -> torch.Tensor:
    """(..., 3, L, N) components + (..., L) line indices -> (..., L, N) composite."""
    y = ycc[..., 0, :, :]
    c1f = fir_same(ycc[..., 1, :, :], plan.c1_lpf_mat)
    c2f = fir_same(ycc[..., 2, :, :], plan.c2_lpf_mat)
    phi = carrier_phase(plan, gline)
    s = v_sign(plan, gline)[..., None]
    chroma = c1f * torch.sin(phi) + s * c2f * torch.cos(phi)
    ref_mask = reference_line_mask(plan, gline)
    if ref_mask is not None:
        ref_carrier = f32(plan.chroma.reference_amplitude) * torch.sin(phi)
        chroma = torch.where(ref_mask[..., None], ref_carrier, chroma)
    return y + chroma


def separate_notch(plan: QamPlan, comp: torch.Tensor):
    """Sample-axis notch separation: luma = comp - BPF(comp)."""
    chroma_band = fir_same(comp, plan.chroma_bpf_mat)
    return comp - chroma_band, chroma_band


def demodulate_carrier(plan: QamPlan, chroma_band: torch.Tensor, gline: torch.Tensor):
    """Product detector: chroma-band signal -> (c1, c2) baseband components."""
    phi = carrier_phase(plan, gline)
    s = v_sign(plan, gline)[..., None]
    c1 = fir_same(2.0 * chroma_band * torch.sin(phi), plan.c1_lpf_mat)
    c2 = s * fir_same(2.0 * chroma_band * torch.cos(phi), plan.c2_lpf_mat)
    return c1, c2


def demodulate_separated(plan: QamPlan, sep: torch.Tensor, comp: torch.Tensor,
                         gline: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``kernels/qam.py::demodulate_separated``: the chroma
    band-pass of the stencil signal ``sep``, luma = ``comp`` - band, and the
    product detector: (..., L, N) -> (..., 3, L, N) ``[y, c1, c2]``."""
    chroma_band = fir_same(sep, plan.chroma_bpf_mat)
    return torch.stack([comp - chroma_band, *demodulate_carrier(plan, chroma_band, gline)],
                       dim=-3)
