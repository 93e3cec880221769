"""PALplus: 16:9 letterbox transmission with a vertical-helper signal.

Port of ``color_modem_tpu/frame/palplus.py``.  A 16:9 programme goes out as
a 4:3-compatible letterbox (the picture squeezed to 3/4 height between
black bars), and the vertical detail the squeeze loses, the "helper", is
modulated onto the colour subcarrier inside the bars, where a conventional
receiver shows (nearly) nothing and a PALplus receiver rebuilds the
full-height picture.  The system is linear maps around the QAM machinery:

* the letterbox picture is the anti-aliased ``L -> 3L/4`` resample
  (``frame/transcode.py::resample_lines``); the helper band is the residual
  ``Y - up(down(Y))``, the top quarter of the vertical spectrum;
* multiplying by ``(-1)^row`` shifts that band to baseband, so resampling
  it to ``L/4`` lines stores it losslessly; the decoder runs the adjoint;
* the helper rides DSB-SC on the subcarrier's U axis over the bar rows, on
  the picture's own phase law (each bar row keyed by its own line index);
* geometry: ``3L/4`` picture rows centred, ``L/8``-row bars on each side.

The letterbox rows go through ``encode_block``/``decode_block`` on their
own, so on the card they run the QAM kernels (the ``_shared`` forms on
PAL) over exactly the picture rows: the kernels never see a bar row.
Interlaced PALplus (the 625i service) filters whole frames and transmits
field-sequentially, every row keyed by its field line index.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from color_modem_tpu_torch.dsp import design
from color_modem_tpu_torch.dsp.apply import fir_same_taps
from color_modem_tpu_torch.dsp.colorimetry import clamp01
from color_modem_tpu_torch.dsp.nco import f32
from color_modem_tpu_torch.frame.interlace import field_line_index, split_fields, weave_fields
from color_modem_tpu_torch.frame.pipeline import (
    Plan,
    _check_backend,
    check_decoder,
    decode_block,
    encode_block,
    frame_line_index,
    resolve_device,
)
from color_modem_tpu_torch.frame.raster import add_raster, make_raster, strip_raster
from color_modem_tpu_torch.frame.transcode import resample_lines
from color_modem_tpu_torch.modem.plan import plan_on
from color_modem_tpu_torch.modem.qam import carrier_phase

#: the helper's sidebands clear the luma band below and fs/2 above (PAL at
#: 13.5 MHz: 4.43 + 2.0 < 6.75)
HELPER_BW_HZ = 2.0e6
#: transmitted helper clip: the bars stay inside the normal chroma excursion
HELPER_CLIP = 0.5


class PalPlusGeometry:
    """Row layout: ``bar`` rows, ``l_pic`` picture rows, ``bar`` rows."""

    def __init__(self, active_lines: int):
        if active_lines % 8:
            raise ValueError(f"PALplus needs active_lines divisible by 8, got {active_lines}")
        self.l_full = active_lines
        self.l_pic = 3 * active_lines // 4
        self.bar = active_lines // 8
        self.l_helper = active_lines // 4  # == 2 * bar


def _check_plan(plan: Plan, n_lines: int) -> PalPlusGeometry:
    if plan.cfg.is_fm:
        raise ValueError("PALplus helper transport needs a QAM subcarrier; "
                         f"{plan.cfg.name} is FM")
    # the geometry follows the frame given, proportioned like the full raster
    return PalPlusGeometry(n_lines)


def _check_interlaced(plan: Plan, n_lines: int) -> PalPlusGeometry:
    geo = _check_plan(plan, n_lines)
    if n_lines % 16:
        # bar = L/8 must be even: each field carries bar/2 rows of each bar
        raise ValueError(f"interlaced PALplus needs lines divisible by 16, got {n_lines}")
    return geo


@lru_cache(maxsize=16)
def _row_sign(l_full: int, device: torch.device) -> torch.Tensor:
    """(L, 1) float32 (-1)^row: the vertical band shift to and from baseband."""
    sign = 1.0 - 2.0 * (torch.arange(l_full) % 2).to(torch.float32)
    return sign[:, None].to(device)


@lru_cache(maxsize=16)
def _helper_taps_of(fs: float, fsc: float):
    bw = min(HELPER_BW_HZ, 0.95 * (fs / 2.0 - fsc), 0.95 * fsc)
    taps = design.lowpass_taps(fs, bw, 129)
    taps.flags.writeable = False  # the cache hands the same array to every caller
    return taps


def _helper_taps(plan: Plan):
    """The helper's horizontal band limit (float64 host taps)."""
    return _helper_taps_of(plan.fs, plan.chroma.fsc)


def _split_rows(geo: PalPlusGeometry, x: torch.Tensor):
    """(..., L, N) -> picture rows, bar rows (top then bottom)."""
    pic = x[..., geo.bar : geo.bar + geo.l_pic, :]
    bars = torch.cat([x[..., : geo.bar, :], x[..., geo.bar + geo.l_pic :, :]], dim=-2)
    return pic, bars


def _split_g(geo: PalPlusGeometry, g: torch.Tensor):
    g_pic = g[..., geo.bar : geo.bar + geo.l_pic]
    g_bars = torch.cat([g[..., : geo.bar], g[..., geo.bar + geo.l_pic :]], dim=-1)
    return g_pic, g_bars


def helper_encode(geo: PalPlusGeometry, y_full: torch.Tensor):
    """Full-height luma (..., L, N) -> (letterbox Y (..., 3L/4, N),
    critically decimated helper (..., L/4, N))."""
    down = resample_lines(y_full, geo.l_pic)
    residual = y_full - resample_lines(down, geo.l_full)  # band [3/8, 1/2) cycles/line
    shifted = _row_sign(geo.l_full, y_full.device) * residual
    return down, resample_lines(shifted, geo.l_helper)


def helper_reconstruct(geo: PalPlusGeometry, y_pic: torch.Tensor,
                       helper: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`helper_encode`: letterbox luma + decoded helper
    lines -> full-height luma."""
    up = resample_lines(y_pic, geo.l_full)
    return up + _row_sign(geo.l_full, y_pic.device) * resample_lines(helper, geo.l_full)


def _encode_helper(plan: Plan, geo: PalPlusGeometry, rgb: torch.Tensor, backend: str):
    """(float32 RGB, band-limited helper lines, clamped letterbox RGB)."""
    rgb = rgb.to(torch.float32)
    ycc = _check_backend(backend).colour_matrix(plan.rgb_to_ycc, rgb)
    _, helper = helper_encode(geo, ycc[..., 0, :, :])
    helper = fir_same_taps(helper, _helper_taps(plan))
    return rgb, helper, clamp01(resample_lines(rgb, geo.l_pic))


def _helper_on_carrier(plan: Plan, helper: torch.Tensor, g: torch.Tensor,
                       helper_gain: float) -> torch.Tensor:
    return torch.clamp(f32(helper_gain) * helper * torch.sin(carrier_phase(plan, g)),
                       -HELPER_CLIP, HELPER_CLIP)


def _helper_off_carrier(plan: Plan, bars: torch.Tensor, g: torch.Tensor,
                        helper_gain: float) -> torch.Tensor:
    """Product detection of the bar rows, band-limited, gain undone."""
    helper = fir_same_taps(2.0 * bars * torch.sin(carrier_phase(plan, g)), _helper_taps(plan))
    return helper / f32(helper_gain)


def _with_helper(plan: Plan, geo: PalPlusGeometry, up: torch.Tensor,
                 helper: torch.Tensor, backend: str) -> torch.Tensor:
    """Add the helper band to the upsampled picture's luma (resampling and
    the 3x3 matrices are linear and commute, so this equals
    :func:`helper_reconstruct` on the letterbox luma), back to RGB."""
    colour = _check_backend(backend).colour_matrix
    ycc = colour(plan.rgb_to_ycc, up)
    y = ycc[..., 0, :, :] + _row_sign(geo.l_full, up.device) * resample_lines(helper,
                                                                              geo.l_full)
    ycc = torch.stack([y, ycc[..., 1, :, :], ycc[..., 2, :, :]], dim=-3)
    return colour(plan.ycc_to_rgb, ycc, clamp=True)


def encode_palplus(plan: Plan, rgb: torch.Tensor, gline: torch.Tensor,
                   backend: str = "kernel", helper_gain: float = 1.0) -> torch.Tensor:
    """(..., 3, L, N) full-height 16:9 RGB -> (..., L, N) letterbox
    composite with the helper in the bars; ``gline`` covers all L rows."""
    geo = _check_plan(plan, rgb.shape[-2])
    rgb, helper, rgb_pic = _encode_helper(plan, geo, rgb, backend)
    g_pic, g_bars = _split_g(geo, gline)
    comp_pic = encode_block(plan, rgb_pic, g_pic, backend)
    bars = _helper_on_carrier(plan, helper, g_bars, helper_gain)
    return torch.cat([bars[..., : geo.bar, :], comp_pic, bars[..., geo.bar :, :]], dim=-2)


def decode_palplus(plan: Plan, comp: torch.Tensor, gline: torch.Tensor, decoder: str = "comb3",
                   backend: str = "kernel", helper_gain: float = 1.0,
                   use_helper: bool = True) -> torch.Tensor:
    """(..., L, N) letterbox composite -> (..., 3, L, N) full-height 16:9
    RGB.  ``use_helper=False`` is the conventional receiver's zoom: the
    letterbox upsampled, the bars ignored."""
    geo = _check_plan(plan, comp.shape[-2])
    pic, bars = _split_rows(geo, comp.to(torch.float32))
    g_pic, g_bars = _split_g(geo, gline)
    up = resample_lines(decode_block(plan, pic, g_pic, decoder, backend), geo.l_full)
    if not use_helper:
        return clamp01(up)
    return _with_helper(plan, geo, up, _helper_off_carrier(plan, bars, g_bars, helper_gain),
                        backend)


def _factory_setup(plan: Plan, decoder: str, backend: str, device, raster: bool):
    check_decoder(plan, decoder)
    _check_backend(backend)
    device = resolve_device(device)
    plan = plan_on(plan, device)
    rp = make_raster(plan) if raster else None

    def _input(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return plan, device, rp, _input


def make_palplus_pipeline(plan: Plan, decoder: str = "comb3", backend: str = "kernel",
                          helper_gain: float = 1.0, raster: bool = False,
                          device: torch.device | str = "cuda"):
    """``(encode, decode, roundtrip)`` closures on ``device``, batch-first
    like ``frame/pipeline.py::make_pipeline``; the frame height comes from
    the input (divisible by 8).  ``raster``: sync and burst in every line's
    blanking (the bars carried normal sync and burst on air); ``encode``
    then returns full rows and ``decode`` strips them, and ``roundtrip``
    skips both (``strip(add(x)) == x``).  ``decode`` and ``roundtrip`` take
    ``use_helper``."""
    _check_plan(plan, plan.cfg.active_lines)
    plan, device, rp, _input = _factory_setup(plan, decoder, backend, device, raster)

    @torch.inference_mode()
    def encode(rgb, frame0=0):
        rgb = _input(rgb)
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l, device)
        comp = encode_palplus(plan, rgb, g, backend, helper_gain)
        return comp if rp is None else add_raster(plan, rp, comp, g)

    @torch.inference_mode()
    def decode(comp, frame0=0, use_helper=True):
        comp = _input(comp)
        if rp is not None:
            comp = strip_raster(rp, comp)
        g = frame_line_index(plan, frame0, comp.shape[0], comp.shape[-2], device)
        return decode_palplus(plan, comp, g, decoder, backend, helper_gain, use_helper)

    @torch.inference_mode()
    def roundtrip(rgb, frame0=0, use_helper=True):
        rgb = _input(rgb)
        b, _, l, _ = rgb.shape
        g = frame_line_index(plan, frame0, b, l, device)
        comp = encode_palplus(plan, rgb, g, backend, helper_gain)
        return decode_palplus(plan, comp, g, decoder, backend, helper_gain, use_helper)

    return encode, decode, roundtrip


def encode_palplus_fields(plan: Plan, rgb: torch.Tensor, frame0, backend: str = "kernel",
                          helper_gain: float = 1.0) -> torch.Tensor:
    """(B, 3, L, N) full-height 16:9 RGB frames -> (2B, L/2, N)
    field-sequential PALplus composite.

    The vertical filter bank runs on whole frames (the real system's film
    mode); transmission is field-sequential, frame row ``j`` in field
    ``j % 2``: each field carries ``3L/8`` letterbox rows between
    ``bar/2``-row bars, and the helper lines split alternately across the
    field pair.  Every row is keyed by its field line index, so the phase
    law, the V-switch and the helper's carrier follow transmission order.
    """
    b, _, l, n = rgb.shape
    geo = _check_interlaced(plan, l)
    rgb, helper, rgb_pic = _encode_helper(plan, geo, rgb, backend)
    # full-height planes: picture rows in place, helper line h on its bar
    # row; the zero rows of each plane are the other plane's
    zb = rgb.new_zeros(rgb.shape[:-3] + (3, geo.bar, n))
    rgb_full = torch.cat([zb, rgb_pic, zb], dim=-2)
    zp = helper.new_zeros(helper.shape[:-2] + (geo.l_pic, n))
    hlp_full = torch.cat([helper[..., : geo.bar, :], zp, helper[..., geo.bar :, :]], dim=-2)
    g = field_line_index(plan, frame0, b, l // 2, rgb.device)
    comp = encode_block(plan, split_fields(rgb_full), g, backend)   # (2B, L/2, N)
    # the bar rows carry ONLY the helper: mask the encoded black rows out,
    # then add the clipped helper (zero on picture rows)
    hb, pr = geo.bar // 2, geo.l_pic // 2
    row = torch.arange(l // 2, device=rgb.device)
    is_bar = (row < hb) | (row >= hb + pr)
    bars = _helper_on_carrier(plan, split_fields(hlp_full), g, helper_gain)
    return torch.where(is_bar[:, None], 0.0, comp) + bars


def decode_palplus_fields(plan: Plan, comp_fields: torch.Tensor, frame0,
                          decoder: str = "comb3", backend: str = "kernel",
                          helper_gain: float = 1.0, use_helper: bool = True) -> torch.Tensor:
    """(2B, L/2, N) field-sequential PALplus composite -> (B, 3, L, N)
    full-height frames (``use_helper=False``: the conventional zoom)."""
    b2, rows = comp_fields.shape[0], comp_fields.shape[-2]
    geo = _check_interlaced(plan, 2 * rows)
    comp_fields = comp_fields.to(torch.float32)
    g = field_line_index(plan, frame0, b2 // 2, rows, comp_fields.device)
    hb, pr = geo.bar // 2, geo.l_pic // 2
    # decode the picture rows ONLY (the comb stencils reflect inside the
    # picture instead of combing the bars), then weave the fields
    rgb_pic = weave_fields(decode_block(plan, comp_fields[..., hb : hb + pr, :],
                                        g[..., hb : hb + pr], decoder, backend))
    up = resample_lines(rgb_pic, geo.l_full)
    if not use_helper:
        return clamp01(up)
    # product-detect each field's bar rows, and weave the field pair back
    # into the progressive helper order (frame bar row j lives in field j % 2)
    bars_f = torch.cat([comp_fields[..., :hb, :], comp_fields[..., hb + pr :, :]], dim=-2)
    g_bars = torch.cat([g[..., :hb], g[..., hb + pr :]], dim=-1)
    helper_f = _helper_off_carrier(plan, bars_f, g_bars, helper_gain)   # (2B, bar, N)
    helper = torch.cat([weave_fields(helper_f[..., :hb, :]),
                        weave_fields(helper_f[..., hb:, :])], dim=-2)  # (B, L/4, N)
    return _with_helper(plan, geo, up, helper, backend)


def make_interlaced_palplus_pipeline(plan: Plan, decoder: str = "comb3",
                                     backend: str = "kernel", helper_gain: float = 1.0,
                                     raster: bool = False,
                                     device: torch.device | str = "cuda"):
    """``(encode, decode, roundtrip)`` of the interlaced service on
    ``device``: ``encode (B, 3, L, N) -> (2B, L/2, N)`` field-sequential
    composite (full rows with ``raster``), ``decode`` rebuilds the frames.
    The field composite feeds ``frame/rf.py`` like any other."""
    _check_interlaced(plan, plan.cfg.active_lines)
    plan, device, rp, _input = _factory_setup(plan, decoder, backend, device, raster)

    @torch.inference_mode()
    def encode(rgb, frame0=0):
        rgb = _input(rgb)
        comp = encode_palplus_fields(plan, rgb, frame0, backend, helper_gain)
        if rp is None:
            return comp
        g = field_line_index(plan, frame0, rgb.shape[0], rgb.shape[-2] // 2, device)
        return add_raster(plan, rp, comp, g)

    @torch.inference_mode()
    def decode(comp_fields, frame0=0, use_helper=True):
        comp_fields = _input(comp_fields)
        if rp is not None:
            comp_fields = strip_raster(rp, comp_fields)
        return decode_palplus_fields(plan, comp_fields, frame0, decoder, backend,
                                     helper_gain, use_helper)

    @torch.inference_mode()
    def roundtrip(rgb, frame0=0, use_helper=True):
        comp = encode_palplus_fields(plan, _input(rgb), frame0, backend, helper_gain)
        return decode_palplus_fields(plan, comp, frame0, decoder, backend, helper_gain,
                                     use_helper)

    return encode, decode, roundtrip
