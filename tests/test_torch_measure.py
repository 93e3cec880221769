"""The kernels' bounds (``kernels/measure.py``) counted from the plans on the
CPU: each filter at the width its kernel runs it, each plane once."""

from __future__ import annotations

import pytest

from color_modem_tpu_torch import NTSC, PAL, SECAM
from color_modem_tpu_torch.kernels import measure
from color_modem_tpu_torch.modem.plan import make_plan
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kernel,want", [("qam_encode", 0.026409), ("qam_decode", 0.033012)])
def test_qam_bounds_are_the_bytes_at_the_main_path(kernel, want):
    """NTSC 16x480x720: 4 (encode) or 5 (decode) float32 planes at 3.35 TB/s."""
    ms, by = measure.kernel_bound(make_plan(NTSC(), 720), kernel, 16 * 480)
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("std,kernel,filters", [(NTSC, "qam_encode", 2), (PAL, "qam_decode", 3)])
def test_qam_flops(std, kernel, filters):
    plan = make_plan(std(), 720)
    want = 2.0 * plan.c1_lpf.numel() * filters * 100 * 720
    assert measure.kernel_flops(plan, kernel, 100) == want


def test_secam_decode_counts_demod_lpf_at_the_cropped_width():
    """Five filters run over N + 2M; demod_lpf only over the N samples the
    kernel writes out."""
    plan = make_plan(SECAM(), 720)
    n, n_ext = 720, 720 + 2 * plan.fm_margin
    widths = {"bell_takeoff": n_ext, "luma_notch": n_ext, "mix_lpf": 2 * n_ext,
              "diff": 2 * n_ext, "deemph": n_ext, "demod_lpf": n}
    want = sum(2.0 * getattr(plan, f).numel() * w for f, w in widths.items()) * 9216
    assert plan.luma_notch.numel() == plan.bell_takeoff.numel()
    assert measure.kernel_flops(plan, "secam_decode", 9216) == want
    ms, by = measure.kernel_bound(plan, "secam_decode", 9216)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * want / measure.FP32_FLOPS_PER_S)


def test_secam_encode_bound():
    plan = make_plan(SECAM(), 720)
    taps = sum(getattr(plan, f).numel() for f in ("comp_lpf", "preemph", "anticloche"))
    assert measure.kernel_flops(plan, "secam_encode", 10) == 2.0 * taps * 10 * 720
    ms, by = measure.kernel_bound(plan, "secam_encode", 9216)
    t_bytes = 1e3 * 4.0 * 3 * 9216 * 720 / measure.HBM_BYTES_PER_S
    assert ms == pytest.approx(max(t_bytes, 1e3 * 2.0 * taps * 9216 * 720
                                   / measure.FP32_FLOPS_PER_S))


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        measure.kernel_flops(make_plan(NTSC(), 720), "fir_check", 1)


@pytest.mark.parametrize("entry,bytes_per_word", [("threefry_bits", 4),
                                                  ("threefry_add_normal", 8)])
def test_threefry_bound_counts_the_kernels_integer_operations(entry, bytes_per_word):
    """``THREEFRY_INT_OPS`` read from ``csrc/threefry.cu``: each four-round
    block's rotations and xors times the hash's blocks, the xor of its two
    words, and for the normal the mantissa's shift and or.  At the
    runner's 16 x 480 x 2880 the operations set both bounds."""
    import re

    from color_modem_tpu_torch.kernels.build import CSRC_DIR

    text = (CSRC_DIR / "threefry.cu").read_text()

    def body(signature):
        return re.search(re.escape(signature) + r".*?\n}\n", text, re.S).group(0)

    block = body("void rounds(")
    bits = ((block.count("__funnelshift_l(") + block.count("^="))
            * body("void threefry(").count("rounds(") + 1)
    assert "const uint32_t bits = x0 ^ x1;" in text
    assert "(bits >> 9) | 0x3F800000u" in body("float unit_normal(")
    want = bits + 2 if entry == "threefry_add_normal" else bits
    assert measure.THREEFRY_INT_OPS[entry] == want
    words = 16 * 480 * 2880
    ms, by = measure.threefry_bound(entry, words, bytes_per_word)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * want * words / measure.INT32_OPS_PER_S)


@pytest.mark.parametrize("shape,want", [((64, 3, 480, 720), 0.158460),
                                        ((16, 3, 576, 720), 0.047538)])
def test_colour_matrix_bound_is_six_planes_at_the_cells_shapes(shape, want):
    """One pass reads the three planes of each group and writes three: 8
    bytes per input sample at 3.35 TB/s (NTSC batch 64, SECAM batch 16)."""
    import math

    ms, by = measure.colour_matrix_bound(math.prod(shape))
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=1e-5)
    assert ms == pytest.approx(1e3 * 6 * 4 * math.prod(shape[:1] + shape[2:])
                               / measure.HBM_BYTES_PER_S)


@pytest.mark.parametrize("shape,want", [((64, 480, 720), 0.052820), ((64, 576, 720), 0.063384)])
def test_comb_stencil_bound_is_two_planes_at_the_cells_shapes(shape, want):
    """One pass reads the composite once and writes the stencil signal once:
    8 bytes a sample at 3.35 TB/s (NTSC batch 64; PAL's 576 lines)."""
    import math

    ms, by = measure.comb_stencil_bound(math.prod(shape))
    assert by == "bytes"
    assert ms == pytest.approx(want, rel=1e-5)
    assert ms == pytest.approx(1e3 * 2 * 4 * math.prod(shape) / measure.HBM_BYTES_PER_S)
