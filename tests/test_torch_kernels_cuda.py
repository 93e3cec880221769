"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips when ``torch.cuda.is_available()`` is
false, so the CPU run collects and skips them.  On a GPU machine, which has
no JAX, run them without the JAX test configuration:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Bounds are chip_smoke.py's: 2e-5 on QAM encode, 2e-4 on SECAM encode (the
phase scan sums in another order than ``torch.cumsum``), 5e-4 on decode
(SECAM: on the decoded RGB, since the discriminator divides by the
takeoff's amplitude and the raw component error depends on the input).
"""

import json

import numpy as np
import pytest
import torch

from color_modem_tpu_torch import ALL_STANDARDS, SECAM
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, clamp01, delayline_mat3
from color_modem_tpu_torch.frame.pipeline import STAGES, frame_line_index, make_pipeline
from color_modem_tpu_torch.kernels import fir as fk
from color_modem_tpu_torch.kernels import launch_counts, reset_launches
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.modem import secam
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
from color_modem_tpu_torch.separate.comb import line_stencil, stencil_signal
from color_modem_tpu_torch.utils.metrics import psnr
from color_modem_tpu_torch.utils.testimages import smooth_scene

pytestmark = pytest.mark.cuda

ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
SECAM_ENC_ATOL = 2e-4


def _assert_launched(**want: int) -> None:
    """The launch counter (``kernels.launch_counts``) holds ``want`` for each
    entry point it names."""
    counts = launch_counts()
    assert {name: counts[name] for name in want} == want


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(dev, name, frames, lines, n, decoder, seed=0):
    plan = make_plan(ALL_STANDARDS[name](), n).to(dev)
    rng = np.random.default_rng(seed)
    ycc = np.stack([
        rng.uniform(0.0, 1.0, (frames, lines, n)),
        rng.uniform(-0.6, 0.6, (frames, lines, n)),
        rng.uniform(-0.6, 0.6, (frames, lines, n)),
    ], axis=1)
    ycc = torch.tensor(ycc, dtype=torch.float32, device=dev)
    cols = qk.phase_cols(plan, frame_line_index(plan, 12345, frames, lines, dev))
    reset_launches()
    comp_k = qk.encode_lines(plan, ycc, cols)
    comp_p = qk.encode_lines_plain(plan, ycc, cols)
    sep = stencil_signal(plan, comp_p, decoder)
    dec_k = qk.decode_lines(plan, sep, comp_p, cols)
    dec_p = qk.decode_lines_plain(plan, sep, comp_p, cols)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=1, qam_decode=1)
    assert float((comp_k - comp_p).abs().max()) <= ENC_ATOL
    assert float((dec_k - dec_p).abs().max()) <= DEC_ATOL


@pytest.mark.parametrize("name,lines,decoder",
                         [("ntsc", 480, "comb3"), ("pal", 576, "comb3"),
                          ("niir", 576, "notch")])
def test_kernels_match_plain_at_main_path_size(dev, name, lines, decoder):
    _kernel_vs_plain(dev, name, 16, lines, 720, decoder)


@pytest.mark.parametrize("name,frames,lines,n",
                         [("ntsc", 3, 27, 722), ("pal", 1, 5, 1440), ("ntsc", 2, 1, 720)])
def test_kernels_match_plain_at_odd_shapes(dev, name, frames, lines, n):
    """Line counts and widths that are not multiples of the kernels' groups
    of 4 samples; 1440 samples give 259 taps."""
    _kernel_vs_plain(dev, name, frames, lines, n, "notch")


QAM_NAMES = sorted(k for k, f in ALL_STANDARDS.items() if not f().is_fm)


@pytest.mark.parametrize("lines,n", [(1, 720), (63, 720), (65, 720), (481, 720), (65, 722)])
@pytest.mark.parametrize("name", QAM_NAMES)
def test_qam_kernels_match_plain_per_standard(dev, name, lines, n):
    """Every QAM standard through both kernels at line counts that leave a
    ragged last tile (1, 63, 65, 481 lines in one frame) and at 722 samples
    (a row stride that is not a multiple of 16 bytes: 4-byte copies)."""
    _kernel_vs_plain(dev, name, 1, lines, n, "notch", seed=lines + n)


def test_main_path_roundtrip(dev):
    plan = make_plan(ALL_STANDARDS["ntsc"](), 720)
    one = smooth_scene(480, 720, seed=0)
    rgb = torch.tensor(np.broadcast_to(one, (16, 3, 480, 720)), dtype=torch.float32,
                       device=dev)
    _, _, rt = make_pipeline(plan, "comb3", backend="kernel", device=dev)
    reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=1, qam_decode=1)
    assert abs(psnr(out, rgb) - 46.62) <= 0.02


# --- the colour matrix, csrc/colour_matrix.cu ----------------------------------------

#: the two batch cells' shapes, a plane that is no multiple of 4 samples
#: (the scalar path) under two leading axes, and one line with no leading axis
COLOUR_SHAPES = [(64, 3, 480, 720), (16, 3, 576, 720), (2, 4, 3, 7, 721), (3, 1, 720)]
COLOUR_ATOL = 1e-6  # float32 multiply-adds against the product and two addcmul_


def _colour_vs_plain(mat, x, clamp):
    """The kernel against the plain version on the card: one launch, the
    same NaNs, and the largest difference elsewhere."""
    from color_modem_tpu_torch.kernels import colorimetry as ck

    reset_launches()
    got = ck.colour_matrix(mat, x, clamp)
    want = apply_mat3(mat, x, clamp)
    torch.cuda.synchronize()
    _assert_launched(colour_matrix=1, delayline_matrix=0)
    assert got.shape == want.shape and got.is_contiguous()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    return float((got - want).masked_fill(nan, 0.0).abs().max())


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("matrix", ["rgb_to_ycc", "ycc_to_rgb"])
@pytest.mark.parametrize("name", sorted(ALL_STANDARDS))
def test_colour_matrix_per_standard(dev, name, matrix, clamp):
    mat = getattr(make_plan(ALL_STANDARDS[name](), 720).to(dev), matrix)
    gen = torch.Generator(device=dev).manual_seed(len(name))
    x = torch.rand((2, 3, 16, 720), generator=gen, device=dev)
    assert _colour_vs_plain(mat, x, clamp) <= COLOUR_ATOL


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("shape", COLOUR_SHAPES)
def test_colour_matrix_shapes(dev, shape, clamp):
    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    mat = plan.ycc_to_rgb if clamp else plan.rgb_to_ycc
    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    x = torch.rand(shape, generator=gen, device=dev)
    assert _colour_vs_plain(mat, x, clamp) <= COLOUR_ATOL


@pytest.mark.parametrize("clamp", [False, True])
def test_colour_matrix_misaligned_view_and_nan(dev, clamp):
    """A view 4 bytes past a 16-byte boundary takes the scalar path; a NaN
    in an input sample stays a NaN in each of its three outputs, clamped or
    not, and so reaches the float checks."""
    mat = make_plan(ALL_STANDARDS["pal"](), 720).to(dev).ycc_to_rgb
    gen = torch.Generator(device=dev).manual_seed(3)
    flat = torch.rand(1 + 2 * 3 * 16 * 720, generator=gen, device=dev)
    x = flat[1:].view(2, 3, 16, 720)
    assert x.data_ptr() % 16 == 4
    x[0, 1, 5, 17] = float("nan")
    x[1, 2, 0, 0] = float("nan")
    assert _colour_vs_plain(mat, x, clamp) <= COLOUR_ATOL
    out = colour_matrix(mat, x, clamp)
    assert bool(torch.isnan(out[0, :, 5, 17]).all()) and bool(torch.isnan(out[1, :, 0, 0]).all())
    assert int(torch.isnan(out).sum()) == 6


@pytest.mark.parametrize("name,decoder", [("ntsc", "comb3"), ("secam", "interp")])
def test_roundtrip_launches_the_colour_matrix_twice(dev, name, decoder):
    """Each round trip runs both matrices, the decoder's clamp inside the
    second: two launches a call."""
    cfg = ALL_STANDARDS[name]()
    rgb = _scene(cfg.active_lines, dev)
    _, _, rt = make_pipeline(make_plan(cfg, 720), decoder, backend="kernel", device=dev)
    rt(rgb, 0)
    reset_launches()
    for frame0 in (0, 16):
        out = rt(rgb, frame0)
    torch.cuda.synchronize()
    _assert_launched(colour_matrix=4, delayline_matrix=0)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


@pytest.mark.parametrize("name,decoder", [("ntsc", "comb3"), ("secam", "interp")])
def test_plain_backend_takes_the_plain_colour_matrix(dev, name, decoder):
    """The plain backend on the card launches no colour-matrix kernel, so
    its agreement with the kernel backend covers the colour conversion too."""
    cfg = ALL_STANDARDS[name]()
    rgb = _scene(cfg.active_lines, dev)
    _, _, rt = make_pipeline(make_plan(cfg, 720), decoder, backend="plain", device=dev)
    reset_launches()
    rt(rgb, 0)
    mat = make_plan(cfg, 720).to(dev).ycc_to_rgb
    got = STAGES["plain"].colour_matrix(mat, rgb, True)
    torch.cuda.synchronize()
    _assert_launched(colour_matrix=0, delayline_matrix=0)
    assert torch.equal(got, apply_mat3(mat, rgb, True))


# --- the delay line and the decoder's matrix in one pass (delayline_matrix) ---------

#: the cell's batch and chip_smoke's, under leading axes, ragged lines and a line
#: that is no multiple of 4 samples (the scalar path), and the least frame
DELAYLINE_SHAPES = [(64, 3, 576, 720), (16, 3, 576, 720), (2, 4, 3, 7, 721), (3, 3, 63, 722),
                    (1, 3, 2, 4), (3, 65, 720)]


def _delayline_vs_plain(dev, x, name="pal"):
    """The pass against the plain composition on the card: one launch, the
    same bits (NaNs where the plain composition has them)."""
    from color_modem_tpu_torch.kernels import colorimetry as ck

    mat = make_plan(ALL_STANDARDS[name](), 720).to(dev).ycc_to_rgb
    reset_launches()
    got = ck.delayline_matrix(mat, x)
    want = delayline_mat3(mat, x)
    torch.cuda.synchronize()
    _assert_launched(colour_matrix=0, delayline_matrix=1)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("shape", DELAYLINE_SHAPES)
def test_delayline_matrix_is_the_plain_composition_bit_for_bit(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(shape[-2])
    x = torch.rand(shape, generator=gen, device=dev)
    x[..., 1:, :, :] = 1.2 * x[..., 1:, :, :] - 0.6
    _delayline_vs_plain(dev, x)


@pytest.mark.parametrize("name", ["pal", "ntsc", "pal60", "ntsc443", "pal_m", "pal_n"])
def test_delayline_matrix_per_standard(dev, name):
    gen = torch.Generator(device=dev).manual_seed(len(name))
    x = 1.4 * torch.rand((2, 3, 16, 720), generator=gen, device=dev) - 0.2
    _delayline_vs_plain(dev, x, name)


def test_delayline_matrix_misaligned_view_and_nan(dev):
    """A view 4 bytes past a 16-byte boundary takes the scalar path; a NaN
    in a chroma sample of line 5 reaches lines 5 and 6 of its frame, a NaN
    on line 1 reaches line 0 through the reflection."""
    gen = torch.Generator(device=dev).manual_seed(5)
    flat = torch.rand(1 + 2 * 3 * 16 * 720, generator=gen, device=dev)
    x = flat[1:].view(2, 3, 16, 720)
    assert x.data_ptr() % 16 == 4
    x[0, 1, 5, 17] = float("nan")
    x[1, 2, 1, 3] = float("nan")
    out = _delayline_vs_plain(dev, x)
    assert bool(torch.isnan(out[0, :, 5:7, 17]).all())
    assert bool(torch.isnan(out[1, :, 0:3, 3]).all())
    assert int(torch.isnan(out).sum()) == 15


def test_delayline_matrix_refuses_one_line(dev):
    from color_modem_tpu_torch.kernels import colorimetry as ck

    mat = make_plan(ALL_STANDARDS["pal"](), 720).to(dev).ycc_to_rgb
    with pytest.raises(ValueError, match="2 or more lines"):
        ck.delayline_matrix(mat, torch.zeros((2, 3, 1, 720), device=dev))


@pytest.mark.parametrize("name,decoder", [("pal", "delayline"), ("ntsc", "avg"), ("niir", "avg")])
def test_averaging_roundtrip_launches_the_pass(dev, name, decoder):
    """A delay-line round trip runs the encoder's colour matrix and the one
    pass; it agrees with the plain backend on the card within the decode
    bound, and its decode with the phase hook equals the plain composition
    of the same demodulation."""
    from color_modem_tpu_torch.frame import pipeline

    cfg = ALL_STANDARDS[name]()
    plan = make_plan(cfg, 720)
    rgb = _scene(cfg.active_lines, dev)
    enc, _, rt = make_pipeline(plan, decoder, backend="kernel", device=dev)
    _, _, rt_p = make_pipeline(plan, decoder, backend="plain", device=dev)
    rt(rgb, 0)
    reset_launches()
    for frame0 in (0, 16):
        out = rt(rgb, frame0)
    torch.cuda.synchronize()
    _assert_launched(colour_matrix=2, delayline_matrix=2)
    _assert_launched(qam_encode=2, qam_decode=2)
    assert float((out - rt_p(rgb, 16)).abs().max()) <= DEC_ATOL
    p = plan.to(dev)
    comp = enc(rgb, 0)
    g = frame_line_index(p, 0, 16, cfg.active_lines, dev)
    phase = torch.full((16, cfg.active_lines), 0.1, device=dev)
    got = pipeline.decode_block(p, comp, g, decoder, "kernel", phase_err=phase)
    ycc = pipeline._demodulate_qam(p, comp, g, decoder, STAGES["kernel"])
    ycc = pipeline._correct_chroma(p, ycc, g, phase, None)
    want = delayline_mat3(p.ycc_to_rgb, ycc)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_secam_avg_roundtrip_launches_the_pass(dev):
    """SECAM 'avg' averages the assembled D'R/D'B planes in the same pass:
    one launch of each SECAM kernel, the encoder's colour matrix and the
    pass, its decode bit for bit the plain composition of the kernel's
    demodulation, and within the decode bound of the plain backend."""
    from color_modem_tpu_torch.frame import pipeline

    plan = make_plan(SECAM(), 720)
    rgb = _scene(576, dev)
    enc, _, rt = make_pipeline(plan, "avg", backend="kernel", device=dev)
    _, _, rt_p = make_pipeline(plan, "avg", backend="plain", device=dev)
    reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    _assert_launched(colour_matrix=1, delayline_matrix=1)
    _assert_launched(secam_encode=1, secam_decode=1)
    assert abs(psnr(out, rgb) - 33.3755) <= 0.02
    assert float((out - rt_p(rgb, 0)).abs().max()) <= DEC_ATOL
    p = plan.to(dev)
    comp = enc(rgb, 0)
    g = frame_line_index(p, 0, 16, 576, dev)
    got = pipeline.decode_block(p, comp, g, "avg", "kernel")
    want = delayline_mat3(p.ycc_to_rgb, pipeline._decode_fm(p, comp, g, "avg", STAGES["kernel"]))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --- the comb stencil of 'comb2' and 'comb3' in one pass (comb_stencil) ----------------

#: (shape, spacing): the NTSC cell's batch at p = 1 and PAL's at p = 2, a line
#: that is no multiple of 4 samples (the scalar path) and one of 722 under two
#: leading axes, ragged strips of lines, the least frame each spacing takes
#: (p + 1 lines) and 2p + 1 lines, and one frame with no leading axis
COMB_SHAPES = [((64, 480, 720), 1), ((64, 576, 720), 2), ((3, 37, 721), 1), ((2, 2, 63, 722), 2),
               ((4, 2, 720), 1), ((4, 3, 720), 2), ((5, 3, 720), 1), ((5, 5, 720), 2),
               ((481, 720), 1)]


def _comb_vs_plain(x, p, decoder):
    """The pass against the plain composition on the card: one launch, the
    same bits (NaNs where the plain composition has them)."""
    from color_modem_tpu_torch.kernels import comb

    reset_launches()
    got = comb.comb_stencil(x, p, decoder)
    want = line_stencil(x, p, decoder)
    torch.cuda.synchronize()
    _assert_launched(comb_stencil=1)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))
    return got


@pytest.mark.parametrize("decoder", ["comb2", "comb3"])
@pytest.mark.parametrize("shape,p", COMB_SHAPES)
def test_comb_stencil_is_the_plain_composition_bit_for_bit(dev, shape, p, decoder):
    gen = torch.Generator(device=dev).manual_seed(shape[-2] + p)
    x = 1.9 * torch.rand(shape, generator=gen, device=dev) - 0.45
    _comb_vs_plain(x, p, decoder)


@pytest.mark.parametrize("decoder", ["comb2", "comb3"])
@pytest.mark.parametrize("p", [1, 2])
def test_comb_stencil_non_contiguous_and_misaligned_with_nan(dev, p, decoder):
    """A transposed view (made contiguous by the wrapper), and a view 4 bytes
    past a 16-byte boundary, which takes the scalar path; a NaN on line 5
    reaches the lines that read it, an infinity on line 0 the lines that
    read line 0."""
    gen = torch.Generator(device=dev).manual_seed(7 + p)
    x = torch.rand((720, 2, 40), generator=gen, device=dev).permute(1, 2, 0)
    assert not x.is_contiguous()
    _comb_vs_plain(x, p, decoder)
    flat = torch.rand(1 + 2 * 40 * 720, generator=gen, device=dev)
    x = flat[1:].view(2, 40, 720)
    assert x.data_ptr() % 16 == 4
    x[0, 5, 17] = float("nan")
    x[1, 0, 3] = float("inf")
    out = _comb_vs_plain(x, p, decoder)
    readers = [5, 5 + p] + ([5 - p] if decoder == "comb3" else [])
    assert bool(torch.isnan(out[0, readers, 17]).all())
    assert int(torch.isnan(out[0]).sum()) == len(readers)


def test_comb_stencil_refuses_too_few_lines(dev):
    from color_modem_tpu_torch.kernels import comb

    with pytest.raises(ValueError, match="2 or more lines"):
        comb.comb_stencil(torch.zeros((2, 1, 720), device=dev), 1, "comb3")
    with pytest.raises(ValueError, match="3 or more lines"):
        comb.comb_stencil(torch.zeros((2, 2, 720), device=dev), 2, "comb2")


@pytest.mark.parametrize("name,decoder,launches", [("ntsc", "comb3", 1), ("ntsc", "comb2", 1),
                                                   ("pal", "comb3", 1), ("pal", "comb2", 1),
                                                   ("ntsc", "notch", 0), ("pal", "delayline", 0),
                                                   ("ntsc", "comb3d", 0)])
def test_comb_roundtrip_launches_the_pass(dev, name, decoder, launches, monkeypatch):
    """One launch of the pass for each 'comb2' and 'comb3' kernel-backend
    decode, none for the notch, the delay line or the frame comb; the round
    trip equals, bit for bit, the same round trip with the plain stencil,
    and agrees with the plain backend within the decode bound."""
    from color_modem_tpu_torch.kernels import comb

    cfg = ALL_STANDARDS[name]()
    plan = make_plan(cfg, 720)
    rgb = _scene(cfg.active_lines, dev)
    _, _, rt = make_pipeline(plan, decoder, backend="kernel", device=dev)
    _, _, rt_p = make_pipeline(plan, decoder, backend="plain", device=dev)
    rt(rgb, 0)
    reset_launches()
    out = rt(rgb, 16)
    torch.cuda.synchronize()
    _assert_launched(comb_stencil=launches)
    _assert_launched(qam_encode=1, qam_decode=1)
    assert float((out - rt_p(rgb, 16)).abs().max()) <= DEC_ATOL
    if launches:
        monkeypatch.setattr(comb, "comb_stencil", line_stencil)
        want = rt(rgb, 16)
        torch.cuda.synchronize()
        _assert_launched(comb_stencil=launches)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_main_path_roundtrip_with_the_pass_equals_the_plain_stencil(dev):
    """The NTSC comb3 round trip of the main path (16 x 480 x 720), bit for
    bit the same round trip with ``separate/comb.py::stencil_signal``
    in front of the decode kernel, at 46.62 dB."""
    from color_modem_tpu_torch.frame import pipeline
    from color_modem_tpu_torch.separate.comb import stencil_signal

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    rgb = _scene(480, dev)
    g = frame_line_index(plan, 0, 16, 480, dev)
    comp = pipeline.encode_block(plan, rgb, g, "kernel")
    got = pipeline.decode_block(plan, comp, g, "comb3", "kernel")
    ycc = qk.demodulate_separated(plan, stencil_signal(plan, comp, "comb3"), comp, g)
    want = colour_matrix(plan.ycc_to_rgb, ycc, clamp=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert abs(psnr(got, rgb) - 46.62) <= 0.02


def test_wrappers_reject_bad_cuda_input(dev):
    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    ycc = torch.zeros((1, 3, 4, 720), device=dev)
    cols = torch.zeros((4, 3), device=dev)
    with pytest.raises(TypeError):
        qk.encode_lines(plan, ycc.double(), cols)
    with pytest.raises(ValueError, match="plan is on"):
        qk.encode_lines(plan.to("cpu"), ycc, cols)


@pytest.mark.parametrize("held", [False, True])
@pytest.mark.parametrize("n,ntaps", [(97, 31), (720, 257), (61, 129)])
def test_fir_orientation_on_asymmetric_taps(dev, n, ntaps, held):
    """csrc/fir.cuh alone against np.convolve(mode='same') on random
    asymmetric taps: a mirrored or shifted FIR fails here, where symmetric
    QAM taps cannot tell.  (61, 129): taps longer than the line."""
    rng = np.random.default_rng(ntaps)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(7, n)).astype(np.float32)
    h = (ntaps - 1) // 2
    xp = [np.pad(r.astype(np.float64), h, mode="edge" if held else "constant")
          for r in x]
    ref = np.stack([np.convolve(r, taps, "same")[h : h + n] for r in xp])
    reset_launches()
    got = fk.fir_lines(torch.tensor(x, device=dev),
                       torch.tensor(taps, dtype=torch.float32, device=dev), held)
    torch.cuda.synchronize()
    assert launch_counts()["fir_check"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("lines", [1, 17, 63, 65, 7681])
@pytest.mark.parametrize("n", [61, 97, 720, 722, 1440])
@pytest.mark.parametrize("ntaps", [31, 129, 259])
def test_band_fir_against_np_convolve(dev, ntaps, n, lines):
    """csrc/band_fir.cuh alone (three TF32 passes on the tensor cores)
    against np.convolve(mode='same') on random asymmetric taps, <= 2e-6:
    taps longer than the line, widths that are not multiples of 4 or 8,
    lines cut into spans, and 1, 17, 63, 65 and 7681 lines (ragged last
    tiles of 16)."""
    rng = np.random.default_rng(ntaps * n + lines)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(lines, n)).astype(np.float32)
    h = (ntaps - 1) // 2
    ref = np.stack([np.convolve(np.pad(r.astype(np.float64), h), taps, "same")[h : h + n]
                    for r in x])
    reset_launches()
    got = fk.band_fir_lines(torch.tensor(x, device=dev),
                            torch.tensor(taps, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    assert launch_counts()["band_fir_check"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), ref, atol=2e-6, rtol=0)


def _secam_rgb(plan, luma, v, gline, pairing="interp"):
    dr, db = secam.pair(v, gline, pairing)
    return clamp01(colour_matrix(plan.ycc_to_rgb, torch.stack([luma, dr, db], dim=-3)))


def _secam_kernel_vs_plain(dev, frames, lines, n, frame0=3):
    plan = make_plan(SECAM(), n).to(dev)
    gline = frame_line_index(plan, frame0, frames, lines, dev)
    isr = sk.isr_col(gline)
    rng = np.random.default_rng(n)
    rgb = np.stack([smooth_scene(lines, n, seed=s) for s in range(frames)])
    rgb = torch.tensor(rgb, dtype=torch.float32, device=dev)
    ycc = colour_matrix(plan.rgb_to_ycc, rgb)
    chroma = rng.uniform(-0.6, 0.6, (frames, 2, lines, n))
    ycc_rand = torch.cat([ycc[:, :1], torch.tensor(chroma, dtype=torch.float32,
                                                   device=dev)], dim=1).contiguous()
    reset_launches()
    comp_k = sk.encode_lines(plan, ycc_rand, isr)
    comp_p = sk.encode_lines_plain(plan, ycc_rand, isr)
    comp = sk.encode_lines_plain(plan, ycc.contiguous(), isr)
    luma_k, v_k = sk.demodulate_lines(plan, comp, isr)
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    torch.cuda.synchronize()
    _assert_launched(secam_encode=1, secam_decode=1)
    assert float((comp_k - comp_p).abs().max()) <= SECAM_ENC_ATOL
    e_rgb = float((_secam_rgb(plan, luma_k, v_k, gline)
                   - _secam_rgb(plan, luma_p, v_p, gline)).abs().max())
    assert e_rgb <= DEC_ATOL
    assert float((luma_k - luma_p).abs().max()) <= DEC_ATOL


@pytest.mark.parametrize("frames,lines,n", [(4, 576, 720), (2, 576, 1440), (3, 27, 722),
                                            (1, 8, 2160)])
def test_secam_kernels_match_plain(dev, frames, lines, n):
    """720 and 1440 are the plans; 722 is not a multiple of the groups of 4;
    2160 needs more than 48 KB of shared memory in the decoder (the launch's
    opt-in)."""
    _secam_kernel_vs_plain(dev, frames, lines, n)


@pytest.mark.parametrize("frames,lines,n", [(1, 1, 720), (1, 17, 722), (3, 13, 1440),
                                            (2, 33, 720), (5, 101, 1440), (1, 13, 2160),
                                            (3, 37, 1442)])
def test_secam_kernels_match_plain_at_odd_line_counts(dev, frames, lines, n):
    """One line, 17 lines and odd counts leave a ragged last tile of 8 lines
    in the tensor-core kernels (at 1440 and 1442 the serial kernels', at
    2160 the decoder's spans'); one launch each.  The demodulated luma and
    component are held directly (the line pairing needs two lines)."""
    plan = make_plan(SECAM(), n).to(dev)
    isr = sk.isr_col(frame_line_index(plan, 3, frames, lines, dev))
    rng = np.random.default_rng(lines)
    rgb = torch.tensor(np.stack([smooth_scene(max(lines, 2), n, seed=s)[:, :lines]
                                 for s in range(frames)]), dtype=torch.float32, device=dev)
    ycc = colour_matrix(plan.rgb_to_ycc, rgb).contiguous()
    ycc_rand = torch.cat([ycc[:, :1], torch.tensor(rng.uniform(-0.6, 0.6, (frames, 2, lines, n)),
                                                   dtype=torch.float32, device=dev)],
                         dim=1).contiguous()
    reset_launches()
    comp_k = sk.encode_lines(plan, ycc_rand, isr)
    comp = sk.encode_lines_plain(plan, ycc, isr)
    luma_k, v_k = sk.demodulate_lines(plan, comp, isr)
    torch.cuda.synchronize()
    _assert_launched(secam_encode=1, secam_decode=1)
    e_enc = float((comp_k - sk.encode_lines_plain(plan, ycc_rand, isr)).abs().max())
    assert e_enc <= SECAM_ENC_ATOL
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    assert float((luma_k - luma_p).abs().max()) <= DEC_ATOL
    assert float((v_k - v_p).abs().max()) <= DEC_ATOL


@pytest.mark.parametrize("kernel", ["decode", "encode"])
def test_secam_kernels_at_the_widest_lines(dev, kernel):
    """At the widest line each SECAM kernel takes (``WIDEST`` of
    ``tests/test_torch_secam_tiles.py``, where the CPU model of its shared
    memory puts it) it launches and matches its plain version; one sample
    wider it raises."""
    from test_torch_secam_tiles import WIDEST

    n = WIDEST[kernel]
    if kernel == "decode":
        _secam_kernel_vs_plain(dev, 1, 9, n)
    for width in (n, n + 1):
        plan = make_plan(SECAM(), width).to(dev)
        isr = sk.isr_col(frame_line_index(plan, 3, 1, 9, dev))
        ycc = torch.tensor(np.random.default_rng(width).uniform(-0.5, 0.5, (1, 3, 9, width)),
                           dtype=torch.float32, device=dev)
        comp = sk.encode_lines_plain(plan, ycc, isr)
        if kernel == "encode" and width == n:
            err = float((sk.encode_lines(plan, ycc, isr) - comp).abs().max())
            assert err <= SECAM_ENC_ATOL, err
        elif width > n:
            with pytest.raises(RuntimeError, match=f"secam_{kernel}"):
                if kernel == "encode":
                    sk.encode_lines(plan, ycc, isr)
                else:
                    sk.demodulate_lines(plan, comp, isr)


_RAGGED_PLANS = {}


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("n", [720, 722, 1440, 2160])
@pytest.mark.parametrize("lines", [1, 7, 9, 63, 65, 481])
def test_secam_kernels_match_plain_at_ragged_shapes(dev, lines, n, frames):
    """Both SECAM kernels against the plain versions where a tile of 8 lines
    is ragged (1, 7, 9, 63, 65, 481 lines, one or three frames), at the
    pipelined kernels' widths (720 with bulk stores, 722 with plain
    stores) and the serial ones' (1440; 2160, where the decoder cuts the
    line into spans): encode <= 2e-4, luma and the component <= 5e-4, the
    decoded RGB <= 5e-4 where two lines pair; one launch each."""
    if n not in _RAGGED_PLANS:
        _RAGGED_PLANS[n] = make_plan(SECAM(), n).to(dev)
    plan = _RAGGED_PLANS[n]
    gline = frame_line_index(plan, 3, frames, lines, dev)
    isr = sk.isr_col(gline)
    rng = np.random.default_rng(lines * n + frames)
    rgb = torch.tensor(np.stack([smooth_scene(max(lines, 2), n, seed=s)[:, :lines]
                                 for s in range(frames)]), dtype=torch.float32, device=dev)
    ycc = colour_matrix(plan.rgb_to_ycc, rgb).contiguous()
    ycc_rand = torch.cat([ycc[:, :1], torch.tensor(rng.uniform(-0.6, 0.6, (frames, 2, lines, n)),
                                                   dtype=torch.float32, device=dev)],
                         dim=1).contiguous()
    comp = sk.encode_lines_plain(plan, ycc, isr)
    reset_launches()
    comp_k = sk.encode_lines(plan, ycc_rand, isr)
    luma_k, v_k = sk.demodulate_lines(plan, comp, isr)
    torch.cuda.synchronize()
    _assert_launched(secam_encode=1, secam_decode=1)
    assert float((comp_k - sk.encode_lines_plain(plan, ycc_rand, isr)).abs().max()) <= SECAM_ENC_ATOL
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    assert float((luma_k - luma_p).abs().max()) <= DEC_ATOL
    assert float((v_k - v_p).abs().max()) <= DEC_ATOL
    if lines > 1:
        e_rgb = float((_secam_rgb(plan, luma_k, v_k, gline)
                       - _secam_rgb(plan, luma_p, v_p, gline)).abs().max())
        assert e_rgb <= DEC_ATOL


@pytest.mark.parametrize("n", [720, 722, 1440, 2160])
def test_secam_pipelined_layouts_match_the_model(dev, n):
    """The pipelined kernels' shared-memory layouts as the C sources compute
    them (``secam_decode_pipe_layout``, ``secam_encode_pipe_layout``) equal
    the model that ``tests/test_torch_secam_tiles.py`` checks on the CPU:
    every pitch and offset, v's staging column, the total, and so which
    widths take the pipelined kernels."""
    import ctypes

    from test_torch_secam_tiles import SMEM_MAX, decode_pipe_layout, encode_pipe_layout

    from color_modem_tpu_torch.kernels.build import load_library

    lib = load_library()
    plan = make_plan(SECAM(), n)
    dec = (ctypes.c_int * 15)()
    taps = [getattr(plan, f).numel() for f in ("bell_takeoff", "mix_lpf", "diff", "deemph",
                                               "demod_lpf")]
    assert lib.secam_decode_pipe_layout(n, plan.fm_margin, *taps, dec) == 0
    d = decode_pipe_layout(plan)
    assert list(dec[:6]) == [d["pitch"][k] for k in ("band", "mix", "diff", "de", "dm")] + [
        -(-n // 4) * 4]
    assert list(dec[6:13]) == [int(o) for o in d["offsets"][:7]]
    assert dec[13] == d["c_v"] and 4 * dec[14] == d["bytes"]
    enc = (ctypes.c_int * 5)()
    assert lib.secam_encode_pipe_layout(n, *(getattr(plan, f).numel() for f in (
        "comp_lpf", "preemph", "anticloche")), enc) == 0
    e = encode_pipe_layout(plan)
    assert list(enc[:3]) == [e["pitch"][f] for f in ("comp_lpf", "preemph", "anticloche")]
    assert 4 * enc[4] == e["bytes"]
    assert (d["bytes"] <= SMEM_MAX) == (e["bytes"] <= SMEM_MAX) == (n in (720, 722))


def test_secam_roundtrip_one_launch_each(dev):
    plan = make_plan(SECAM(), 720)
    one = smooth_scene(576, 720, seed=0)
    rgb = torch.tensor(np.broadcast_to(one, (16, 3, 576, 720)), dtype=torch.float32,
                       device=dev)
    _, _, rt = make_pipeline(plan, "interp", backend="kernel", device=dev)
    reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    _assert_launched(secam_encode=1, secam_decode=1)
    assert abs(psnr(out, rgb) - 38.8644) <= 0.02


def _scene(lines, dev):
    return torch.tensor(np.broadcast_to(smooth_scene(lines, 720, seed=0), (16, 3, lines, 720)),
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("name,decoder,expected", [("pal", "delayline", 37.9984),
                                                   ("niir", "avg", 33.1777),
                                                   ("ntsc", "comb3d", 47.4153)])
def test_qam_family_roundtrip_one_launch_each(dev, name, decoder, expected):
    """PAL and NIIR run the filters the JAX package's _shared kernels ran;
    16 frames at full width, against the plain backend on the card."""
    cfg = ALL_STANDARDS[name]()
    rgb = _scene(cfg.active_lines, dev)
    _, _, rt = make_pipeline(make_plan(cfg, 720), decoder, backend="kernel", device=dev)
    _, _, rt_p = make_pipeline(make_plan(cfg, 720), decoder, backend="plain", device=dev)
    reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=1, qam_decode=1)
    assert abs(psnr(out, rgb) - expected) <= 0.02
    assert float((out - rt_p(rgb, 0)).abs().max()) <= DEC_ATOL


def test_combA_separates_outside_the_decode_kernel(dev):
    """combA's blend is plain code on both backends (as in the JAX package):
    one encode launch, no decode launch, and one composite decodes the same
    on both backends."""
    cfg = ALL_STANDARDS["ntsc"]()
    rgb = _scene(cfg.active_lines, dev)
    enc, dec, rt = make_pipeline(make_plan(cfg, 720), "combA", backend="kernel", device=dev)
    enc_p, dec_p, _ = make_pipeline(make_plan(cfg, 720), "combA", backend="plain", device=dev)
    reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=1, qam_decode=0)
    assert abs(psnr(out, rgb) - 45.5145) <= 0.02
    comp = enc(rgb, 0)
    assert float((comp - enc_p(rgb, 0)).abs().max()) <= ENC_ATOL
    assert float((dec(comp, 0) - dec_p(comp, 0)).abs().max()) <= DEC_ATOL


def test_burst_locked_decode_under_channel_phase(dev):
    """A 25-degree chroma phase error on the rastered NTSC channel: nominal
    decode 27.3564 dB, burst-locked 39.4822 dB with one decode launch."""
    from color_modem_tpu_torch.frame import raster
    from color_modem_tpu_torch.frame.channel import impair

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)  # used below with card data
    enc, dec, _ = make_pipeline(plan, "notch", backend="kernel", device=dev, raster=True)
    rgb = _scene(480, dev)
    bad = impair(plan, enc(rgb, 0), chroma_phase_deg=25.0)
    g = frame_line_index(plan, 0, 16, 480, dev)
    reset_launches()
    locked = raster.decode_burst_locked(plan, raster.make_raster(plan), bad, g, "notch")
    torch.cuda.synchronize()
    _assert_launched(qam_encode=0, qam_decode=1)
    assert abs(psnr(locked, rgb) - 39.4822) <= 0.02
    assert abs(psnr(dec(bad, 0), rgb) - 27.3564) <= 0.02


def test_interlaced_comb3d_parity_major_one_launch_each(dev):
    """The parity-major regroup hands the decode wrapper transposed planes
    and a transposed line map: one launch for all 32 fields, and the plain
    backend's result on the card."""
    from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline

    cfg = ALL_STANDARDS["ntsc"]()
    rgb = _scene(480, dev)
    _, _, rt = make_interlaced_pipeline(make_plan(cfg, 720), "comb3d", "kernel", dev)
    _, _, rt_p = make_interlaced_pipeline(make_plan(cfg, 720), "comb3d", "plain", dev)
    reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=1, qam_decode=1)
    assert abs(psnr(out, rgb) - 47.4153) <= 0.02
    assert float((out - rt_p(rgb, 0)).abs().max()) <= DEC_ATOL


def test_transcode_ntsc_to_pal_through_the_kernels(dev):
    """One NTSC decode launch and one PAL encode launch per batch; the
    plain backend's composite on the card to the decode bound."""
    from color_modem_tpu_torch.frame.transcode import make_transcoder

    ntsc, pal = ALL_STANDARDS["ntsc"](), ALL_STANDARDS["pal"]()
    rgb = _scene(480, dev)
    enc, _, _ = make_pipeline(make_plan(ntsc, 720), "notch", backend="kernel", device=dev)
    comp = enc(rgb, 0)
    conv = make_transcoder(make_plan(ntsc, 720), make_plan(pal, 720), backend="kernel",
                           device=dev)
    conv_p = make_transcoder(make_plan(ntsc, 720), make_plan(pal, 720), backend="plain",
                             device=dev)
    reset_launches()
    out = conv(comp, 0)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=1, qam_decode=1)
    assert out.shape == (16, 576, 720)
    assert float((out - conv_p(comp, 0)).abs().max()) <= DEC_ATOL


@pytest.mark.parametrize("case", ["progressive", "interlaced", "burst-locked", "secam-ident"])
def test_round_trip_never_blocks_the_host(dev, case):
    """An int frame0 costs no host-to-device copy, so a round trip enqueues
    without waiting for the card (the plans are on the card already); so do
    a rastered, burst-locked decode and the SECAM ident lines, whose host-
    built constants upload once per shape and device."""
    from color_modem_tpu_torch.frame import raster
    from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline

    if case in ("progressive", "interlaced"):
        make = make_interlaced_pipeline if case == "interlaced" else make_pipeline
        _, _, rt = make(make_plan(ALL_STANDARDS["ntsc"](), 720), "comb3d", "kernel", dev)
        rgb = _scene(480, dev)
        rt(rgb, 0)

        def call():
            return rt(rgb, 3)
    elif case == "burst-locked":
        plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
        enc, _, _ = make_pipeline(plan, "notch", "kernel", dev, raster=True)
        rast = enc(_scene(480, dev), 0)
        rp = raster.make_raster(plan)
        g = frame_line_index(plan, 0, 16, 480, dev)

        def call():
            return raster.decode_burst_locked(plan, rp, rast, g, "notch")
    else:
        plan = make_plan(SECAM(), 720).to(dev)
        g = frame_line_index(plan, 0, 16, 2, dev)

        def call():
            return secam.ident_lines(plan, g)
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_temporal_nr_estimator_above_2_pow_24(dev):
    """sigma=None takes the lower quartile of a motion metric with more than
    2^24 elements (torch.quantile refuses those): the sort-based quartile
    against NumPy, and the denoising gain on a noisy static scene."""
    from color_modem_tpu_torch.frame.nr import lower_quartile, temporal_nr

    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.rand(2**24 + 2**20, generator=gen, device=dev)
    ref = np.percentile(d.cpu().numpy().astype(np.float64), 25.0)
    assert abs(float(lower_quartile(d)) - ref) <= 1e-6
    clean = torch.tensor(np.broadcast_to(smooth_scene(576, 720, seed=0), (48, 3, 576, 720)),
                         dtype=torch.float32, device=dev)
    noisy = clean + 0.02 * torch.randn(clean.shape, generator=gen, device=dev)
    out = temporal_nr(noisy)
    assert bool(torch.isfinite(out).all())
    assert psnr(out, clean) - psnr(noisy, clean) > 2.5


def test_global_tf32_changes_nothing(dev):
    """TF32 switched on for the whole process (``allow_tf32`` and the
    "high" matmul precision): the kernel-vs-plain bounds and the NTSC comb3
    and SECAM interp PSNRs hold, since the port pins its own products."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        _kernel_vs_plain(dev, "ntsc", 16, 480, 720, "comb3")
        _secam_kernel_vs_plain(dev, 4, 576, 720)
        test_main_path_roundtrip(dev)
        test_secam_roundtrip_one_launch_each(dev)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_cpu_noisy_manifest_resumes_on_the_card(dev, tmp_path):
    """A noisy run begun on the CPU resumes on the card: both draw JAX's
    noise and record its keying, and the card's own run saves the CPU's
    frames (to the decode bound); a manifest of the old per-device keying
    is refused."""
    from color_modem_tpu_torch.frame.video import process_video

    one = smooth_scene(16, 720, seed=1).astype(np.float32)
    src = lambda start, count: np.broadcast_to(one, (count,) + one.shape)  # noqa: E731
    plan = make_plan(ALL_STANDARDS["ntsc"](), 720)
    kw = dict(decoder="notch", chunk=1, channel={"noise_sigma": 0.02}, save_outputs=True)
    d_cpu, d_card = str(tmp_path / "cpu"), str(tmp_path / "card")
    s = process_video(plan, src, 2, d_cpu, device="cpu", **kw)
    assert s["noise_keying"] == "abs-frame"
    assert process_video(plan, src, 2, d_cpu, device=dev, **kw)["frames_processed_this_run"] == 0
    process_video(plan, src, 2, d_card, device=dev, **kw)
    for i in range(2):
        a, b = (np.load(f"{d}/rgb_{i:06d}.npy") for d in (d_cpu, d_card))
        assert float(np.abs(a - b).max()) <= DEC_ATOL
    path = f"{d_cpu}/manifest.json"
    with open(path) as f:
        m = json.load(f)
    m["config"]["noise_keying"] = "abs-frame-torch-cpu"
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="refusing to resume"):
        process_video(plan, src, 2, d_cpu, device=dev, **kw)


@pytest.mark.parametrize("first", ["cpu", "cuda"])
def test_pipelines_on_two_devices_share_one_plan(dev, first):
    """A card pipeline still runs after a CPU pipeline is built from the
    same plan, and the other way round; the plan stays where it was."""
    plan = make_plan(SECAM(), 720)
    if first == "cuda":
        plan = plan.to(dev)
    home = plan.mix_cos.device
    _, _, rt_card = make_pipeline(plan, "interp", "kernel", dev)
    _, _, rt_cpu = make_pipeline(plan, "interp", "kernel", "cpu")
    rgb = torch.tensor(np.broadcast_to(smooth_scene(16, 720, seed=0), (2, 3, 16, 720)),
                       dtype=torch.float32)
    reset_launches()
    out = rt_card(rgb.to(dev), 0)
    torch.cuda.synchronize()
    _assert_launched(secam_encode=1, secam_decode=1)
    assert float((out.cpu() - rt_cpu(rgb, 0)).abs().max()) <= DEC_ATOL
    assert plan.mix_cos.device == home


def _hops(dev):
    """The transmission layer's calls at 16 x 480 x 720 (MAC 16 x 576 x 720),
    each with its input on the card."""
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.frame.equalize import (
        apply_equalizer,
        design_equalizer,
        gcr_record,
    )
    from color_modem_tpu_torch.frame.raster import make_raster
    from color_modem_tpu_torch.frame.timebase import impair_timebase, tbc_correct
    from color_modem_tpu_torch.modem import mac
    from color_modem_tpu_torch.utils import prng

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    comp = make_pipeline(plan, "notch", "kernel", dev)[0](_scene(480, dev), 0)
    rfp = rf_mod.make_rf_plan(plan)
    sp = sat_mod.make_sat_plan(plan.fs, 720)
    mplan = mac.make_mac_plan(720)
    g = frame_line_index(plan, 0, 16, 576, dev)
    mrgb = _scene(576, dev)
    rx = torch.tensor(gcr_record(plan), device=dev)
    ras = make_pipeline(plan, "comb3", "kernel", dev, raster=True)[0](_scene(480, dev), 0)
    shifted, _ = impair_timebase(plan, ras, wobble_us=0.3)
    g_r = frame_line_index(plan, 0, 16, 480, dev)
    return {
        "rf": lambda: rf_mod.rf_roundtrip(rfp, comp, 3),
        "satellite": lambda: sat_mod.sat_roundtrip(sp, comp),
        "satellite-awgn": lambda: sat_mod.sat_roundtrip(sp, comp, None, prng.PRNGKey(11), 12.0),
        "d2mac": lambda: mac.decode_data(mplan, mac.encode(mplan, mrgb, g))[1],
        "equalizer": lambda: apply_equalizer(comp, design_equalizer(plan, rx, ntaps=411)),
        "tbc": lambda: tbc_correct(plan, make_raster(plan), shifted, g_r),
    }


@pytest.mark.parametrize("hop", ["rf", "satellite", "satellite-awgn", "d2mac", "equalizer",
                                 "tbc"])
def test_hop_never_blocks_the_host(dev, hop):
    """The transmission layer enqueues without waiting for the card: its
    composed taps, kernel spectra and carrier tables are built and uploaded
    once (the first call), not per call."""
    call = _hops(dev)[hop]
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("hop,atol", [("rf", 1e-5), ("satellite", 5e-4), ("d2mac", 1e-5)])
def test_hop_matches_the_cpu(dev, hop, atol):
    """Each hop on the card against the same call on the CPU (float32 FFT
    rounding; the FM phase carries it to ~1e-4)."""
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.modem import mac

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720)
    rgb = torch.tensor(np.stack([smooth_scene(48, 720, seed=s) for s in range(3)]),
                       dtype=torch.float32)
    if hop == "d2mac":
        mplan = mac.make_mac_plan(720)
        g = torch.arange(48)
        fn = lambda x: mac.roundtrip(mplan, x, g.to(x.device))  # noqa: E731
        x = rgb
    else:
        x = make_pipeline(plan, "notch", "kernel", "cpu")[0](rgb, 0)
        if hop == "rf":
            rfp = rf_mod.make_rf_plan(plan)
            fn = lambda c: rf_mod.rf_roundtrip(rfp, c, 5)  # noqa: E731
        else:
            sp = sat_mod.make_sat_plan(plan.fs, 720)
            fn = lambda c: sat_mod.sat_roundtrip(sp, c)  # noqa: E731
    assert float((fn(x.to(dev)).cpu() - fn(x)).abs().max()) <= atol


def test_agc_quantile_above_2_pow_24(dev):
    """Sync-tip AGC on 48 rastered frames (19.8e6 samples, where
    torch.quantile refuses): the sort-based quantile against NumPy's, and
    the 0.7x gain error recovered."""
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame.raster import make_raster

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    rgb = torch.tensor(np.broadcast_to(smooth_scene(480, 720, seed=0), (48, 3, 480, 720)),
                       dtype=torch.float32, device=dev)
    comp = make_pipeline(plan, "notch", "kernel", dev, raster=True)[0](rgb, 0)
    assert comp.numel() > 2**24
    rfp = rf_mod.make_rf_plan(plan, row_samples=make_raster(plan).n_total)
    weak = 0.7 * rf_mod.rf_modulate(rfp, comp, 0)
    env = torch.rand(3, 2**23 + 17, generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    np.testing.assert_allclose(rf_mod._row_quantile(env, 0.975).cpu().numpy(),
                               np.quantile(env.double().cpu().numpy(), 0.975, axis=-1),
                               rtol=0, atol=1e-6)
    out = rf_mod.rf_demodulate(rfp, weak, 0, agc=True)
    assert psnr(out[:, 2:-2], comp[:, 2:-2]) >= 40.0


def test_video_hops_on_the_card(dev, tmp_path):
    """process_video through the RF hop and the satellite hop (clean and
    at 12 dB CNR, where the discriminator carries the FFTs' batch-dependent
    last bits further), and the noisy channel, on the card: chunk sizes 2
    and 3 agree, and the noisy manifest records JAX's keying."""
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    src = synthetic_device_source(64, 720, seed=2, device=dev)
    for i, (kw, atol) in enumerate((({"rf": True}, 1e-5), ({"satellite": True}, 1e-5),
                                    ({"satellite": True, "sat_cnr": 12.0}, 2e-3),
                                    ({"channel": {"noise_sigma": 0.02}}, 1e-6))):
        outs = []
        for chunk in (2, 3):
            d = str(tmp_path / f"{i}_{chunk}")
            s = process_video(plan, src, 6, d, decoder="comb3", chunk=chunk,
                              save_outputs=True, device=dev, **kw)
            assert s["frames_processed_this_run"] == 6
            outs.append(np.concatenate([np.load(f"{d}/rgb_{i:06d}.npy")
                                        for i in range(0, 6, chunk)]))
        assert float(np.abs(outs[0] - outs[1]).max()) <= atol
    assert s["noise_keying"] == "abs-frame"


def _sound_chains(dev):
    """The sound layer's calls at full width (NTSC 16 x 480 x 720, PAL
    16 x 576 x 720 for A2, MAC 16 x 576 lines), on ``dev``; the inputs are
    made on the host, so the card and the CPU get the same numbers."""
    from color_modem_tpu_torch.frame import a2, mts, nicam
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.modem import mac

    def tone(f, amp, n, fs):
        return torch.tensor((amp * np.sin(2 * np.pi * f * np.arange(n) / fs)).astype(np.float32),
                            device=dev)

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    comp = make_pipeline(plan, "notch", "kernel", dev)[0](_scene(480, dev), 0)
    rfp = rf_mod.make_rf_plan(plan)
    audio = (tone(1000, 0.6, 16 * 480 * 720, plan.fs)
             + tone(7000, 0.3, 16 * 480 * 720, plan.fs)).reshape(16, 480 * 720)
    rf = rf_mod.rf_modulate(rfp, comp, 0)
    cap = nicam.nicam_capacity(rfp, rf.shape)
    nl, nr = tone(800, 0.5, 32 * cap, 32000.0), tone(2300, 0.5, 32 * cap, 32000.0)
    with_nicam = nicam.nicam_on_rf(rfp, rf_mod.sound_on_rf(rfp, rf, 0, audio, 0.0), nl, nr)
    rfp50 = rf_mod.make_rf_plan(plan, audio_bw=50e3)
    pal = make_plan(ALL_STANDARDS["pal"](), 720).to(dev)
    pcomp = make_pipeline(pal, "delayline", "kernel", dev)[0](_scene(576, dev), 0)
    prfp = rf_mod.make_rf_plan(pal)
    a2p = a2.make_a2_plan(prfp)
    pl = tone(800, 0.6, 576 * 720, pal.fs).expand(16, -1)
    pr = tone(2300, 0.5, 576 * 720, pal.fs).expand(16, -1)
    a2_rf = a2.a2_on_rf(a2p, rf_mod.rf_modulate(prfp, pcomp, 0, 0.5 * (pl + pr)), 0, pr, "stereo")
    sp = sat_mod.make_sat_plan(plan.fs, 720, audio_subs=2)
    sub = torch.stack([audio, 0.5 * audio], dim=1)
    mplan = mac.make_mac_plan(720)
    g = frame_line_index(plan, 0, 16, 576, dev)
    mrgb = _scene(576, dev)
    n_f = mac.sound_capacity(mplan, 16 * 576)
    ml = tone(440, 0.7, 32 * n_f, 32000.0)

    def mac_sound():
        payload, _ = mac.pack_sound(mplan, ml, ml, 16 * 576)
        bits = mac.decode_data(mplan, mac.encode(mplan, mrgb, g, payload.reshape(16, 576, -1)))[1]
        return mac.unpack_sound(mplan, bits, n_f)[0]

    return {
        "rf-sound": lambda: rf_mod.sound_from_rf(rfp, rf_mod.sound_on_rf(rfp, rf, 0, audio, 1.5), 0),
        "rf-sound-per-item": lambda: rf_mod.rf_roundtrip(rfp, comp, 3, audio)[1],
        "nicam": lambda: nicam.nicam_from_rf(rfp, with_nicam, cap)[0],
        "mts": lambda: mts.mts_decode(plan, rf_mod.rf_demodulate_sound(
            rfp50, rf_mod.rf_modulate(rfp50, comp, 0, mts.mts_encode(plan, audio, audio)), 0))[0],
        "a2": lambda: a2._decode_arrays(a2p, a2_rf, 0)[1],
        "sat-sound": lambda: sat_mod.fm_demodulate_audio(sp, sat_mod.fm_modulate(sp, comp,
                                                                                 audio=sub)),
        "mac-sound": mac_sound,
    }


SOUND = ["rf-sound", "rf-sound-per-item", "nicam", "mts", "a2", "sat-sound", "mac-sound"]


@pytest.mark.parametrize("chain", SOUND)
def test_sound_never_blocks_the_host(dev, chain):
    """The sound layer enqueues without waiting for the card once its taps,
    spectra and tables are uploaded (the first call): NICAM's FAW search
    and the A2 fit stay on the device."""
    call = _sound_chains(dev)[chain]
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("chain", SOUND)
def test_sound_matches_the_cpu(dev, chain):
    """Each chain on the card against the same call on the CPU: float32 FFT
    and scan rounding (the NICAM and MAC audio come back bit for bit)."""
    atol = {"nicam": 0.0, "mac-sound": 0.0, "a2": 1e-3, "sat-sound": 1e-3}.get(chain, 1e-4)
    got = _sound_chains(dev)[chain]().cpu()
    want = _sound_chains(torch.device("cpu"))[chain]()
    assert float((got - want).abs().max()) <= atol


def test_a2_decode_fetches_once(dev):
    """a2_decode's one stacked fetch is its only host sync, and its modes
    are the CPU's."""
    import warnings

    from color_modem_tpu_torch.frame import a2, rf as rf_mod

    pal = make_plan(ALL_STANDARDS["pal"](), 720).to(dev)
    comp = make_pipeline(pal, "delayline", "kernel", dev)[0](_scene(576, dev)[:2], 0)
    prfp = rf_mod.make_rf_plan(pal)
    a2p = a2.make_a2_plan(prfp)
    t = torch.arange(576 * 720, device=dev) / pal.fs
    left = (0.6 * torch.sin(2 * np.pi * 800 * t)).expand(2, -1).contiguous()
    right = (0.5 * torch.sin(2 * np.pi * 2300 * t)).expand(2, -1).contiguous()
    rf = a2.a2_on_rf(a2p, rf_mod.rf_modulate(prfp, comp, 0, left), 0, right, "dual")
    a2.a2_decode(a2p, rf, 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            gl, gr, info = a2.a2_decode(a2p, rf, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [c for c in caught if "synchronizing CUDA" in str(c.message)]
    assert len(syncs) == 1, [str(c.message) for c in syncs]
    assert info["mode"] == ["dual", "dual"] == a2.a2_decode(a2p, rf.cpu(), 0)[2]["mode"]
    assert gl.device.type == "cuda"


def test_line_bits_on_the_card_payload(dev):
    from color_modem_tpu_torch.modem import mac

    mplan = mac.make_mac_plan(720)
    bits = mac.line_bits(mplan, torch.ones(4, 99, dtype=torch.int32, device=dev), (4,))
    assert bits.device.type == "cuda" and int(bits[:, -1].sum()) == 4
    assert mac.line_bits(mplan, None, (4,)).device.type == "cuda"


def test_video_rf_audio_on_the_card(dev, tmp_path):
    """process_video with a soundtrack on the card: one synchronising
    operation per wave (the stacked fetch, audio included), chunk sizes 2
    and 3 agree to 1e-4 on the audio, progressive and interlaced."""
    import glob
    import warnings

    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    src = synthetic_device_source(64, 720, seed=2, device=dev)
    t = np.arange(6 * 64 * 720) / plan.fs
    aud = (0.5 * np.sin(2 * np.pi * 700 * t) + 0.3 * np.sin(2 * np.pi * 4000 * t)).astype(
        np.float32)
    for interlaced in (False, True):
        outs = []
        for chunk in (2, 3):
            d = str(tmp_path / f"{interlaced}_{chunk}")
            process_video(plan, src, 6, d, decoder="comb3", chunk=chunk, device=dev, rf=True,
                          rf_audio=aud, interlaced=interlaced)
            outs.append(np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/aud_*.npy"))]))
        assert outs[0].shape == aud.shape
        assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-4
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            process_video(plan, src, 6, str(tmp_path / "sync"), decoder="comb3", chunk=2,
                          device=dev, rf=True, rf_audio=aud)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(c.message) for c in caught if "synchronizing CUDA" in str(c.message)]
    assert len(syncs) == 1, syncs


#: phase 4i's service chains (chip_smoke.py::service_chains), at 2 frames of
#: 64 lines here
SERVICES = ["caption", "teletext-wss-vitc", "scramble cutrotate", "scramble linedelay active",
            "scramble shuffle", "scramble roundtrip", "vir", "palplus progressive",
            "palplus interlaced raster"]


def _service_chains(device):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.service_chains(torch.device(device), 2, 64, 64)


def test_upload_on_the_card(dev):
    """``utils/upload.py`` on the card: a read-only float64 array and a
    broadcast view arrive as float32 with the same values, the copy blocks
    no host thread, and the caller's memory is left as it was."""
    from color_modem_tpu_torch.utils.upload import upload

    base = np.random.default_rng(0).standard_normal((4, 480, 720))
    ro = base.copy()
    ro.flags.writeable = False
    view = np.broadcast_to(base[:1], base.shape)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [upload(a, dev, np.float32) for a in (ro, view)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, a in zip(got, (ro, view)):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        assert torch.equal(g.cpu(), torch.from_numpy(a.astype(np.float32)))
    assert np.array_equal(ro, base)


@pytest.mark.parametrize("name", SERVICES)
def test_data_services_never_block_the_host(dev, name):
    """Captions, teletext, WSS, VITC, scrambling, VIR and PALplus on the
    card: no host-blocking operation once their tables are uploaded, and
    the chain's launches of the QAM kernels."""
    call, want = _service_chains(dev)[0][name]
    call()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _assert_launched(qam_encode=want.get("qam_encode", 0), qam_decode=want.get("qam_decode", 0))


@pytest.mark.parametrize("name", SERVICES)
def test_data_services_match_the_cpu(dev, name):
    """The same chain on the card and on the CPU: every bit and score equal,
    floats to the decode bound."""
    got = _service_chains(dev)[0][name][0]()
    want = _service_chains("cpu")[0][name][0]()
    for key in got:
        if got[key].dtype.is_floating_point:
            assert float((got[key].cpu() - want[key]).abs().max()) <= DEC_ATOL, key
        else:
            assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.parametrize("form", ["palplus progressive", "palplus interlaced raster"])
def test_palplus_kernels_match_plain(dev, form):
    """The letterbox rows run the _shared QAM kernels, never a bar row: the
    kernel backend agrees with the plain one on the card."""
    chains, inp = _service_chains(dev)
    enc_p, dec_p, _ = inp["palplus"][form]["plain"]
    out = chains[form][0]()
    with torch.inference_mode():
        assert float((out["comp"] - enc_p(inp["rgb_p"], 0)).abs().max()) <= ENC_ATOL
        assert float((out["helper"] - dec_p(out["comp"], 0)).abs().max()) <= DEC_ATOL


def test_video_services_on_the_card(dev, tmp_path):
    """process_video with captions and cut-and-rotate through the RF hop on
    the card: the cells exact, chunk sizes 2 and 3 alike to 1e-5, one
    synchronising operation per wave (the caption cells ride the fetch)."""
    import glob
    import warnings

    from color_modem_tpu_torch.frame.vbi import cc_pack
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    src = synthetic_device_source(64, 720, seed=2, device=dev)
    text = "CARD CAPTION"
    bits = np.stack([cc_pack(text[2 * i : 2 * i + 2]).numpy() for i in range(6)])
    kw = dict(decoder="comb3", device=dev, rf=True, caption_bits=bits,
              scramble=("cutrotate", 0xC0FFEE), save_outputs=True)
    outs = []
    for chunk in (2, 3):
        d = str(tmp_path / f"c{chunk}")
        process_video(plan, src, 6, d, chunk=chunk, **kw)
        cells = np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/cc_*.npy"))])
        assert np.array_equal(cells, bits)
        outs.append(np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/rgb_*.npy"))]))
    assert float(np.abs(outs[0] - outs[1]).max()) <= 1e-5
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            process_video(plan, src, 6, str(tmp_path / "sync"), chunk=2,
                          **{**kw, "save_outputs": False})
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(c.message) for c in caught if "synchronizing CUDA" in str(c.message)]
    assert len(syncs) == 1, syncs


# --- the parallel layer: ranks sharing the card ------------------------------


@pytest.fixture(scope="module")
def two_gloo_ranks(dev, tmp_path_factory):
    """NTSC comb3 at 4x3x480x720 on 2 gloo ranks, both computing on the card
    (NCCL refuses two ranks on one GPU), on the (2,1) and (1,2) meshes; the
    round trip run a second time with every host-blocking CUDA operation
    an error outside the halo exchange's host staging."""
    from color_modem_tpu_torch.parallel import multihost as mh

    cases = [dict(mh._case("pipeline", "ntsc", "comb3", ms, 4, 480, seed=0, broadcast=True,
                           frame0=0), sync_debug=True) for ms in [(2, 1), (1, 2)]]
    return mh.launch(cases, 2, backend="gloo", outdir=str(tmp_path_factory.mktemp("ranks")),
                     timeout=600.0)


def test_two_gloo_ranks_on_the_card_equal_unsharded(two_gloo_ranks):
    for k in range(2):
        r0 = two_gloo_ranks[0][k]
        assert r0["err"] == {"rt": 0.0, "enc": 0.0, "dec": 0.0}, r0
        assert abs(r0["psnr"] - 46.62) <= 0.02
        for rr in two_gloo_ranks:
            assert rr[k]["device"] == "cuda:0"
            assert rr[k]["launches"] == {"qam_encode": 1, "qam_decode": 1, "secam_encode": 0,
                                         "secam_decode": 0, "threefry_bits": 0,
                                         "threefry_add_normal": 0, "colour_matrix": 2,
                                         "delayline_matrix": 0, "comb_stencil": 1,
                                         "fir_check": 0, "band_fir_check": 0}


def test_sharded_decode_blocks_the_host_only_in_the_halo_staging(two_gloo_ranks):
    assert all(r["sync_debug"] for rr in two_gloo_ranks for r in rr)


def test_nccl_refuses_more_ranks_than_cards(dev, monkeypatch):
    from color_modem_tpu_torch.parallel import mesh

    n = torch.cuda.device_count() + 1
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n))
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.init_distributed("nccl")
    assert not torch.distributed.is_initialized()


def test_bench_main_path_on_the_card(dev, tmp_path, monkeypatch, capsys):
    import json

    from color_modem_tpu_torch import benchmark

    monkeypatch.chdir(tmp_path)
    benchmark.main(["--roofline"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"} and line["value"] > 0
    with open(tmp_path / "results" / "bench_ntsc_comb3_kernel.json") as f:
        rec = json.load(f)
    assert rec["shape"] == [16, 480, 720] and rec["device"] == "cuda"
    assert abs(rec["roundtrip_psnr_db"] - 46.62) <= 0.02
    assert rec["kernel_launches"] == {"qam_encode": 1, "qam_decode": 1, "secam_encode": 0,
                                      "secam_decode": 0, "threefry_bits": 0,
                                      "threefry_add_normal": 0, "colour_matrix": 2,
                                      "delayline_matrix": 0, "comb_stencil": 1,
                                      "fir_check": 0, "band_fir_check": 0}
    for share in ("tflops_fraction_of_f32_peak", "hbm_fraction_of_peak"):
        assert 0.0 < rec["roofline"][share] <= 1.05, rec["roofline"]


def test_dryrun_multichip_on_the_card(dev, tmp_path):
    from color_modem_tpu_torch.entry import dryrun_multichip

    recs = dryrun_multichip(2, outdir=str(tmp_path))
    assert {r["device"] for r in recs} == {"cuda:0"}
    assert {r["name"] for r in recs} >= {"step:ntsc/comb3", "step:ntsc/comb3d"}


@pytest.mark.parametrize("shape", [(3, 65, 722), (1, 481, 1440)])
def test_sanitizer_on_every_kernel(dev, shape):
    """``kernels/sanitize.py`` at two of chip_smoke.py phase 3c's shapes:
    every kernel row's poisoned build equal to the normal one bit for bit,
    no NaN, every guard and input intact, every output sample written, 20
    launches identical; the wrappers' launch counts do not move."""
    from color_modem_tpu_torch.kernels import launch_counts, reset_launches
    from color_modem_tpu_torch.kernels import sanitize

    frames, lines, n = shape
    reset_launches()
    results = sanitize.run_all(dev, lines=(lines,), samples=(n,), frames=(frames,))
    rows = (len(sanitize.ROWS) + len(sanitize.PRNG_ROWS) + len(sanitize.COLOUR_ROWS)
            + len(sanitize.COMB_ROWS))
    assert len(results) == rows
    bad = [(r["row"], r["standard"], r["shape"], {k: v for k, v in r.items() if k != "poison"},
            r["poison"]) for r in results if not r["ok"]]
    assert not bad, bad
    assert all(r["max_poison_diff"] == 0.0 for r in results)
    assert set(launch_counts().values()) == {0}


def test_checked_names_a_kernel_nan_on_the_card(dev):
    """A NaN in a kernel's output reaches ``checked`` through the wrappers'
    hook, named as the kernel's."""
    from color_modem_tpu_torch.utils.debug import checked

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    ycc = torch.zeros((1, 3, 16, 720), device=dev)
    ycc[0, 1, 3, 100] = float("nan")
    cols = qk.phase_cols(plan, frame_line_index(plan, 0, 1, 16, dev))

    def encode(x):
        return torch.nan_to_num(qk.encode_lines(plan, x, cols))

    with pytest.raises(FloatingPointError, match="the CUDA kernel qam_encode made a NaN"):
        checked(encode)(ycc)


# --- the threefry generator (csrc/threefry.cu) ---------------------------------------------

#: normals of the kernel against the plain version (and the CPU's): the
#: ``log1p`` of each library, an ulp or two of the draw
NORMAL_ATOL = 1e-6


def _threefry_cases():
    """(label, key, shape, g0) of the kernel's normal: the runner's
    satellite noise on 16 NTSC frames at r = 4 keyed per frame from index
    37, one key over a block, odd shapes and an index range that wraps."""
    from color_modem_tpu_torch.utils.prng import PRNGKey

    return (("runner 16x480x2880", PRNGKey(0x5A7), (16, 480, 2880), 37),
            ("one key 2x481x722", PRNGKey(1), (2, 481, 722), None),
            ("odd 3x7x5", PRNGKey(0), (3, 7, 5), 2**32 - 2),
            ("one item 1x1", PRNGKey(11), (1, 1), 5))


@pytest.mark.parametrize("case", range(4))
def test_threefry_add_normal_matches_plain(dev, case):
    """x + sigma * normal on the card against the plain version on the card
    (and on the CPU at the small shapes), per-item ``fold_in`` included;
    one launch each; the normal alone equals it with x = 0, sigma = 1."""
    from color_modem_tpu_torch.kernels import prng as pk
    from color_modem_tpu_torch.utils import prng

    label, key, shape, g0 = _threefry_cases()[case]
    x = torch.tensor(np.random.default_rng(case).uniform(-1, 1, shape).astype(np.float32),
                     device=dev)
    reset_launches()
    got = prng.add_normal(x, 0.05, key, g0)
    _assert_launched(threefry_bits=0, threefry_add_normal=1)
    want = prng.add_normal_plain(x, 0.05, key, shape, dev, g0)
    assert float((got - want).abs().max()) <= NORMAL_ATOL, label
    n = pk.threefry_add_normal(None, 1.0, key, shape, dev, g0)
    n_plain = prng.add_normal_plain(None, 1.0, key, shape, dev, g0)
    assert float((n - n_plain).abs().max()) <= NORMAL_ATOL, label
    assert bool(torch.isfinite(n).all())
    if n.numel() >= 2**20:
        assert abs(float(n.double().std()) - 1.0) < 1e-3, label
    if got.numel() <= 2**22:
        cpu = prng.add_normal_plain(x.cpu(), 0.05, key, shape, "cpu", g0)
        assert float((got.cpu() - cpu).abs().max()) <= NORMAL_ATOL, label


@pytest.mark.parametrize("shape", [(1 << 20,), (3, 17, 41), (1,)])
def test_threefry_bits_match_plain_and_the_cpu(dev, shape):
    from color_modem_tpu_torch.utils import prng

    key = prng.fold_in(prng.PRNGKey(0x5A7), 3)
    reset_launches()
    got = prng.random_bits(key, shape, dev)
    _assert_launched(threefry_bits=1, threefry_add_normal=0)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    assert torch.equal(got, prng.random_bits_plain(key, shape, dev))
    assert torch.equal(got.cpu(), prng.random_bits_plain(key, shape, "cpu"))


def test_threefry_on_the_card_gives_jax_numbers(dev):
    """The card against values taken from ``jax.random`` on the CPU
    (chip_smoke.py's JAX_PINNED, which tests/test_torch_prng.py holds to
    ``jax.random`` where JAX is installed)."""
    import chip_smoke

    chip_smoke.check_jax_pinned(dev)


def test_rf_dropout_draws_on_the_card(dev):
    """bernoulli and randint at rf_dropout's shape from the bits kernel:
    the card equals the CPU, three launches (one bernoulli, two randint
    halves)."""
    from color_modem_tpu_torch.utils import prng

    k1, k2 = prng.split(prng.PRNGKey(7))
    reset_launches()
    hit = prng.bernoulli(k1, 0.05, (2, 480), dev)
    start = prng.randint(k2, (2, 480), 0, 2880 - 1231, dev)
    _assert_launched(threefry_bits=3, threefry_add_normal=0)
    assert torch.equal(hit.cpu(), prng.bernoulli(k1, 0.05, (2, 480), "cpu"))
    assert torch.equal(start.cpu(), prng.randint(k2, (2, 480), 0, 2880 - 1231, "cpu"))


def test_noise_never_blocks_the_host(dev):
    """Keys are host ints: drawing noise on the card takes no synchronising
    operation."""
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.utils import prng

    x = torch.zeros((4, 64, 720), device=dev)
    rfp = rf_mod.make_rf_plan(make_plan(ALL_STANDARDS["ntsc"](), 720))
    rf = torch.ones((1, 64, rfp.n_rf), device=dev)
    calls = (lambda: prng.add_normal(x, 0.1, prng.PRNGKey(0), 12),
             lambda: rf_mod.rf_dropout(rfp, rf, 7, rate=0.2))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
