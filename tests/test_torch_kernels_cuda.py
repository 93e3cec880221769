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

import numpy as np
import pytest
import torch

from color_modem_tpu_torch import ALL_STANDARDS, SECAM
from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, clamp01
from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
from color_modem_tpu_torch.kernels import fir as fk
from color_modem_tpu_torch.kernels import qam as qk
from color_modem_tpu_torch.kernels import secam as sk
from color_modem_tpu_torch.modem import secam
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.separate.comb import stencil_signal
from color_modem_tpu_torch.utils.metrics import psnr
from color_modem_tpu_torch.utils.testimages import smooth_scene

pytestmark = pytest.mark.cuda

ENC_ATOL, DEC_ATOL = 2e-5, 5e-4
SECAM_ENC_ATOL = 2e-4


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
    qk.reset_launches()
    comp_k = qk.encode_lines(plan, ycc, cols)
    comp_p = qk.encode_lines_plain(plan, ycc, cols)
    sep = stencil_signal(plan, comp_p, decoder)
    dec_k = qk.decode_lines(plan, sep, comp_p, cols)
    dec_p = qk.decode_lines_plain(plan, sep, comp_p, cols)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 1, "qam_decode": 1}
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


def test_main_path_roundtrip(dev):
    plan = make_plan(ALL_STANDARDS["ntsc"](), 720)
    one = smooth_scene(480, 720, seed=0)
    rgb = torch.tensor(np.broadcast_to(one, (16, 3, 480, 720)), dtype=torch.float32,
                       device=dev)
    _, _, rt = make_pipeline(plan, "comb3", backend="kernel", device=dev)
    qk.reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 1, "qam_decode": 1}
    assert abs(psnr(out, rgb) - 46.62) <= 0.02


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
    fk.LAUNCHES["fir_check"] = 0
    got = fk.fir_lines(torch.tensor(x, device=dev),
                       torch.tensor(taps, dtype=torch.float32, device=dev), held)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fir_check"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("lines", [1, 17, 7681])
@pytest.mark.parametrize("n", [61, 97, 720, 722, 1440])
@pytest.mark.parametrize("ntaps", [31, 129, 259])
def test_band_fir_against_np_convolve(dev, ntaps, n, lines):
    """csrc/band_fir.cuh alone (three TF32 passes on the tensor cores)
    against np.convolve(mode='same') on random asymmetric taps, <= 2e-6:
    taps longer than the line, widths that are not multiples of 4 or 8,
    lines cut into spans, and 1, 17 and 7681 lines (ragged last tiles of
    16)."""
    rng = np.random.default_rng(ntaps * n + lines)
    taps = rng.normal(size=ntaps) / ntaps
    x = rng.normal(size=(lines, n)).astype(np.float32)
    h = (ntaps - 1) // 2
    ref = np.stack([np.convolve(np.pad(r.astype(np.float64), h), taps, "same")[h : h + n]
                    for r in x])
    fk.LAUNCHES["band_fir_check"] = 0
    got = fk.band_fir_lines(torch.tensor(x, device=dev),
                            torch.tensor(taps, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    assert fk.LAUNCHES["band_fir_check"] == 1
    np.testing.assert_allclose(got.cpu().numpy(), ref, atol=2e-6, rtol=0)


def _secam_rgb(plan, luma, v, gline, pairing="interp"):
    dr, db = secam.pair(v, gline, pairing)
    return clamp01(apply_mat3(plan.ycc_to_rgb, torch.stack([luma, dr, db], dim=-3)))


def _secam_kernel_vs_plain(dev, frames, lines, n, frame0=3):
    plan = make_plan(SECAM(), n).to(dev)
    gline = frame_line_index(plan, frame0, frames, lines, dev)
    isr = sk.isr_col(gline)
    rng = np.random.default_rng(n)
    rgb = np.stack([smooth_scene(lines, n, seed=s) for s in range(frames)])
    rgb = torch.tensor(rgb, dtype=torch.float32, device=dev)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb)
    chroma = rng.uniform(-0.6, 0.6, (frames, 2, lines, n))
    ycc_rand = torch.cat([ycc[:, :1], torch.tensor(chroma, dtype=torch.float32,
                                                   device=dev)], dim=1).contiguous()
    sk.reset_launches()
    comp_k = sk.encode_lines(plan, ycc_rand, isr)
    comp_p = sk.encode_lines_plain(plan, ycc_rand, isr)
    comp = sk.encode_lines_plain(plan, ycc.contiguous(), isr)
    luma_k, v_k = sk.demodulate_lines(plan, comp, isr)
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {"secam_encode": 1, "secam_decode": 1}
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
                                            (2, 33, 720)])
def test_secam_kernels_match_plain_at_odd_line_counts(dev, frames, lines, n):
    """One line, 17 lines and odd counts leave a ragged last tile of 8 lines
    in the tensor-core kernels; one launch each.  The demodulated luma and
    component are held directly (the line pairing needs two lines)."""
    plan = make_plan(SECAM(), n).to(dev)
    isr = sk.isr_col(frame_line_index(plan, 3, frames, lines, dev))
    rng = np.random.default_rng(lines)
    rgb = torch.tensor(np.stack([smooth_scene(max(lines, 2), n, seed=s)[:, :lines]
                                 for s in range(frames)]), dtype=torch.float32, device=dev)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb).contiguous()
    ycc_rand = torch.cat([ycc[:, :1], torch.tensor(rng.uniform(-0.6, 0.6, (frames, 2, lines, n)),
                                                   dtype=torch.float32, device=dev)],
                         dim=1).contiguous()
    sk.reset_launches()
    comp_k = sk.encode_lines(plan, ycc_rand, isr)
    comp = sk.encode_lines_plain(plan, ycc, isr)
    luma_k, v_k = sk.demodulate_lines(plan, comp, isr)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {"secam_encode": 1, "secam_decode": 1}
    e_enc = float((comp_k - sk.encode_lines_plain(plan, ycc_rand, isr)).abs().max())
    assert e_enc <= SECAM_ENC_ATOL
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    assert float((luma_k - luma_p).abs().max()) <= DEC_ATOL
    assert float((v_k - v_p).abs().max()) <= DEC_ATOL


def test_secam_roundtrip_one_launch_each(dev):
    plan = make_plan(SECAM(), 720)
    one = smooth_scene(576, 720, seed=0)
    rgb = torch.tensor(np.broadcast_to(one, (16, 3, 576, 720)), dtype=torch.float32,
                       device=dev)
    _, _, rt = make_pipeline(plan, "interp", backend="kernel", device=dev)
    sk.reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {"secam_encode": 1, "secam_decode": 1}
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
    qk.reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 1, "qam_decode": 1}
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
    qk.reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 1, "qam_decode": 0}
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
    qk.reset_launches()
    locked = raster.decode_burst_locked(plan, raster.make_raster(plan), bad, g, "notch")
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 0, "qam_decode": 1}
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
    qk.reset_launches()
    out = rt(rgb, 0)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 1, "qam_decode": 1}
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
    qk.reset_launches()
    out = conv(comp, 0)
    torch.cuda.synchronize()
    assert qk.LAUNCHES == {"qam_encode": 1, "qam_decode": 1}
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


def test_cpu_noisy_manifest_is_refused_on_the_card(dev, tmp_path):
    """A noisy run begun on the CPU (mt19937 noise) does not resume on the
    card (Philox noise): its manifest's keying names the device."""
    from color_modem_tpu_torch.frame.video import process_video

    one = smooth_scene(16, 720, seed=1).astype(np.float32)
    src = lambda start, count: np.broadcast_to(one, (count,) + one.shape)  # noqa: E731
    plan = make_plan(ALL_STANDARDS["ntsc"](), 720)
    kw = dict(decoder="notch", chunk=1, channel={"noise_sigma": 0.02})
    process_video(plan, src, 2, str(tmp_path), device="cpu", **kw)
    with pytest.raises(ValueError, match="refusing to resume"):
        process_video(plan, src, 2, str(tmp_path), device=dev, **kw)


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
    sk.reset_launches()
    out = rt_card(rgb.to(dev), 0)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {"secam_encode": 1, "secam_decode": 1}
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

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    comp = make_pipeline(plan, "notch", "kernel", dev)[0](_scene(480, dev), 0)
    rfp = rf_mod.make_rf_plan(plan)
    sp = sat_mod.make_sat_plan(plan.fs, 720)
    mplan = mac.make_mac_plan(720)
    g = frame_line_index(plan, 0, 16, 576, dev)
    mrgb = _scene(576, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    rx = torch.tensor(gcr_record(plan), device=dev)
    ras = make_pipeline(plan, "comb3", "kernel", dev, raster=True)[0](_scene(480, dev), 0)
    shifted, _ = impair_timebase(plan, ras, wobble_us=0.3)
    g_r = frame_line_index(plan, 0, 16, 480, dev)
    return {
        "rf": lambda: rf_mod.rf_roundtrip(rfp, comp, 3),
        "satellite": lambda: sat_mod.sat_roundtrip(sp, comp),
        "satellite-awgn": lambda: sat_mod.sat_roundtrip(sp, comp, None, gen, 12.0),
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
    last bits further) on the card: chunk sizes 2 and 3 agree, and the
    noisy manifest names the card's keying."""
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source

    plan = make_plan(ALL_STANDARDS["ntsc"](), 720).to(dev)
    src = synthetic_device_source(64, 720, seed=2, device=dev)
    for i, (kw, atol) in enumerate((({"rf": True}, 1e-5), ({"satellite": True}, 1e-5),
                                    ({"satellite": True, "sat_cnr": 12.0}, 2e-3))):
        outs = []
        for chunk in (2, 3):
            d = str(tmp_path / f"{i}_{chunk}")
            s = process_video(plan, src, 6, d, decoder="comb3", chunk=chunk,
                              save_outputs=True, device=dev, **kw)
            assert s["frames_processed_this_run"] == 6
            outs.append(np.concatenate([np.load(f"{d}/rgb_{i:06d}.npy")
                                        for i in range(0, 6, chunk)]))
        assert float(np.abs(outs[0] - outs[1]).max()) <= atol
    assert s["noise_keying"] == "abs-frame-torch-cuda"


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
