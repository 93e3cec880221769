"""Smoke test of the PyTorch/CUDA port (``color_modem_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits nonzero:

1. device: refuse to run without CUDA; print the card (nvidia-smi name and
   power limit) and ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``color_modem_tpu_torch/csrc`` (TF32 off);
3. each QAM kernel against its plain PyTorch version on the card: NTSC at
   16x480 lines, PAL and NIIR at 16x576 lines, 720 samples, seeded inputs;
3b. the shared FIR (``csrc/fir.cuh``) against ``np.convolve`` on asymmetric
   taps, zero and held edges; each SECAM kernel against its plain version at
   16x576x720 and 4x576x1440: encode <= 2e-4, decoded RGB <= 5e-4, and the
   raw demodulated component's error printed;
4. the main path, NTSC encode -> comb3 decode at 16x3x480x720 through
   ``make_pipeline(..., backend="kernel")``: round-trip PSNR 46.62 +- 0.02 dB,
   one launch of each kernel, agreement with the plain backend on the card
   and with the plain backend on the CPU on a small input;
4b. the SECAM path, encode -> interp/avg/notch decode at 16x3x576x720, the
   same way: PSNR 38.8644/33.3755/35.3157 +- 0.02 dB, one launch of each
   SECAM kernel per round trip, the same two agreements;
4c. the rest of the QAM family at full width (16 frames, 576 or 480 lines,
   720 samples): PAL/PAL-M/PAL-N/PAL-60, NIIR, NTSC-4.43 and the temporal
   and adaptive combs, each round trip's PSNR +- 0.02 dB, its launches
   (combA/comb3dA separate outside the decode kernel, as in the JAX
   package: 0 decode launches), the same two agreements;
4d. the raster and channel layers: sync/burst raster identities, channel
   phase and gain errors decoded nominally, burst-locked, with ACC and with
   PAL ident, and NIIR's reference normalisation against NTSC, each PSNR
   +- 0.02 dB;
5. CUDA-event times of the QAM kernels and of the round trip, against their
   plain versions; 5b. the same for the SECAM kernels and the SECAM interp
   round trip; 5c. the QAM kernels at PAL and NIIR shapes (the shared-filter
   case) and the PAL delayline and NIIR avg round trips.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PSNR_EXPECTED, PSNR_TOL = 46.62, 0.02
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4  # kernel vs plain (tests/test_kernels.py bounds)
SECAM_ENC_ATOL = 2e-4  # the phase scan sums in another order than torch.cumsum
FIR_ATOL = 1e-6        # fir.cuh vs np.convolve, taps normalised to sum |t| ~ 1
#: SECAM round-trip PSNR of smooth_scene(576, 720, seed=0) at frame 0, as the
#: JAX xla path computes it on the CPU; numbers of the algorithm, not the chip
SECAM_PSNR = {"interp": 38.8644, "avg": 33.3755, "notch": 35.3157}
BATCH, N = 16, 720
SECAM_LINES = 576
#: phase 4c: (standard, decoder) -> (round-trip PSNR, (encode, decode)
#: launches); smooth_scene(L, 720, seed=0) broadcast to 16 frames, frame 0,
#: as the JAX xla path computes it on the CPU
QAM_FAMILY = {
    ("pal", "delayline"): (37.9984, (1, 1)),
    ("pal", "comb3"): (41.5629, (1, 1)),
    ("niir", "notch"): (35.0172, (1, 1)),
    ("niir", "avg"): (33.1777, (1, 1)),
    ("ntsc", "comb3d"): (47.4153, (1, 1)),
    ("ntsc", "combA"): (45.5145, (1, 0)),
    ("pal", "comb3dA"): (47.8284, (1, 0)),
    ("ntsc443", "notch"): (40.8535, (1, 1)),
    ("pal60", "delayline"): (38.0900, (1, 1)),
    ("pal_m", "comb3"): (41.6066, (1, 1)),
    ("pal_n", "comb3"): (41.5596, (1, 1)),
}
#: phase 4d: PSNR of each channel check, the same input and reference
CHANNEL_PSNR = {
    "ntsc notch rastered, 25 deg: nominal": 27.3564,
    "ntsc notch rastered, 25 deg: burst-locked": 39.4822,
    "ntsc comb3 rastered, 25 deg: nominal": 27.6212,
    "ntsc comb3 rastered, 25 deg: burst-locked": 44.7578,
    "ntsc notch rastered, gain 0.5: nominal": 27.6220,
    "ntsc notch rastered, gain 0.5: burst-locked acc": 38.3355,
    "pal delayline rastered, 20 deg: nominal": 36.9924,
    "pal delayline rastered, 20 deg: burst-locked": 37.9350,
    "pal delayline rastered, 20 deg: identified on gline + 1": 37.9350,
    "niir notch, 25 deg gain 0.6": 34.7814,
    "niir avg, 25 deg gain 0.6": 33.0220,
    "ntsc notch, 25 deg gain 0.6": 26.7242,
}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_pair(plain, kernel) -> tuple[float, float]:
    """(plain ms, kernel ms), each the mean of two runs in the order
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def secam_rgb(plan, luma, v, gline, pairing="interp"):
    """RGB from a SECAM demodulator's (luma, v): pairing, colour matrix,
    clamp, as ``decode_block`` does after the kernel."""
    import torch

    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3, clamp01
    from color_modem_tpu_torch.modem import secam

    dr, db = secam.pair(v, gline, pairing)
    return clamp01(apply_mat3(plan.ycc_to_rgb, torch.stack([luma, dr, db], dim=-3)))


def check_fir(dev) -> float:
    """fir.cuh through csrc/fir_check.cu against np.convolve on random
    asymmetric taps (a mirrored FIR passes every symmetric QAM tap set)."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.kernels import fir as fk

    rng = np.random.default_rng(1)
    worst = 0.0
    for n, ntaps in ((720, 257), (97, 31), (61, 129)):
        taps = rng.normal(size=ntaps) / ntaps
        x = rng.normal(size=(64, n)).astype(np.float32)
        h = (ntaps - 1) // 2
        for held in (False, True):
            xp = np.pad(x.astype(np.float64), ((0, 0), (h, h)),
                        mode="edge" if held else "constant")
            ref = np.stack([np.convolve(r, taps, "same")[h : h + n] for r in xp])
            got = fk.fir_lines(torch.tensor(x, device=dev),
                               torch.tensor(taps, dtype=torch.float32, device=dev), held)
            torch.cuda.synchronize()
            e = float(np.abs(got.cpu().numpy() - ref).max())
            print(f"fir.cuh vs np.convolve n={n} taps={ntaps} "
                  f"{'held' if held else 'zero'} edge: max|err| {e:.3e} (<= {FIR_ATOL})")
            _check(e <= FIR_ATOL, f"fir.cuh disagrees with np.convolve: {e}")
            worst = max(worst, e)
    return worst


def check_secam_kernels(dev, frames: int, n: int) -> tuple[float, float]:
    """Both SECAM kernels against their plain versions at frames x 576 x n,
    first frame odd.  Returns (encode, decoded RGB) max abs errors."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import SECAM
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    plan = make_plan(SECAM(), n).to(dev)
    lines = SECAM_LINES
    gline = frame_line_index(plan, 3, frames, lines, dev)
    isr = sk.isr_col(gline)
    scenes = np.stack([smooth_scene(lines, n, seed=s) for s in range(4)])
    rgb = torch.tensor(scenes[np.arange(frames) % 4], dtype=torch.float32, device=dev)
    ycc = apply_mat3(plan.rgb_to_ycc, rgb).contiguous()
    rng = np.random.default_rng(n)
    chroma = torch.tensor(rng.uniform(-0.6, 0.6, (frames, 2, lines, n)),
                          dtype=torch.float32, device=dev)
    ycc_rand = torch.cat([ycc[:, :1], chroma], dim=1).contiguous()
    e_enc = _max_err(sk.encode_lines(plan, ycc_rand, isr),
                     sk.encode_lines_plain(plan, ycc_rand, isr))
    comp = sk.encode_lines(plan, ycc, isr)
    luma_k, v_k = sk.demodulate_lines(plan, comp, isr)
    luma_p, v_p = sk.demodulate_lines_plain(plan, comp, isr)
    e_rgb = _max_err(secam_rgb(plan, luma_k, v_k, gline), secam_rgb(plan, luma_p, v_p, gline))
    e_v = _max_err(v_k, v_p)
    comp_rand = sk.encode_lines(plan, ycc_rand, isr)
    e_v_rand = _max_err(sk.demodulate_lines(plan, comp_rand, isr)[1],
                        sk.demodulate_lines_plain(plan, comp_rand, isr)[1])
    torch.cuda.synchronize()
    print(f"kernel vs plain secam {frames}x{lines}x{n}: encode max|err| {e_enc:.3e} "
          f"(<= {SECAM_ENC_ATOL}), decode RGB max|err| {e_rgb:.3e} (<= {DEC_ATOL}); "
          f"raw v max|err| {e_v:.3e} on the scene, {e_v_rand:.3e} on random chroma "
          f"(reported, not bounded)")
    _check(e_enc <= SECAM_ENC_ATOL, f"secam encode kernel disagrees: {e_enc}")
    _check(e_rgb <= DEC_ATOL, f"secam decode kernel disagrees: {e_rgb}")
    return e_enc, e_rgb


def full_scene(lines: int, dev):
    """smooth_scene(lines, N, seed=0) broadcast to BATCH frames on ``dev``."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.utils.testimages import smooth_scene

    return torch.tensor(np.broadcast_to(smooth_scene(lines, N, seed=0), (BATCH, 3, lines, N)),
                        dtype=torch.float32, device=dev)


def check_qam_path(dev, name: str, decoder: str, expected: float,
                   launches: tuple[int, int]):
    """One QAM-family round trip at BATCH x 3 x L x N through the kernel
    backend (PSNR, launches, shape, finite values), against the plain
    backend on the card and on the CPU, stage by stage: the encodes on the
    same RGB (<= ENC_ATOL), the decodes on the same composite (<= DEC_ATOL),
    and the round trips (<= DEC_ATOL).

    combA/comb3dA: the round-trip difference is printed, not bounded.  Their
    blend weights divide by smoothed energies, and the smoother
    (``comb_sel_lpf``) has negative lobes, so a denominator can cross zero
    and turn a 1e-7 difference between two encodes into 1e-2 on a few
    samples (the JAX package's own xla and Pallas round trips differ so).
    Their decode runs the same plain code on both backends.  Returns the
    kernel and plain round trips."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import ADAPTIVE, temporal_comb_spacing
    from color_modem_tpu_torch.utils.metrics import psnr

    cfg = ALL_STANDARDS[name]()
    lines = cfg.active_lines
    rgb = full_scene(lines, dev)
    label = f"{name} {decoder} {BATCH}x3x{lines}x{N}"
    enc_k, dec_k, rt_k = make_pipeline(make_plan(cfg, N), decoder, "kernel", dev)
    qk.reset_launches()
    out = rt_k(rgb, 0)
    torch.cuda.synchronize()
    got = dict(qk.LAUNCHES)
    want = {"qam_encode": launches[0], "qam_decode": launches[1]}
    _check(got == want, f"{label}: launches {got}, expected {want}")
    _check(tuple(out.shape) == tuple(rgb.shape), f"{label}: output shape {tuple(out.shape)}")
    _check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    q = psnr(out, rgb)
    print(f"{label}: psnr {q:.4f} dB (expected {expected} +- {PSNR_TOL}), launches {got}")
    _check(abs(q - expected) <= PSNR_TOL, f"{label}: round-trip PSNR {q} dB")

    frames = 2 * temporal_comb_spacing(cfg) if decoder in ("comb3d", "comb3dA") else 2
    small = rgb[:frames, :, :64]
    for where, x, frame0, ref_dev in (("the card", rgb, 0, dev), ("the CPU", small, 7, "cpu")):
        enc_p, dec_p, rt_p = make_pipeline(make_plan(cfg, N), decoder, "plain", ref_dev)
        comp = enc_k(x, frame0)
        e_enc = _max_err(comp.cpu(), enc_p(x.to(ref_dev), frame0).cpu())
        e_dec = _max_err(dec_k(comp, frame0).cpu(), dec_p(comp.to(ref_dev), frame0).cpu())
        e_rt = _max_err(rt_k(x, frame0).cpu(), rt_p(x.to(ref_dev), frame0).cpu())
        bounded = decoder not in ADAPTIVE
        print(f"{label}: kernel backend on the card vs plain backend on {where} "
              f"({tuple(x.shape)}): encode max|err| {e_enc:.3e} (<= {ENC_ATOL}), decode of "
              f"one composite {e_dec:.3e} (<= {DEC_ATOL}), round trip {e_rt:.3e} "
              + (f"(<= {DEC_ATOL})" if bounded else "(reported: the adaptive blend)"))
        _check(e_enc <= ENC_ATOL, f"{label}: encodes disagree on {where}: {e_enc}")
        _check(e_dec <= DEC_ATOL, f"{label}: decodes disagree on {where}: {e_dec}")
        _check(e_rt <= DEC_ATOL or not bounded,
               f"{label}: round trips disagree on {where}: {e_rt}")
        if where == "the card":
            rt_plain = rt_p
    return rt_k, rt_plain


def check_channel(dev) -> None:
    """Phase 4d through the kernel backend: raster identities, burst lock,
    ACC, PAL ident and NIIR normalisation against CHANNEL_PSNR."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame import raster
    from color_modem_tpu_torch.frame.channel import impair
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.metrics import psnr

    def expect(key, out, rgb):
        _check(bool(torch.isfinite(out).all()) and out.shape == rgb.shape,
               f"{key}: bad output")
        q = psnr(out, rgb)
        print(f"channel {key}: psnr {q:.4f} dB (expected {CHANNEL_PSNR[key]} +- {PSNR_TOL})")
        _check(abs(q - CHANNEL_PSNR[key]) <= PSNR_TOL, f"{key}: PSNR {q} dB")

    def locked(plan, rp, bad, g, decoder, **kw):
        qk.reset_launches()
        out = raster.decode_burst_locked(plan, rp, bad, g, decoder, "kernel", **kw)
        torch.cuda.synchronize()
        _check(qk.LAUNCHES == {"qam_encode": 0, "qam_decode": 1},
               f"a burst-locked decode must launch qam_decode once: {qk.LAUNCHES}")
        return out

    def rastered(name, decoder, **imp):
        plan = make_plan(ALL_STANDARDS[name](), N)
        enc, dec, rt = make_pipeline(plan, decoder, "kernel", dev, raster=True)
        enc0, _, _ = make_pipeline(plan, decoder, "kernel", dev)
        rgb = full_scene(plan.cfg.active_lines, dev)
        rp = raster.make_raster(plan)
        g = frame_line_index(plan, 0, BATCH, plan.cfg.active_lines, dev)
        rast, comp = enc(rgb, 0), enc0(rgb, 0)
        label = f"{name} {decoder} {tuple(rast.shape)}"
        _check(torch.equal(raster.strip_raster(rp, rast), comp)
               and torch.equal(raster.add_raster(plan, rp, comp, g), rast),
               f"{label}: strip(add(x)) is not x")
        _check(torch.equal(dec(rast, 0), rt(rgb, 0)),
               f"{label}: rastered encode -> decode differs from the round trip")
        print(f"raster {label}: strip(add(x)) == x and rastered decode == round trip, "
              "bit for bit")
        return plan, rp, rgb, g, impair(plan, rast, **imp), dec

    with torch.inference_mode():
        for decoder in ("notch", "comb3"):
            plan, rp, rgb, g, bad, dec = rastered("ntsc", decoder, chroma_phase_deg=25.0)
            expect(f"ntsc {decoder} rastered, 25 deg: nominal", dec(bad, 0), rgb)
            expect(f"ntsc {decoder} rastered, 25 deg: burst-locked",
                   locked(plan, rp, bad, g, decoder), rgb)
        plan, rp, rgb, g, bad, dec = rastered("ntsc", "notch", chroma_gain=0.5)
        expect("ntsc notch rastered, gain 0.5: nominal", dec(bad, 0), rgb)
        expect("ntsc notch rastered, gain 0.5: burst-locked acc",
               locked(plan, rp, bad, g, "notch", acc=True), rgb)
        plan, rp, rgb, g, bad, dec = rastered("pal", "delayline", chroma_phase_deg=20.0)
        expect("pal delayline rastered, 20 deg: nominal", dec(bad, 0), rgb)
        expect("pal delayline rastered, 20 deg: burst-locked",
               locked(plan, rp, bad, g, "delayline"), rgb)
        out, slip = raster.decode_identified(plan, rp, bad, g + 1, "delayline", "kernel")
        _check(slip.dtype == torch.int32 and bool((slip == 1).all()),
               f"PAL ident must read slip 1 in every frame: {slip.tolist()}")
        expect("pal delayline rastered, 20 deg: identified on gline + 1", out, rgb)
        for name, decoder in (("niir", "notch"), ("niir", "avg"), ("ntsc", "notch")):
            plan = make_plan(ALL_STANDARDS[name](), N)
            enc, dec, _ = make_pipeline(plan, decoder, "kernel", dev)
            rgb = full_scene(plan.cfg.active_lines, dev)
            bad = impair(plan, enc(rgb, 0), chroma_phase_deg=25.0, chroma_gain=0.6)
            expect(f"{name} {decoder}, 25 deg gain 0.6", dec(bad, 0), rgb)


def time_qam_family(dev, card: str, roundtrips: dict) -> dict:
    """Phase 5c: the QAM kernels at PAL and NIIR shapes, where the JAX
    package ran its ``_shared`` kernels, and the PAL delayline / NIIR avg
    round trips; each kernel also held against its plain version here."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal

    times = {}
    for name, decoder in (("pal", "delayline"), ("niir", "avg")):
        plan = make_plan(ALL_STANDARDS[name](), N).to(dev)
        lines = plan.cfg.active_lines
        mpix = BATCH * lines * N / 1e6
        rgb = full_scene(lines, dev)
        with torch.inference_mode():
            ycc = apply_mat3(plan.rgb_to_ycc, rgb).contiguous()
            cols = qk.phase_cols(plan, frame_line_index(plan, 0, BATCH, lines, dev))
            comp = qk.encode_lines(plan, ycc, cols)
            sep = stencil_signal(plan, comp, decoder)
            e_enc = _max_err(comp, qk.encode_lines_plain(plan, ycc, cols))
            e_dec = _max_err(qk.decode_lines(plan, sep, comp, cols),
                             qk.decode_lines_plain(plan, sep, comp, cols))
            print(f"kernel vs plain {name} {BATCH}x{lines}x{N} on the scene: encode "
                  f"max|err| {e_enc:.3e} (<= {ENC_ATOL}), decode {e_dec:.3e} (<= {DEC_ATOL})")
            _check(e_enc <= ENC_ATOL and e_dec <= DEC_ATOL, f"{name} kernels disagree")
            rt_k, rt_p = roundtrips[name, decoder]
            pair = {
                f"qam_encode {name}": time_pair(
                    lambda: qk.encode_lines_plain(plan, ycc, cols),
                    lambda: qk.encode_lines(plan, ycc, cols)),
                f"qam_decode {name}": time_pair(
                    lambda: qk.decode_lines_plain(plan, sep, comp, cols),
                    lambda: qk.decode_lines(plan, sep, comp, cols)),
                f"{name} {decoder} roundtrip": time_pair(lambda: rt_p(rgb, 0),
                                                         lambda: rt_k(rgb, 0)),
            }
        for key, (p_ms, k_ms) in pair.items():
            print(f"time {key} {BATCH}x{lines}x{N} on {card}: kernel {k_ms:.4f} ms "
                  f"({mpix / k_ms * 1e3:.1f} Mpix/s), plain {p_ms:.4f} ms "
                  f"({mpix / p_ms * 1e3:.1f} Mpix/s)")
        times.update(pair)
    return times


def main() -> None:
    import numpy as np
    import torch

    # --- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from color_modem_tpu_torch import NIIR, NTSC, PAL, SECAM
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.kernels.build import load_library
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal
    from color_modem_tpu_torch.utils.metrics import psnr
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    dev = torch.device("cuda:0")

    # --- 2. build -----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s")

    # --- 3. kernel vs plain on the card ------------------------------------
    rng = np.random.default_rng(0)
    max_err = {"qam_encode": 0.0, "qam_decode": 0.0}
    for factory, lines, decoder in ((NTSC, 480, "comb3"), (PAL, 576, "comb3"),
                                    (NIIR, 576, "notch")):
        plan = make_plan(factory(), N).to(dev)
        ycc = np.stack([
            rng.uniform(0.0, 1.0, (BATCH, lines, N)),
            rng.uniform(-0.6, 0.6, (BATCH, lines, N)),
            rng.uniform(-0.6, 0.6, (BATCH, lines, N)),
        ], axis=1)
        ycc = torch.tensor(ycc, dtype=torch.float32, device=dev)
        gline = frame_line_index(plan, 12345, BATCH, lines, dev)
        cols = qk.phase_cols(plan, gline)
        comp_k = qk.encode_lines(plan, ycc, cols)
        comp_p = qk.encode_lines_plain(plan, ycc, cols)
        sep = stencil_signal(plan, comp_p, decoder)
        dec_k = qk.decode_lines(plan, sep, comp_p, cols)
        dec_p = qk.decode_lines_plain(plan, sep, comp_p, cols)
        torch.cuda.synchronize()
        e_enc, e_dec = _max_err(comp_k, comp_p), _max_err(dec_k, dec_p)
        print(f"kernel vs plain {plan.cfg.name} {BATCH * lines}x{N}: "
              f"encode max|err| {e_enc:.3e} (<= {ENC_ATOL}), "
              f"decode max|err| {e_dec:.3e} (<= {DEC_ATOL})")
        _check(e_enc <= ENC_ATOL, f"{plan.cfg.name} encode kernel disagrees: {e_enc}")
        _check(e_dec <= DEC_ATOL, f"{plan.cfg.name} decode kernel disagrees: {e_dec}")
        max_err["qam_encode"] = max(max_err["qam_encode"], e_enc)
        max_err["qam_decode"] = max(max_err["qam_decode"], e_dec)

    # --- 3b. shared FIR and SECAM kernels vs plain on the card -------------
    check_fir(dev)
    max_err["secam_encode"], max_err["secam_decode"] = 0.0, 0.0
    for frames, n in ((BATCH, N), (4, 2 * N)):
        e_enc, e_rgb = check_secam_kernels(dev, frames, n)
        max_err["secam_encode"] = max(max_err["secam_encode"], e_enc)
        max_err["secam_decode"] = max(max_err["secam_decode"], e_rgb)

    # --- 4. main path -------------------------------------------------------
    plan = make_plan(NTSC(), N)
    lines = plan.cfg.active_lines
    one = smooth_scene(lines, N, seed=0)
    rgb = torch.tensor(np.broadcast_to(one, (BATCH, 3, lines, N)), dtype=torch.float32,
                       device=dev)
    _, _, rt_kernel = make_pipeline(plan, "comb3", backend="kernel", device=dev)
    qk.reset_launches()
    out = rt_kernel(rgb, 0)
    torch.cuda.synchronize()
    launches = dict(qk.LAUNCHES)
    print(f"main path launches: {launches}")
    _check(launches == {"qam_encode": 1, "qam_decode": 1},
           f"one round trip must launch each kernel once: {launches}")
    _check(tuple(out.shape) == (BATCH, 3, lines, N), f"output shape {tuple(out.shape)}")
    _check(bool(torch.isfinite(out).all()), "non-finite output")
    q = psnr(out, rgb)
    print(f"main path ntsc comb3 {BATCH}x3x{lines}x{N}: psnr {q:.4f} dB "
          f"(expected {PSNR_EXPECTED} +- {PSNR_TOL})")
    _check(abs(q - PSNR_EXPECTED) <= PSNR_TOL, f"round-trip PSNR {q} dB")

    plain_plan = make_plan(NTSC(), N)
    _, _, rt_plain = make_pipeline(plain_plan, "comb3", backend="plain", device=dev)
    e_rt = _max_err(out, rt_plain(rgb, 0))
    print(f"main path kernel vs plain backend on the card: max|err| {e_rt:.3e} "
          f"(<= {DEC_ATOL})")
    _check(e_rt <= DEC_ATOL, f"kernel and plain round trips disagree: {e_rt}")
    _, _, rt_cpu = make_pipeline(make_plan(NTSC(), N), "comb3", backend="plain",
                                 device="cpu")
    small = rgb[:2, :, :64]
    e_cpu = _max_err(rt_kernel(small, 7).cpu(), rt_cpu(small.cpu(), 7))
    print(f"small input (2x3x64x{N}) kernel on the card vs plain on the CPU: "
          f"max|err| {e_cpu:.3e} (<= {DEC_ATOL})")
    _check(e_cpu <= DEC_ATOL, f"card and CPU round trips disagree: {e_cpu}")

    # --- 4b. the SECAM path ---------------------------------------------------
    srgb = torch.tensor(
        np.broadcast_to(smooth_scene(SECAM_LINES, N, seed=0), (BATCH, 3, SECAM_LINES, N)),
        dtype=torch.float32, device=dev)
    for decoder, expected in SECAM_PSNR.items():
        _, _, rt_k = make_pipeline(make_plan(SECAM(), N), decoder, backend="kernel",
                                   device=dev)
        sk.reset_launches()
        out = rt_k(srgb, 0)
        torch.cuda.synchronize()
        got = dict(sk.LAUNCHES)
        print(f"secam {decoder} path launches: {got}")
        _check(got == {"secam_encode": 1, "secam_decode": 1},
               f"one SECAM round trip must launch each kernel once: {got}")
        _check(tuple(out.shape) == (BATCH, 3, SECAM_LINES, N),
               f"secam output shape {tuple(out.shape)}")
        _check(bool(torch.isfinite(out).all()), "non-finite secam output")
        q = psnr(out, srgb)
        print(f"secam {decoder} {BATCH}x3x{SECAM_LINES}x{N}: psnr {q:.4f} dB "
              f"(expected {expected} +- {PSNR_TOL})")
        _check(abs(q - expected) <= PSNR_TOL, f"secam {decoder} round-trip PSNR {q} dB")
        _, _, rt_p = make_pipeline(make_plan(SECAM(), N), decoder, backend="plain",
                                   device=dev)
        e_rt = _max_err(out, rt_p(srgb, 0))
        _, _, rt_c = make_pipeline(make_plan(SECAM(), N), decoder, backend="plain",
                                   device="cpu")
        small = srgb[:2, :, :64]
        e_cpu = _max_err(rt_k(small, 7).cpu(), rt_c(small.cpu(), 7))
        print(f"secam {decoder} kernel vs plain backend on the card: max|err| {e_rt:.3e}; "
              f"small input (2x3x64x{N}) kernel on the card vs plain on the CPU: "
              f"{e_cpu:.3e} (each <= {DEC_ATOL})")
        _check(e_rt <= DEC_ATOL, f"secam kernel and plain round trips disagree: {e_rt}")
        _check(e_cpu <= DEC_ATOL, f"secam card and CPU round trips disagree: {e_cpu}")
        if decoder == "interp":
            launches.update(got)
            srt_kernel, srt_plain = rt_k, rt_p

    # --- 4c. the rest of the QAM family ---------------------------------------
    family = {}
    for (name, decoder), (expected, want) in QAM_FAMILY.items():
        family[name, decoder] = check_qam_path(dev, name, decoder, expected, want)

    # --- 4d. raster, channel and the receiver's countermeasures -----------------
    check_channel(dev)

    # --- 5. timing ------------------------------------------------------------
    mpix = BATCH * lines * N / 1e6
    gline = frame_line_index(plan, 0, BATCH, lines, dev)
    with torch.inference_mode():
        from color_modem_tpu_torch.dsp.colorimetry import apply_mat3

        ycc = apply_mat3(plan.rgb_to_ycc, rgb).contiguous()
        cols = qk.phase_cols(plan, gline)
        comp = qk.encode_lines(plan, ycc, cols)
        sep = stencil_signal(plan, comp, "comb3")
        times = {
            "qam_encode": time_pair(lambda: qk.encode_lines_plain(plan, ycc, cols),
                                    lambda: qk.encode_lines(plan, ycc, cols)),
            "qam_decode": time_pair(lambda: qk.decode_lines_plain(plan, sep, comp, cols),
                                    lambda: qk.decode_lines(plan, sep, comp, cols)),
            "roundtrip": time_pair(lambda: rt_plain(rgb, 0), lambda: rt_kernel(rgb, 0)),
        }
    for name, (p_ms, k_ms) in times.items():
        print(f"time {name} {BATCH}x{lines}x{N} on {card}: kernel {k_ms:.4f} ms "
              f"({mpix / k_ms * 1e3:.1f} Mpix/s), plain {p_ms:.4f} ms "
              f"({mpix / p_ms * 1e3:.1f} Mpix/s)")

    # --- 5b. SECAM timing -----------------------------------------------------
    splan = make_plan(SECAM(), N).to(dev)
    mpix = BATCH * SECAM_LINES * N / 1e6
    with torch.inference_mode():
        ycc = apply_mat3(splan.rgb_to_ycc, srgb).contiguous()
        isr = sk.isr_col(frame_line_index(splan, 0, BATCH, SECAM_LINES, dev))
        comp = sk.encode_lines(splan, ycc, isr)
        stimes = {
            "secam_encode": time_pair(lambda: sk.encode_lines_plain(splan, ycc, isr),
                                      lambda: sk.encode_lines(splan, ycc, isr)),
            "secam_decode": time_pair(lambda: sk.demodulate_lines_plain(splan, comp, isr),
                                      lambda: sk.demodulate_lines(splan, comp, isr)),
            "secam_roundtrip": time_pair(lambda: srt_plain(srgb, 0),
                                         lambda: srt_kernel(srgb, 0)),
        }
    for name, (p_ms, k_ms) in stimes.items():
        print(f"time {name} {BATCH}x{SECAM_LINES}x{N} on {card}: kernel {k_ms:.4f} ms "
              f"({mpix / k_ms * 1e3:.1f} Mpix/s), plain {p_ms:.4f} ms "
              f"({mpix / p_ms * 1e3:.1f} Mpix/s)")
    times.update(stimes)

    # --- 5c. QAM-family timing ------------------------------------------------
    time_qam_family(dev, card, family)

    _check("jax" not in sys.modules, "the port loaded jax")
    replaces = {"qam_encode": "color_modem_tpu/kernels/qam.py:85",
                "qam_decode": "color_modem_tpu/kernels/qam.py:129",
                "secam_encode": "color_modem_tpu/kernels/secam.py:118",
                "secam_decode": "color_modem_tpu/kernels/secam.py:231"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"color_modem_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][1],
         "plain_ms": times[name][0]}
        for name in replaces
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
