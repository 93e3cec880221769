"""Smoke test of the PyTorch/CUDA port (``color_modem_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits nonzero:

1. device: refuse to run without CUDA; print the card (nvidia-smi name and
   power limit) and ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``color_modem_tpu_torch/csrc`` (TF32 off);
3. each QAM kernel against its plain PyTorch version on the card: NTSC at
   16x480 lines, PAL and NIIR at 16x576 lines, 720 samples, seeded inputs;
3b. the SIMT FIR (``csrc/fir.cuh``, whose zero and held edges the SECAM
   kernels' staging matches) against ``np.convolve`` on asymmetric taps, and
   the tensor-core FIR in the QAM kernels' form (``csrc/band_fir.cuh``) the
   same way, zero edges, <= 2e-6, over 16 shapes (ragged last tiles of lines
   included); each SECAM kernel (the tensor-core form with the lines as
   columns) against its plain version at 16x576x720 and 4x576x1440: encode
   <= 2e-4, decoded RGB <= 5e-4, and the raw demodulated component's error
   printed;
4. the main path, NTSC encode -> comb3 decode at 16x3x480x720 through
   ``make_pipeline(..., backend="kernel")``: round-trip PSNR 46.62 +- 0.02 dB,
   one launch of each kernel, agreement with the plain backend on the card
   and with the plain backend on the CPU on a small input (:func:`check_path`);
4b. the SECAM path, encode -> interp/avg/notch decode at 16x3x576x720, the
   same way: PSNR 38.8644/33.3755/35.3157 +- 0.02 dB, one launch of each
   SECAM kernel per round trip;
4c. the rest of the QAM family at full width (16 frames, 576 or 480 lines,
   720 samples): PAL/PAL-M/PAL-N/PAL-60, NIIR, NTSC-4.43 and the temporal
   and adaptive combs, each round trip's PSNR +- 0.02 dB, its launches
   (combA/comb3dA separate outside the decode kernel, as in the JAX
   package: 0 decode launches), the same two agreements;
4d. the raster and channel layers: sync/burst raster identities, channel
   phase and gain errors decoded nominally, burst-locked, with ACC and with
   PAL ident, and NIIR's reference normalisation against NTSC, each PSNR
   +- 0.02 dB;
4e. the frame layer at full width (16 frames x 720 samples, the standard's
   active lines, kernel backend): interlaced NTSC comb3 and comb3d
   (parity-major), PAL delayline and SECAM interp, the rastered interlaced
   identities, S-Video NTSC/PAL/SECAM/NIIR (Y + C == composite), NTSC->PAL,
   PAL->NTSC and interlaced NTSC->PAL conversion, each PSNR +- 0.02 dB of the
   JAX CPU value with its launches and the plain backend on the card
   (<= 5e-4); telecine's inverse bit-exact at every cadence phase;
   ``temporal_nr(sigma=None)`` above 2^24 elements;
4f. the NTSC comb3 and SECAM interp round trips again with TF32 switched on
   for the whole process (``allow_tf32`` and ``set_float32_matmul_precision
   ("high")``): the same PSNRs, outputs bit-identical to phase 4's on both
   backends (the port pins its own precision), then the settings restored;
4g. the transmission layer at full width, which has no kernel of its own
   (``torch.fft`` and elementwise work around the QAM kernels): the NTSC
   rf-vsb-hop (16x480x720 composite from ``qam_encode``, transparency over
   lines [2:-2]), the satellite-fm-hop, the D2-MAC round trip at 16x576x720
   with its data burst decoded bit for bit, MAC over satellite, an RF ghost
   and the GCR equalizer, the TBC on a rastered composite, each PSNR +- 0.02
   dB of the JAX CPU value (``scripts/jax_transmission_reference.py``) or at
   the JAX tests' bound; sync-tip AGC above 2^24 elements against a float64
   quantile; each hop against the CPU on a small input; the hops
   bit-identical with TF32 on; no host-blocking operation in any hop
   (``set_sync_debug_mode("error")``);
4h. the sound layer at full width, no kernel of its own either: rf-sound
   (the NTSC composite from ``qam_encode`` through ``rf_modulate`` ->
   ``sound_on_rf`` -> ``nicam_on_rf`` -> ``rf_demodulate``,
   ``sound_from_rf``, ``nicam_from_rf``: transparency, FM audio SNR, NICAM
   bits equal to those sent with no parity error, L/R SNR), sat-sound (two
   subcarriers), A2 on the PAL composite from the ``_shared`` encode
   (stereo, dual and mono detected, L/R SNR), MTS on the 50 kHz sound
   channel and D2-MAC packet sound over the satellite hop, each PSNR +- 0.02
   dB and SNR +- 0.1 dB of the JAX CPU value; each chain on the card
   against the CPU, TF32 on bit-identical, no host-blocking operation (A2's
   decision: exactly its one stacked fetch);
5. CUDA-event times (median of 10 windows of 20 calls, with their spread)
   of each kernel and round trip against its plain version: NTSC comb3 and
   SECAM interp, then 5c PAL delayline and NIIR avg (the shared-filter
   case); per kernel its bound (bytes or operations, ``kernels/measure.py``)
   and the share of it reached, and one grouped conv2d of each kernel's
   FIRs alone (TF32 off) as the library yardstick; 5e the frame layer's
   round trips, the resample matmul and NR; 5g the three hops (and each
   half), in Mpix/s of composite or picture pixels; 5h each sound chain
   whole and each half (transmit, receive);
6. the video runner: ``process_video`` NTSC comb3 at 480x720, 48 frames in
   chunks of 16 from the device source (PSNR +- 0.02 dB of the JAX CPU run,
   3 launches of each kernel), a resume that processes nothing, one
   synchronising CUDA operation per wave of chunks (interlaced comb3d with
   noise and NR), chunk sizes 16 and 12 agreeing to 1e-6 under channel
   noise with NR (progressive comb3 and interlaced comb3d), NR gaining >
   2.5 dB on a noisy static source, and Mpix/s on both backends; then the
   same run through the RF hop and through the satellite hop at 12 dB CNR
   (PSNR +- 0.02 dB of the JAX CPU run), and chunk sizes 16 and 12 through
   the RF hop, the satellite hop, and the satellite hop at 12 dB CNR; the
   RF hop with a soundtrack (``rf_audio``), progressive and interlaced,
   against the JAX runner's PSNR and audio SNR, one synchronising operation
   per wave with the audio in the fetch, and chunk sizes 16 and 12 equal to
   1e-4 on the audio and 1e-5 on the frames.

The line before the last is ``{"kernels": [...]}``, one entry per Pallas
kernel of the JAX package (the QAM pair's ``_shared`` forms run the same
CUDA kernels with equal tile arrays, on the PAL delayline path); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

REPO = os.path.dirname(os.path.abspath(__file__))
PSNR_EXPECTED, PSNR_TOL = 46.62, 0.02
ENC_ATOL, DEC_ATOL = 2e-5, 5e-4  # kernel vs plain (tests/test_kernels.py bounds)
SECAM_ENC_ATOL = 2e-4  # the phase scan sums in another order than torch.cumsum
FIR_ATOL = 1e-6        # fir.cuh vs np.convolve, taps normalised to sum |t| ~ 1
BAND_FIR_ATOL = 2e-6   # band_fir.cuh (three TF32 passes) vs np.convolve, the same taps
YC_ATOL = 2.4e-7       # S-Video (comp - Y) + Y vs comp: float32 rounding, 2 ulp at 1.5
CHUNK_ATOL = 1e-6      # video outputs at two chunk sizes (tests/test_video.py)
NR_GAIN_DB = 2.5       # tests/test_video.py::test_video_nr
BATCH, N = 16, 720
SECAM_LINES = 576
#: SECAM round-trip PSNR of smooth_scene(576, 720, seed=0) at frame 0, as the
#: JAX xla path computes it on the CPU; numbers of the algorithm, not the chip
SECAM_PSNR = {"interp": 38.8644, "avg": 33.3755, "notch": 35.3157}
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
#: phase 4e: PSNR of each frame-layer row on full_scene(L) (16 frames, frame
#: 0) as the JAX xla path computes it on the CPU; a conversion is scored
#: against the input resampled to the destination's line count
FRAME_PSNR = {
    "interlaced ntsc comb3": 41.7624,
    "interlaced ntsc comb3d": 47.4153,
    "interlaced pal delayline": 33.9116,
    "interlaced secam interp": 37.2761,
    "svideo ntsc": 48.0586,
    "svideo pal": 50.6939,
    "svideo secam": 39.3639,
    "svideo niir": 37.6314,
    "transcode ntsc->pal": 41.6143,
    "transcode pal->ntsc": 40.1674,
    "transcode interlaced ntsc->pal": 33.2763,
}
#: phase 6: min_psnr_db of the JAX xla process_video run (NTSC comb3,
#: synthetic_device_source(480, 720, seed=0), 48 frames, chunk 16) on the CPU
VIDEO_MIN_PSNR = 47.37  # the summary rounds to 0.01 dB
VIDEO_FRAMES, VIDEO_CHUNK = 48, 16
#: frames of the chunk-independence runs (chunk edges at 12, 16, 24)
INDEP_FRAMES = 24
#: phase 4g: the JAX xla values on the CPU at the card's shapes
#: (scripts/jax_transmission_reference.py), each held to PSNR_TOL
HOP_PSNR = {
    "rf-vsb-hop": 69.1816,        # composite transparency over lines [2:-2]
    "satellite-fm-hop": 51.2345,  # composite transparency
    "d2mac": 53.6966,             # RGB round trip, 16x576x720
    "mac-satellite": 58.7737,     # MAC-line transparency through the FM hop
    "rf-ghost": 15.4154,          # RF ghost 3 us / 0.3, before the equalizer
    "tbc-clean": 46.6200, "tbc-wrecked": 19.4785, "tbc-fixed": 46.4589,
}
#: the equalized RF ghost moves ~0.1 dB with the float32 rounding of the
#: design (JAX 52.0473, a float64 design 52.1526): held to the JAX test's
#: bound (tests/test_rf.py::test_rf_multipath_ghost_and_gcr_equalizer)
GCR_RF_MIN_DB = 45.0
MAC_SAT_MIN_DB = 54.0       # tests/test_satellite.py::test_mac_transparency_and_picture
AGC_MIN_DB = 40.0           # tests/test_rf.py::test_rf_sync_tip_agc
AGC_FRAMES = 48             # 48 x 480 x 858 rastered samples > 2^24
#: the hops on the card against the CPU on 2 x 32 lines: float32 FFT
#: rounding; the FM phase carries it to ~1e-4 (tests/test_torch_satellite.py)
HOP_CPU_ATOL = {"rf": 1e-5, "satellite": 5e-4, "d2mac": 1e-5}
#: phase 6 through the hops: min_psnr_db of the JAX xla run on the CPU
#: (scripts/jax_transmission_reference.py video-rf / video-satellite)
VIDEO_HOP = {"rf": ({"rf": True}, 47.28),
             "satellite": ({"satellite": True, "sat_cnr": 12.0}, 27.92)}
#: chunk sizes 16 and 12 through the hops: the FFTs' batch-dependent last
#: bits; at 12 dB CNR, near the FM threshold, the discriminator carries
#: them further on the noisiest samples
HOP_CHUNK = {"rf": ({"rf": True}, 1e-5), "satellite": ({"satellite": True}, 1e-5),
             "satellite cnr 12": ({"satellite": True, "sat_cnr": 12.0}, 2e-3)}
#: phase 4h: the sound layer's values as the JAX xla path computes them on
#: the CPU at the card's shapes (scripts/jax_transmission_reference.py
#: rf-sound, sat-sound, a2, mts, mac-sound); a PSNR is held to PSNR_TOL, an
#: SNR (each signal's own mean removed, :func:`snr_db`) to SNR_TOL
SNR_TOL = 0.1
SOUND_PSNR = {"rf-sound transparency": 56.9436, "sat-sound transparency": 49.1133}
SOUND_SNR = {
    "rf-sound fm audio": 58.7689,
    "rf-sound nicam left": 57.2877, "rf-sound nicam right": 59.7092,
    "sat-sound subcarrier 0": 66.6137, "sat-sound subcarrier 1": 59.8260,
    "a2 stereo left": 64.0769, "a2 stereo right": 61.8164,
    "a2 dual left": 64.1247, "a2 dual right": 61.8171,
    "mts left": 68.9686, "mts right": 59.5621,
    "mac-sound left": 58.8734, "mac-sound right": 59.7900,
}
NICAM_FRAMES, NICAM_OFFSET_BITS = 25, 72   # nicam_capacity; the head guard
#: the sound chains on the card against the CPU on a small input (2 frames
#: of 64 lines): float32 FFT and scan rounding; the NICAM and packet-sound
#: audio are bit-exact paths
SOUND_CPU_ATOL = {"rf-sound": 1e-4, "sat-sound": 1e-3, "a2 stereo": 1e-3, "a2 dual": 1e-3,
                  "mts": 1e-4, "mac-sound": 0.0}
#: phase 6 with a soundtrack (0.5 sin 700 Hz + 0.3 sin 4 kHz): the JAX xla
#: runner's min_psnr_db and audio SNR (scripts/jax_transmission_reference.py
#: video-rf-audio, video-rf-audio-interlaced)
VIDEO_AUDIO = {"progressive": (47.24, 62.4085),
               "interlaced": (42.87, 62.3770)}
AUDIO_CHUNK_ATOL = 1e-4    # tests/test_video.py::test_video_rf_audio_phase_continuous
QAM_1_1 = {"qam_encode": 1, "qam_decode": 1}
SECAM_1_1 = {"secam_encode": 1, "secam_decode": 1}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def reset_counts() -> None:
    """Zero the launch counters of all four CUDA kernels."""
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels import secam as sk

    qk.reset_launches()
    sk.reset_launches()


def read_counts(label: str, want: dict) -> dict:
    """Synchronise, read the four launch counters and require ``want`` (a
    kernel it leaves out must not have launched)."""
    import torch

    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels import secam as sk

    torch.cuda.synchronize()
    got = {**qk.LAUNCHES, **sk.LAUNCHES}
    full = {k: want.get(k, 0) for k in got}
    _check(got == full, f"{label}: launches {got}, expected {full}")
    return got


def _stats(windows: list[float]) -> tuple[float, float, float]:
    return statistics.median(windows), min(windows), max(windows)


def time_pair(plain, kernel) -> dict:
    """``{"plain": (median, min, max), "kernel": (...)}`` ms per call, over
    10 windows each, taken in the order plain, kernel, kernel, plain."""
    from color_modem_tpu_torch.kernels.measure import time_ms

    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return {"plain": _stats(p1 + p2), "kernel": _stats(k1 + k2)}


def _fmt(t: tuple[float, float, float], mpix: float | None = None) -> str:
    rate = f", {mpix / t[0] * 1e3:.1f} Mpix/s" if mpix else ""
    return f"{t[0]:.4f} ms [{t[1]:.4f}, {t[2]:.4f}]{rate}"


def _fmt_rate(rates: list[float]) -> str:
    med, lo, hi = _stats(rates)
    return f"{med:.1f} [{lo:.1f}, {hi:.1f}]"


def print_times(card: str, shape: str, mpix: float | None, times: dict) -> None:
    for key, t in times.items():
        if "plain" in t:
            print(f"time {key} {shape} on {card}: kernel {_fmt(t['kernel'], mpix)}, "
                  f"plain {_fmt(t['plain'], mpix)} (median [min, max] of 10 windows)")
        else:
            print(f"time {key} {shape} on {card}: {_fmt(t['only'], mpix)} "
                  "(median [min, max] of 5 windows)")


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


def check_band_fir(dev) -> float:
    """band_fir.cuh through csrc/band_fir_check.cu against np.convolve on
    random asymmetric taps: taps longer than the line, widths that are not
    multiples of 8, lines cut into spans, 17 lines (a ragged last tile of
    16) and 7681 lines at the main path's width."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.kernels import fir as fk

    rng = np.random.default_rng(2)
    worst = 0.0
    shapes = [(t, n, 17) for t in (31, 129, 259) for n in (61, 97, 720, 722, 1440)]
    for ntaps, n, lines in shapes + [(129, 720, 7681)]:
        taps = rng.normal(size=ntaps) / ntaps
        x = rng.normal(size=(lines, n)).astype(np.float32)
        h = (ntaps - 1) // 2
        ref = np.stack([np.convolve(np.pad(r.astype(np.float64), h), taps, "same")[h : h + n]
                        for r in x])
        got = fk.band_fir_lines(torch.tensor(x, device=dev),
                                torch.tensor(taps, dtype=torch.float32, device=dev))
        torch.cuda.synchronize()
        e = float(np.abs(got.cpu().numpy() - ref).max())
        _check(e <= BAND_FIR_ATOL,
               f"band_fir.cuh disagrees with np.convolve at {lines}x{n}, {ntaps} taps: {e}")
        worst = max(worst, e)
    print(f"band_fir.cuh vs np.convolve, {len(shapes) + 1} shapes (taps 31/129/259, widths "
          f"61-1440, 17 and 7681 lines): max|err| {worst:.3e} (<= {BAND_FIR_ATOL})")
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


def full_scene(lines: int, dev, frames: int = BATCH):
    """smooth_scene(lines, N, seed=0) broadcast to ``frames`` frames on ``dev``."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.utils.testimages import smooth_scene

    return torch.tensor(np.broadcast_to(smooth_scene(lines, N, seed=0), (frames, 3, lines, N)),
                        dtype=torch.float32, device=dev)


def check_path(dev, name: str, decoder: str, expected: float, want: dict):
    """One round trip at BATCH x 3 x L x N through the kernel backend (PSNR,
    launches of all four kernels, shape, finite values), against the plain
    backend on the card and on the CPU, stage by stage: the encodes on the
    same RGB (<= ENC_ATOL, SECAM <= SECAM_ENC_ATOL), the decodes on the same
    composite (<= DEC_ATOL), and the round trips (<= DEC_ATOL).

    combA/comb3dA: the round-trip difference is printed, not bounded.  Their
    blend weights divide by smoothed energies, and the smoother
    (``comb_sel_lpf``) has negative lobes, so a denominator can cross zero
    and turn a 1e-7 difference between two encodes into 1e-2 on a few
    samples (the JAX package's own xla and Pallas round trips differ so).
    Their decode runs the same plain code on both backends.  Returns the
    kernel and plain round trips and the launch counts."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import ADAPTIVE, temporal_comb_spacing
    from color_modem_tpu_torch.utils.metrics import psnr

    cfg = ALL_STANDARDS[name]()
    lines = cfg.active_lines
    rgb = full_scene(lines, dev)
    label = f"{name} {decoder} {BATCH}x3x{lines}x{N}"
    enc_k, dec_k, rt_k = make_pipeline(make_plan(cfg, N), decoder, "kernel", dev)
    reset_counts()
    out = rt_k(rgb, 0)
    got = read_counts(label, want)
    _check(tuple(out.shape) == tuple(rgb.shape), f"{label}: output shape {tuple(out.shape)}")
    _check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    q = psnr(out, rgb)
    print(f"{label}: psnr {q:.4f} dB (expected {expected} +- {PSNR_TOL}), launches {got}")
    _check(abs(q - expected) <= PSNR_TOL, f"{label}: round-trip PSNR {q} dB")

    enc_atol = SECAM_ENC_ATOL if cfg.is_fm else ENC_ATOL
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
              f"({tuple(x.shape)}): encode max|err| {e_enc:.3e} (<= {enc_atol}), decode of "
              f"one composite {e_dec:.3e} (<= {DEC_ATOL}), round trip {e_rt:.3e} "
              + (f"(<= {DEC_ATOL})" if bounded else "(reported: the adaptive blend)"))
        _check(e_enc <= enc_atol, f"{label}: encodes disagree on {where}: {e_enc}")
        _check(e_dec <= DEC_ATOL, f"{label}: decodes disagree on {where}: {e_dec}")
        _check(e_rt <= DEC_ATOL or not bounded,
               f"{label}: round trips disagree on {where}: {e_rt}")
        if where == "the card":
            rt_plain = rt_p
    return rt_k, rt_plain, got


def check_tf32_on(dev, paths: dict) -> None:
    """Phase 4f: NTSC comb3 and SECAM interp with TF32 switched on for the
    whole process, on both backends: the same PSNR, and outputs identical
    to the ones with TF32 off, since every product of the port pins its own
    precision (the kernels, colorimetry's scaled adds, the plain FIRs'
    guarded matmuls).  The settings are restored afterwards."""
    import torch

    from color_modem_tpu_torch.utils.metrics import psnr

    cases = (("ntsc", "comb3", PSNR_EXPECTED), ("secam", "interp", SECAM_PSNR["interp"]))
    rgbs = {name: full_scene(480 if name == "ntsc" else SECAM_LINES, dev)
            for name, _, _ in cases}
    off = {(name, b): f(rgbs[name], 0) for name, decoder, _ in cases
           for b, f in zip(("kernel", "plain"), paths[name, decoder])}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for name, decoder, expected in cases:
            for b, f in zip(("kernel", "plain"), paths[name, decoder]):
                out = f(rgbs[name], 0)
                q, diff = psnr(out, rgbs[name]), _max_err(out, off[name, b])
                print(f"TF32 on: {name} {decoder} {b} backend: psnr {q:.4f} dB (expected "
                      f"{expected} +- {PSNR_TOL}), max|diff| to TF32 off {diff:.3e} (== 0)")
                _check(abs(q - expected) <= PSNR_TOL and diff == 0.0,
                       f"TF32 on changed {name} {decoder} ({b}): {q} dB, {diff}")
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    _check(torch.get_float32_matmul_precision() == "highest"
           and not torch.backends.cuda.matmul.allow_tf32, "TF32 settings not restored")


def check_channel(dev) -> None:
    """Phase 4d through the kernel backend: raster identities, burst lock,
    ACC, PAL ident and NIIR normalisation against CHANNEL_PSNR."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame import raster
    from color_modem_tpu_torch.frame.channel import impair
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.metrics import psnr

    def expect(key, out, rgb):
        _check(bool(torch.isfinite(out).all()) and out.shape == rgb.shape,
               f"{key}: bad output")
        q = psnr(out, rgb)
        print(f"channel {key}: psnr {q:.4f} dB (expected {CHANNEL_PSNR[key]} +- {PSNR_TOL})")
        _check(abs(q - CHANNEL_PSNR[key]) <= PSNR_TOL, f"{key}: PSNR {q} dB")

    def locked(plan, rp, bad, g, decoder, **kw):
        reset_counts()
        out = raster.decode_burst_locked(plan, rp, bad, g, decoder, "kernel", **kw)
        read_counts("a burst-locked decode", {"qam_decode": 1})
        return out

    def rastered(name, decoder, **imp):
        plan = make_plan(ALL_STANDARDS[name](), N).to(dev)  # used below with card data
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
            plan = make_plan(ALL_STANDARDS[name](), N).to(dev)
            enc, dec, _ = make_pipeline(plan, decoder, "kernel", dev)
            rgb = full_scene(plan.cfg.active_lines, dev)
            bad = impair(plan, enc(rgb, 0), chroma_phase_deg=25.0, chroma_gain=0.6)
            expect(f"{name} {decoder}, 25 deg gain 0.6", dec(bad, 0), rgb)


def frame_row(key: str, out, ref, got: dict, e_plain: float) -> float:
    """Phase 4e's common checks: shape, finite values, PSNR against
    FRAME_PSNR, and the kernel vs plain backend error on the card."""
    import torch

    from color_modem_tpu_torch.utils.metrics import psnr

    _check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
           f"{key}: output {tuple(out.shape)} for {tuple(ref.shape)}, or non-finite")
    q, expected = psnr(out, ref), FRAME_PSNR[key]
    print(f"{key} {tuple(ref.shape)}: psnr {q:.4f} dB (expected {expected} +- {PSNR_TOL}), "
          f"launches {got}, kernel vs plain backend on the card max|err| {e_plain:.3e} "
          f"(<= {DEC_ATOL})")
    _check(abs(q - expected) <= PSNR_TOL, f"{key}: PSNR {q} dB")
    _check(e_plain <= DEC_ATOL, f"{key}: kernel and plain backends disagree: {e_plain}")
    return q


def check_frame_layer(dev) -> dict:
    """Phase 4e.  Returns the (plain, kernel) callables phase 5e times."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS, NTSC
    from color_modem_tpu_torch.frame import raster
    from color_modem_tpu_torch.frame.interlace import field_line_index, make_interlaced_pipeline
    from color_modem_tpu_torch.frame.nr import lower_quartile, temporal_nr
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline
    from color_modem_tpu_torch.frame.telecine import (
        detect_pulldown_phase,
        inverse_telecine,
        telecine,
    )
    from color_modem_tpu_torch.frame.transcode import (
        best_decoder,
        make_interlaced_transcoder,
        make_transcoder,
        resample_lines,
    )
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.metrics import psnr
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    def plan(name):
        return make_plan(ALL_STANDARDS[name](), N)

    def both(factory, *args, **kw):
        """The kernel and plain backends' closures of one pipeline factory."""
        return (factory(*args, backend="kernel", device=dev, **kw),
                factory(*args, backend="plain", device=dev, **kw))

    timed = {}
    # interlaced fields; comb3d decodes parity-major, one decode launch
    for name, decoder in (("ntsc", "comb3"), ("ntsc", "comb3d"), ("pal", "delayline"),
                          ("secam", "interp")):
        key = f"interlaced {name} {decoder}"
        rgb = full_scene(ALL_STANDARDS[name]().active_lines, dev)
        (_, _, rt_k), (_, _, rt_p) = both(make_interlaced_pipeline, plan(name), decoder)
        reset_counts()
        out = rt_k(rgb, 0)
        got = read_counts(key, SECAM_1_1 if name == "secam" else QAM_1_1)
        frame_row(key, out, rgb, got, _max_err(out, rt_p(rgb, 0)))
        if (name, decoder) == ("ntsc", "comb3"):
            timed[key] = (partial(rt_p, rgb, 0), partial(rt_k, rgb, 0))

    # the rastered interlaced NTSC comb3 identities, bit for bit
    p = plan("ntsc").to(dev)
    rgb = full_scene(480, dev)
    enc_r, dec_r, _ = make_interlaced_pipeline(p, "comb3", "kernel", dev, raster=True)
    enc, _, rt = make_interlaced_pipeline(plan("ntsc"), "comb3", "kernel", dev)
    rast, comp = enc_r(rgb, 0), enc(rgb, 0)
    rp, g = raster.make_raster(p), field_line_index(p, 0, BATCH, 240, dev)
    _check(torch.equal(raster.strip_raster(rp, rast), comp)
           and torch.equal(raster.add_raster(p, rp, comp, g), rast),
           "interlaced raster: strip(add(x)) is not x")
    reset_counts()
    dec = dec_r(rast, 0)
    got = read_counts("interlaced rastered decode", {"qam_decode": 1})
    _check(torch.equal(dec, rt(rgb, 0)), "interlaced rastered decode differs from the round trip")
    print(f"interlaced ntsc comb3 rastered {tuple(rast.shape)}: strip(add(x)) == x and "
          f"decode == round trip, bit for bit; decode launches {got}")

    # S-Video: the encode kernel only (the ideal receiver demodulates plainly)
    for name in ("ntsc", "pal", "secam", "niir"):
        key = f"svideo {name}"
        cfg = ALL_STANDARDS[name]()
        rgb = full_scene(cfg.active_lines, dev)
        (enc, _, rt_k), (_, _, rt_p) = both(make_svideo_pipeline, plan(name))
        enc_c, _, _ = make_pipeline(plan(name), "notch", "kernel", dev)
        yc = enc(rgb, 0)
        e_yc = _max_err(yc[:, 0] + yc[:, 1], enc_c(rgb, 0))
        print(f"{key}: Y + C vs composite max|err| {e_yc:.3e} (<= {YC_ATOL})")
        _check(e_yc <= YC_ATOL, f"{key}: Y + C is not the composite: {e_yc}")
        reset_counts()
        out = rt_k(rgb, 0)
        got = read_counts(key, {"secam_encode" if cfg.is_fm else "qam_encode": 1})
        frame_row(key, out, rgb, got, _max_err(out, rt_p(rgb, 0)))
        if name == "ntsc":
            timed[key] = (partial(rt_p, rgb, 0), partial(rt_k, rgb, 0))

    # standards conversion: one source decode and one destination encode
    for src, dst in (("ntsc", "pal"), ("pal", "ntsc")):
        key = f"transcode {src}->{dst}"
        rgb = full_scene(ALL_STANDARDS[src]().active_lines, dev)
        l_dst = ALL_STANDARDS[dst]().active_lines
        comp = make_pipeline(plan(src), "notch", "kernel", dev)[0](rgb, 0)
        conv_k, conv_p = both(make_transcoder, plan(src), plan(dst))
        reset_counts()
        comp_d = conv_k(comp, 0)
        got = read_counts(key, QAM_1_1)
        _check(tuple(comp_d.shape) == (BATCH, l_dst, N), f"{key}: shape {tuple(comp_d.shape)}")
        p_dst = plan(dst)
        out = make_pipeline(p_dst, best_decoder(p_dst), "kernel", dev)[1](comp_d, 0)
        frame_row(key, out, resample_lines(rgb, l_dst), got, _max_err(comp_d, conv_p(comp, 0)))
        if src == "ntsc":
            timed[key] = (partial(conv_p, comp, 0), partial(conv_k, comp, 0))
            timed["resample_lines 480->576"] = (None, partial(resample_lines, rgb, 576))
    key = "transcode interlaced ntsc->pal"
    rgb = full_scene(480, dev)
    fields = make_interlaced_pipeline(plan("ntsc"), "comb3", "kernel", dev)[0](rgb, 0)
    conv_k, conv_p = both(make_interlaced_transcoder, plan("ntsc"), plan("pal"))
    reset_counts()
    fields_d = conv_k(fields, 0)
    got = read_counts(key, QAM_1_1)
    _check(tuple(fields_d.shape) == (2 * BATCH, 288, N), f"{key}: shape {tuple(fields_d.shape)}")
    out = make_interlaced_pipeline(plan("pal"), "comb3", "kernel", dev)[1](fields_d, 0)
    frame_row(key, out, resample_lines(rgb, 576), got, _max_err(fields_d, conv_p(fields, 0)))

    # telecine: exact inverse at every cadence phase, the phase detected
    one = smooth_scene(480, N, seed=2)
    film = torch.tensor(np.stack([np.roll(one, 13 * i, axis=-1) for i in range(8)]),
                        dtype=torch.float32, device=dev)
    fields = telecine(film)
    for phase in (0, 2, 4, 6, 8):
        det, conf = detect_pulldown_phase(fields[phase:])
        out = inverse_telecine(fields[phase:], det)
        skip = 0 if phase == 0 else 4
        _check(det == phase and torch.equal(out, film[skip : skip + out.shape[0]]),
               f"telecine phase {phase}: detected {det}, inverse not exact")
        print(f"telecine {tuple(film.shape)} -> {tuple(fields.shape)} from phase {phase}: "
              f"detected {det} (confidence {conf:.1f}), inverse_telecine bit-exact on "
              f"{tuple(out.shape)}")

    # temporal_nr(sigma=None) above 2^24 elements: the lower quartile by sort
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.rand(2**24 + 2**20, generator=gen, device=dev)
    lq = float(lower_quartile(d))
    ref = float(np.percentile(d.cpu().numpy().astype(np.float64), 25.0))
    print(f"lower_quartile of {d.numel()} elements: {lq:.9f} vs np.percentile {ref:.9f}")
    _check(abs(lq - ref) <= 1e-6, f"lower_quartile disagrees with np.percentile: {lq}, {ref}")
    clean = full_scene(576, dev, frames=48)
    noisy = clean + 0.02 * torch.randn(clean.shape, generator=gen, device=dev)
    with torch.inference_mode():
        den = temporal_nr(noisy)
    gain = psnr(den, clean) - psnr(noisy, clean)
    print(f"temporal_nr(sigma=None) on {tuple(noisy.shape)} (motion metric "
          f"{48 * 576 * N} > 2^24 elements): gain {gain:.3f} dB (> {NR_GAIN_DB})")
    _check(bool(torch.isfinite(den).all()) and gain > NR_GAIN_DB, f"NR gain {gain} dB")
    timed["temporal_nr sigma=None 48x3x576x720"] = (None, partial(temporal_nr, noisy))
    small = noisy[:BATCH, :, :480]
    timed["temporal_nr sigma=0.02 16x3x480x720"] = (None, partial(temporal_nr, small, 0.02))
    return timed


def time_frame_layer(card: str, timed: dict) -> dict:
    """Phase 5e: the frame layer's round trips, kernel vs plain backend, and
    the display-side pieces alone."""
    import torch

    from color_modem_tpu_torch.kernels.measure import time_ms

    times = {}
    with torch.inference_mode():
        for key, (plain, kernel) in timed.items():
            times[key] = (time_pair(plain, kernel) if plain is not None
                          else {"only": _stats(time_ms(kernel))})
    print_times(card, "", None, times)
    return times


def qam_library_calls(plan, ycc, sep, comp, cols) -> dict:
    """The yardstick of each QAM kernel: one grouped conv2d that runs the
    kernel's FIRs alone on its inputs (TF32 off), checked against the plain
    FIRs.  It computes less than the kernel (no carrier, mix or luma) and the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    from color_modem_tpu_torch.dsp.apply import fir_same
    from color_modem_tpu_torch.kernels import qam as qk

    g, _, l, n = ycc.shape
    t = plan.c1_lpf.numel()
    pad = (0, (t - 1) // 2)
    sin, cos = qk._carrier(cols[:, 0].reshape(g, l, 1), plan)
    cb = fir_same(sep, plan.chroma_bpf_mat)
    arms = torch.stack([sep, 2.0 * cb * sin, 2.0 * cb * cos], dim=1)
    w_enc = torch.stack([plan.c1_lpf, plan.c2_lpf]).flip(-1).reshape(2, 1, 1, t)
    w_dec = torch.stack([plan.chroma_bpf, plan.c1_lpf, plan.c2_lpf]).flip(-1).reshape(3, 1, 1, t)
    calls = {"qam_encode": partial(F.conv2d, ycc[:, 1:3], w_enc, padding=pad, groups=2),
             "qam_decode": partial(F.conv2d, arms, w_dec, padding=pad, groups=3)}
    e = max(_max_err(calls["qam_encode"]()[:, 0], fir_same(ycc[:, 1], plan.c1_lpf_mat)),
            _max_err(calls["qam_decode"]()[:, 2], fir_same(arms[:, 2], plan.c2_lpf_mat)))
    _check(e <= 1e-5, f"the conv2d yardstick is not the kernels' FIRs: {e}")
    return calls


def secam_library_calls(plan, ycc, comp, isr) -> dict:
    """The yardstick of each SECAM kernel: one grouped conv2d that runs the
    kernel's FIRs alone (TF32 off), each filter zero-padded to the longest,
    on inputs of the kernel's widths: encode comp_lpf, preemph and
    anticloche over N; decode bell_takeoff, luma_notch, mix_lpf twice, diff
    twice and deemph over the extended line N + 2M, and demod_lpf with them
    (so it does more multiply-adds than the kernel).  Checked against the
    plain zero-edged FIRs; it computes no held edge, mix, discriminator or
    scan, and the port never calls it."""
    import torch
    import torch.nn.functional as F

    from color_modem_tpu_torch.dsp.apply import fir_same
    from color_modem_tpu_torch.modem import secam

    def weights(names):
        taps = [getattr(plan, k) for k in names]
        t = max(x.numel() for x in taps)
        w = torch.zeros(len(taps), 1, 1, t, device=ycc.device)
        for i, x in enumerate(taps):
            o = (t - x.numel()) // 2
            w[i, 0, 0, o : o + x.numel()] = x.flip(-1)
        return w, (0, (t - 1) // 2)

    g, _, l, n = ycc.shape
    w_enc, pad_enc = weights(("comp_lpf", "preemph", "anticloche"))
    x_enc = torch.stack([ycc[:, 1], ycc[:, 2], ycc[:, 0]], dim=1).contiguous()
    dec = ("bell_takeoff", "luma_notch", "mix_lpf", "mix_lpf", "diff", "diff", "deemph",
           "demod_lpf")
    w_dec, pad_dec = weights(dec)
    ext = secam.extend_blanking_parity(plan, comp, isr.reshape(g, l) != 0.0)
    x_dec = ext[:, None].expand(g, len(dec), l, ext.shape[-1]).contiguous()
    calls = {"secam_encode": partial(F.conv2d, x_enc, w_enc, padding=pad_enc, groups=3),
             "secam_decode": partial(F.conv2d, x_dec, w_dec, padding=pad_dec, groups=len(dec))}
    e = max(_max_err(calls["secam_encode"]()[:, 2], fir_same(ycc[:, 0], plan.anticloche_mat)),
            _max_err(calls["secam_decode"]()[:, 0], fir_same(ext, plan.bell_takeoff_mat)))
    _check(e <= 1e-5, f"the conv2d yardstick is not the SECAM kernels' FIRs: {e}")
    return calls


def time_path(dev, card: str, name: str, decoder: str, roundtrips: dict) -> dict:
    """Phases 5/5c: the path's two kernels at its full shape against their
    plain versions (held to the bounds here too), and its round trip."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.kernels.measure import kernel_bound, time_ms
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal

    plan = make_plan(ALL_STANDARDS[name](), N).to(dev)
    lines = plan.cfg.active_lines
    rgb = full_scene(lines, dev)
    with torch.inference_mode():
        ycc = apply_mat3(plan.rgb_to_ycc, rgb).contiguous()
        g = frame_line_index(plan, 0, BATCH, lines, dev)
        if plan.cfg.is_fm:
            isr = sk.isr_col(g)
            comp = sk.encode_lines(plan, ycc, isr)
            e_enc = _max_err(comp, sk.encode_lines_plain(plan, ycc, isr))
            e_dec = _max_err(secam_rgb(plan, *sk.demodulate_lines(plan, comp, isr), g),
                             secam_rgb(plan, *sk.demodulate_lines_plain(plan, comp, isr), g))
            enc_atol = SECAM_ENC_ATOL
            kernels = {
                "secam_encode": (lambda: sk.encode_lines_plain(plan, ycc, isr),
                                 lambda: sk.encode_lines(plan, ycc, isr)),
                "secam_decode": (lambda: sk.demodulate_lines_plain(plan, comp, isr),
                                 lambda: sk.demodulate_lines(plan, comp, isr)),
            }
        else:
            cols = qk.phase_cols(plan, g)
            comp = qk.encode_lines(plan, ycc, cols)
            sep = stencil_signal(plan, comp, decoder)
            e_enc = _max_err(comp, qk.encode_lines_plain(plan, ycc, cols))
            e_dec = _max_err(qk.decode_lines(plan, sep, comp, cols),
                             qk.decode_lines_plain(plan, sep, comp, cols))
            enc_atol = ENC_ATOL
            kernels = {
                "qam_encode": (lambda: qk.encode_lines_plain(plan, ycc, cols),
                               lambda: qk.encode_lines(plan, ycc, cols)),
                "qam_decode": (lambda: qk.decode_lines_plain(plan, sep, comp, cols),
                               lambda: qk.decode_lines(plan, sep, comp, cols)),
            }
        print(f"kernel vs plain {name} {BATCH}x{lines}x{N} on the scene: encode max|err| "
              f"{e_enc:.3e} (<= {enc_atol}), decode {e_dec:.3e} (<= {DEC_ATOL})")
        _check(e_enc <= enc_atol and e_dec <= DEC_ATOL, f"{name} kernels disagree")
        library = (secam_library_calls(plan, ycc, comp, isr) if plan.cfg.is_fm
                   else qam_library_calls(plan, ycc, sep, comp, cols))
        rt_k, rt_p = roundtrips[name, decoder]
        kernels[f"{decoder} roundtrip"] = (lambda: rt_p(rgb, 0), lambda: rt_k(rgb, 0))
        times = {key: time_pair(plain, kernel) for key, (plain, kernel) in kernels.items()}
        for kernel in [k for k in kernels if "roundtrip" not in k]:
            times[kernel]["bound"] = kernel_bound(plan, kernel, BATCH * lines)
            times[kernel]["library"] = (_stats(time_ms(library[kernel], windows=10))
                                        if kernel in library else None)
    print_times(card, f"{name} {BATCH}x{lines}x{N}", BATCH * lines * N / 1e6, times)
    for kernel in [k for k in kernels if "roundtrip" not in k]:
        t, (b, by), lib = times[kernel]["kernel"], times[kernel]["bound"], times[kernel]["library"]
        print(f"bound {kernel} {name} {BATCH}x{lines}x{N} on {card}: {_fmt(t)}, bound {b:.4f} ms "
              f"({by}), {100 * b / t[0]:.1f}% of it; " + (
                  f"library: one grouped conv2d of its FIRs alone {_fmt(lib)}" if lib else
                  "library: no single PyTorch call computes it"))
    return times


def check_transmission(dev, card: str) -> dict:
    """Phase 4g: the hops, MAC, the equalizer and the TBC at full width.
    Returns the callables phase 5g times, with their Mpix per call."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.frame.equalize import (
        apply_equalizer,
        design_equalizer,
        gcr_record_guarded,
    )
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.frame.raster import make_raster
    from color_modem_tpu_torch.frame.timebase import impair_timebase, tbc_correct
    from color_modem_tpu_torch.modem import mac
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.metrics import psnr

    def hold(key: str, q: float) -> None:
        print(f"4g {key}: {q:.4f} dB (expected {HOP_PSNR[key]} +- {PSNR_TOL}) on {card}")
        _check(abs(q - HOP_PSNR[key]) <= PSNR_TOL, f"4g {key}: {q} dB")

    plan = make_plan(NTSC(), N).to(dev)
    enc, _, _ = make_pipeline(plan, "notch", "kernel", dev)
    rgb = full_scene(480, dev)
    reset_counts()
    comp = enc(rgb, 0)
    read_counts("4g ntsc notch composite", {"qam_encode": 1})
    rfp = rf_mod.make_rf_plan(plan)
    sp = sat_mod.make_sat_plan(plan.fs, N)
    mplan = mac.make_mac_plan(N)
    mrgb = full_scene(576, dev)
    g = (torch.arange(BATCH, dtype=torch.int32, device=dev)[:, None] * mplan.cfg.total_lines
         + torch.arange(576, dtype=torch.int32, device=dev))
    msp = sat_mod.make_sat_plan(mplan.cfg.fs, mplan.cfg.samples_per_line)
    gen = torch.Generator(device=dev).manual_seed(5)

    rf_rt = partial(rf_mod.rf_roundtrip, rfp, comp, 0)
    sat_rt = partial(sat_mod.sat_roundtrip, sp, comp)
    mac_rt = partial(mac.roundtrip, mplan, mrgb, g)
    outs = {"rf": rf_rt(), "satellite": sat_rt(), "d2mac": mac_rt()}
    hold("rf-vsb-hop", psnr(outs["rf"][:, 2:-2], comp[:, 2:-2]))
    hold("satellite-fm-hop", psnr(outs["satellite"], comp))
    hold("d2mac", psnr(outs["d2mac"], mrgb))

    # the data burst, bit for bit, clean and through the satellite hop
    payload = torch.randint(0, 2, (BATCH, 576, 99), device=dev, generator=gen,
                            dtype=torch.int32)
    sig_data = mac.encode(mplan, mrgb, g, payload)
    for where, sig_rx in (("clean", sig_data), ("satellite", sat_mod.sat_roundtrip(msp, sig_data))):
        ok, bits = mac.decode_data(mplan, sig_rx)
        errors = int((bits != payload).sum())
        print(f"4g d2mac data burst {where}: {errors} bit errors in {payload.numel()}, "
              f"sync_ok on {int(ok.sum())} of {ok.numel()} lines")
        _check(errors == 0 and bool(ok.all()), f"d2mac data {where}: {errors} errors")
    sig = mac.encode(mplan, mrgb, g)
    q_ms = psnr(sat_mod.sat_roundtrip(msp, sig), sig)
    hold("mac-satellite", q_ms)
    _check(q_ms >= MAC_SAT_MIN_DB, f"MAC over satellite {q_ms} dB < {MAC_SAT_MIN_DB}")

    # an RF ghost, and the GCR equalizer designed from a record sent the same way
    def chain(c):
        rf = rf_mod.rf_modulate(rfp, c, 0)
        return rf_mod.rf_demodulate(rfp, rf_mod.rf_ghost(rfp, rf, 3.0, 0.30), 0)

    ghosted = chain(comp)
    hold("rf-ghost", psnr(ghosted[:, 2:-2], comp[:, 2:-2]))
    pv = rfp.video_zero
    rx_gcr = chain(torch.tensor(gcr_record_guarded(plan)[None], device=dev))[0][:3]
    eq = partial(lambda rx, x: apply_equalizer(
        x, design_equalizer(plan, rx, ntaps=1281, reg=1e-4, pivot=pv), pivot=pv), rx_gcr, ghosted)
    q_eq = psnr(eq()[:, 2:-2], comp[:, 2:-2])
    print(f"4g rf-ghost equalized: {q_eq:.4f} dB (>= {GCR_RF_MIN_DB}; JAX 52.0473, "
          f"float64 design 52.1526) on {card}")
    _check(q_eq >= GCR_RF_MIN_DB, f"GCR vs RF ghost: {q_eq} dB")

    # the TBC on a rastered composite: one encode, three decodes
    enc_r, dec_r, _ = make_pipeline(plan, "comb3", "kernel", dev, raster=True)
    reset_counts()
    ras = enc_r(rgb, 0)
    shifted, _ = impair_timebase(plan, ras, wobble_us=0.3)
    g_r = frame_line_index(plan, 0, BATCH, 480, dev)
    tbc = partial(tbc_correct, plan, make_raster(plan), shifted, g_r)
    fixed = tbc()
    for key, x in (("tbc-clean", ras), ("tbc-wrecked", shifted), ("tbc-fixed", fixed)):
        hold(key, psnr(dec_r(x, 0), rgb))
    read_counts("4g tbc", {"qam_encode": 1, "qam_decode": 3})

    # sync-tip AGC above 2^24 elements: the quantile by sort, against float64
    enc_a, _, _ = make_pipeline(plan, "notch", "kernel", dev, raster=True)
    comp_a = enc_a(full_scene(480, dev, AGC_FRAMES), 0)
    rfp_a = rf_mod.make_rf_plan(plan, row_samples=make_raster(plan).n_total)
    weak = 0.7 * rf_mod.rf_modulate(rfp_a, comp_a, 0)
    raw = rf_mod.rf_demodulate(rfp_a, weak, 0)
    agc = rf_mod.rf_demodulate(rfp_a, weak, 0, agc=True)
    env = (rf_mod.ENV_BLANK - raw.double() * (rf_mod.ENV_BLANK - rf_mod.ENV_WHITE)).cpu().numpy()
    ref = np.quantile(env.reshape(AGC_FRAMES, -1), 0.975, axis=-1)
    want = (rf_mod.ENV_BLANK - env / ref[:, None, None]) / (rf_mod.ENV_BLANK - rf_mod.ENV_WHITE)
    e_agc = float(np.abs(agc.double().cpu().numpy() - want).max())
    p_raw, p_agc = psnr(raw[:, 2:-2], comp_a[:, 2:-2]), psnr(agc[:, 2:-2], comp_a[:, 2:-2])
    print(f"4g sync-tip AGC at {tuple(comp_a.shape)} ({comp_a.numel()} > 2^24 samples): 0.7x "
          f"gain {p_raw:.4f} -> {p_agc:.4f} dB (>= {AGC_MIN_DB}), max|diff| to the float64 "
          f"quantile {e_agc:.3e} (<= 1e-5)")
    _check(p_agc >= AGC_MIN_DB and p_raw < 20.0 and e_agc <= 1e-5, "sync-tip AGC")
    del comp_a, weak, raw, agc, env, want

    # each hop against the CPU on a small input (2 frames x 32 lines)
    small = {
        "rf": (partial(rf_mod.rf_roundtrip, rfp), comp[:2, :32]),
        "satellite": (partial(sat_mod.sat_roundtrip, sp), comp[:2, :32]),
        "d2mac": (lambda x: mac.roundtrip(mplan, x, torch.arange(32, device=x.device)),
                  mrgb[:2, :, :32]),
    }
    for key, (fn, x) in small.items():
        e = _max_err(fn(x).cpu(), fn(x.cpu()))
        print(f"4g {key} on the card vs the CPU, {tuple(x.shape)}: max|diff| {e:.3e} "
              f"(<= {HOP_CPU_ATOL[key]})")
        _check(e <= HOP_CPU_ATOL[key], f"{key}: card and CPU disagree: {e}")

    # TF32 on for the whole process: the same outputs, bit for bit
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for key, fn in (("rf", rf_rt), ("satellite", sat_rt), ("d2mac", mac_rt)):
            diff = _max_err(fn(), outs[key])
            print(f"TF32 on: {key} hop max|diff| to TF32 off {diff:.3e} (== 0)")
            _check(diff == 0.0, f"TF32 on changed the {key} hop: {diff}")
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    # no host-blocking operation in any hop (every constant is on the card)
    noisy = partial(sat_mod.sat_roundtrip, sp, comp, None, gen, 12.0)
    data = partial(mac.decode_data, mplan, sig_data)
    blocking = {"rf": rf_rt, "satellite": sat_rt, "satellite+awgn": noisy, "d2mac": mac_rt,
                "d2mac data": data, "equalizer": eq, "tbc": tbc}
    for fn in blocking.values():
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in blocking.values():
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"4g no host-blocking operation in: {', '.join(blocking)}")

    mpix, mpix_mac = BATCH * 480 * N / 1e6, BATCH * 576 * N / 1e6
    rf_sig = rf_mod.rf_modulate(rfp, comp, 0)
    fm_sig = sat_mod.fm_modulate(sp, comp)
    mac_sig = mac.encode(mplan, mrgb, g)
    return {
        "rf-vsb-hop": (rf_rt, mpix),
        "rf_modulate": (partial(rf_mod.rf_modulate, rfp, comp, 0), mpix),
        "rf_demodulate": (partial(rf_mod.rf_demodulate, rfp, rf_sig, 0), mpix),
        "satellite-fm-hop": (sat_rt, mpix),
        "fm_modulate": (partial(sat_mod.fm_modulate, sp, comp), mpix),
        "fm_demodulate": (partial(sat_mod.fm_demodulate, sp, fm_sig), mpix),
        "d2mac": (mac_rt, mpix_mac),
        "mac encode": (partial(mac.encode, mplan, mrgb, g), mpix_mac),
        "mac decode": (partial(mac.decode, mplan, mac_sig, g), mpix_mac),
    }


def time_transmission(card: str, timed: dict) -> None:
    """Phase 5g: CUDA-event times of the hops, median [min, max] of 10
    windows of 20 calls."""
    from color_modem_tpu_torch.kernels.measure import time_ms

    for key, (fn, mpix) in timed.items():
        t = _stats(time_ms(fn) + time_ms(fn))
        print(f"time {key} {BATCH} frames on {card}: {_fmt(t, mpix)} "
              "(median [min, max] of 10 windows of 20 calls)")


def snr_db(ref, out) -> float:
    """Signal-to-error ratio in dB of ``out`` against ``ref``, each with its
    own mean removed (as scripts/jax_transmission_reference.py computes it)."""
    import numpy as np

    ref = np.asarray(ref, np.float64)
    ref = ref - ref.mean()
    out = np.asarray(out, np.float64)
    err = (out - out.mean()) - ref
    return float(10.0 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30)))


def _tone(freqs_amps, n: int, fs: float):
    """A sum of sines as float32 NumPy, made as the reference script makes it."""
    import numpy as np

    t = np.arange(n) / fs
    return sum(a * np.sin(2 * np.pi * f * t) for f, a in freqs_amps).astype(np.float32)


def sound_chains(dev, frames: int = BATCH, lines: int = 480,
                 pal_lines: int = 576) -> tuple[dict, dict]:
    """Phase 4h's chains on ``dev`` at ``frames`` x ``lines`` (A2 and the MAC
    at ``pal_lines``): ``(chains, inputs)``, each chain ``name ->
    (transmit, receive)``, where ``transmit()`` returns the signal on the
    channel and ``receive(sig)`` a tuple of outputs.  The inputs are the
    reference script's, made on the host and copied once."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC, PAL
    from color_modem_tpu_torch.frame import a2, mts, nicam
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.modem import mac
    from color_modem_tpu_torch.modem.plan import make_plan

    def up(x):
        return torch.tensor(np.ascontiguousarray(x), device=dev)

    plan = make_plan(NTSC(), N).to(dev)
    pal = make_plan(PAL(), N).to(dev)
    rgb, prgb = full_scene(lines, dev, frames), full_scene(pal_lines, dev, frames)
    reset_counts()
    comp = make_pipeline(plan, "notch", "kernel", dev)[0](rgb, 0)
    pcomp = make_pipeline(pal, "delayline", "kernel", dev)[0](prgb, 0)
    if dev.type == "cuda":
        read_counts("4h composites (NTSC notch, PAL delayline)", {"qam_encode": 2})
    rfp, prfp = rf_mod.make_rf_plan(plan), rf_mod.make_rf_plan(pal)
    rfp50 = rf_mod.make_rf_plan(plan, audio_bw=50e3)
    a2p = a2.make_a2_plan(prfp)
    item = lines * N

    # rf-sound: FM sound over the frames' joined stream, NICAM beside it
    audio = up(_tone(((1000.0, 0.6), (7000.0, 0.3)), frames * item, plan.fs).reshape(frames, item))
    cap = nicam.nicam_capacity(rfp, (frames, lines, N * rfp.r))
    nl, nr = (up(_tone(((f, 0.5),), 32 * cap, 32000.0)) for f in (800.0, 2300.0))
    nplan = nicam.make_nicam_rf_plan(rfp)

    def rf_tx():
        rf = rf_mod.sound_on_rf(rfp, rf_mod.rf_modulate(rfp, comp, 0), 0, audio, 0.0)
        return nicam.nicam_on_rf(rfp, rf, nl, nr)

    def rf_rx(rf):
        l_rx, r_rx, rep, lock = nicam.nicam_from_rf(rfp, rf, cap)
        bits = nicam.nicam_demodulate(nplan, rf[0].reshape(-1), cap)[0]
        return (rf_mod.rf_demodulate(rfp, rf, 0), rf_mod.sound_from_rf(rfp, rf, 0), l_rx, r_rx,
                rep["parity_errors"], lock["offset_bits"], bits)

    # sat-sound: two subcarriers, whole-cycle tones
    sp = sat_mod.make_sat_plan(plan.fs, N, audio_subs=2)
    k = [max(1, round(f * item / plan.fs)) for f in (1000.0, 3000.0)]
    sub = np.stack([a * np.sin(2 * np.pi * kk * np.arange(item) / item)
                    for kk, a in zip(k, (0.6, 0.5))])
    sub = up(np.broadcast_to(sub, (frames, 2, item)).astype(np.float32))

    # A2 on the PAL composite: stereo, dual and mono carriers
    pitem = pal_lines * N
    left = up(np.broadcast_to(_tone(((800.0, 0.6), (5000.0, 0.2)), pitem, pal.fs),
                              (frames, pitem)))
    right = up(np.broadcast_to(_tone(((2300.0, 0.5),), pitem, pal.fs), (frames, pitem)))

    def a2_tx(mode):
        if mode == "stereo":
            rf = rf_mod.rf_modulate(prfp, pcomp, 0, 0.5 * (left + right))
        else:
            rf = rf_mod.rf_modulate(prfp, pcomp, 0, left)
        return rf if mode == "mono" else a2.a2_on_rf(a2p, rf, 0, right, mode)

    # MTS on the 50 kHz sound channel
    ml = up(np.broadcast_to(_tone(((1000.0, 0.7),), item, plan.fs), (frames, item)))
    mr = up(np.broadcast_to(_tone(((3000.0, 0.5),), item, plan.fs), (frames, item)))

    # D2-MAC packet sound over the satellite hop
    mplan = mac.make_mac_plan(N)
    msp = sat_mod.make_sat_plan(mplan.cfg.fs, mplan.cfg.samples_per_line)
    g = (torch.arange(frames, dtype=torch.int32, device=dev)[:, None] * mplan.cfg.total_lines
         + torch.arange(pal_lines, dtype=torch.int32, device=dev))
    n_f = mac.sound_capacity(mplan, frames * pal_lines)
    pl, pr = (up(_tone(((f, a),), 32 * n_f, 32000.0)) for f, a in ((440.0, 0.7), (997.0, 0.5)))

    def mac_tx():
        payload, _ = mac.pack_sound(mplan, pl, pr, frames * pal_lines)
        return sat_mod.fm_modulate(msp, mac.encode(mplan, prgb, g,
                                                   payload.reshape(frames, pal_lines, -1)))

    def mac_rx(sig):
        _, bits = mac.decode_data(mplan, sat_mod.fm_demodulate(msp, sig))
        l_rx, r_rx, rep = mac.unpack_sound(mplan, bits, n_f)
        return l_rx, r_rx, rep["parity_errors"], bits

    return {
        "rf-sound": (rf_tx, rf_rx),
        "sat-sound": (partial(sat_mod.fm_modulate, sp, comp, audio=sub),
                      lambda sig: (sat_mod.fm_demodulate(sp, sig),
                                   sat_mod.fm_demodulate_audio(sp, sig))),
        "a2 stereo": (partial(a2_tx, "stereo"), lambda rf: a2._decode_arrays(a2p, rf, 0)),
        "a2 dual": (partial(a2_tx, "dual"), lambda rf: a2._decode_arrays(a2p, rf, 0)),
        "mts": (lambda: rf_mod.rf_modulate(rfp50, comp, 0, mts.mts_encode(plan, ml, mr)),
                lambda rf: mts.mts_decode(plan, rf_mod.rf_demodulate_sound(rfp50, rf, 0))),
        "mac-sound": (mac_tx, mac_rx),
    }, dict(comp=comp, a2p=a2p, audio=audio, nl=nl, nr=nr, cap=cap, sub=sub, left=left,
            right=right, ml=ml, mr=mr, pl=pl, pr=pr, a2_tx=a2_tx)


def _flat_outputs(outs) -> list:
    """The tensors of a chain's outputs (A2's statistics dicts unrolled)."""
    flat = []
    for o in outs:
        if isinstance(o, dict):
            flat += [o[k] for k in sorted(o)]
        else:
            flat.append(o)
    return flat


def sound_values(chains: dict, inp: dict) -> tuple[dict, dict]:
    """Phase 4h's numbers from :func:`sound_chains` at full width: the
    values held against the JAX package, and each chain's outputs."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.frame import a2, nicam
    from color_modem_tpu_torch.utils.metrics import psnr

    outs = {name: rx(tx()) for name, (tx, rx) in chains.items()}
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    v = {}
    out, aud, l_rx, r_rx, parity, offset, bits = outs["rf-sound"]
    comp = inp["comp"]
    v["rf-sound transparency"] = psnr(out[:, 2:-2], comp[:, 2:-2])
    v["rf-sound fm audio"] = snr_db(host(inp["audio"]).reshape(-1)[8000:-8000],
                                    host(aud).reshape(-1)[8000:-8000])
    v["rf-sound nicam left"] = snr_db(host(inp["nl"]), host(l_rx))
    v["rf-sound nicam right"] = snr_db(host(inp["nr"]), host(r_rx))
    sent = nicam.nicam_frames(inp["nl"], inp["nr"])
    v["nicam parity errors"] = int(parity.sum())
    v["nicam offset bits"] = int(offset)
    v["nicam bit errors"] = int((bits != sent).sum())
    out, aud = outs["sat-sound"]
    v["sat-sound transparency"] = psnr(out, comp)
    sub = host(inp["sub"])
    for j in range(2):
        v[f"sat-sound subcarrier {j}"] = snr_db(sub[0, j], host(aud[0, j]))
    left, right = host(inp["left"]), host(inp["right"])
    for mode in ("stereo", "dual"):
        gl, gr, info = a2.a2_decode(inp["a2p"], chains[f"a2 {mode}"][0](), 0)
        v[f"a2 {mode} modes"] = sorted(set(info["mode"]))
        v[f"a2 {mode} left"] = snr_db(left[0, 8192:-8192], host(gl[0, 8192:-8192]))
        v[f"a2 {mode} right"] = snr_db(right[0, 8192:-8192], host(gr[0, 8192:-8192]))
        if mode == "stereo":
            v["a2 stereo pilot"] = float(np.mean(info["pilot_level"]))
    _, _, info = a2.a2_decode(inp["a2p"], inp["a2_tx"]("mono"), 0)
    v["a2 mono modes"] = sorted(set(info["mode"]))
    l2, r2, pilot = outs["mts"]
    v["mts left"] = snr_db(host(inp["ml"])[0, 16384:-16384], host(l2)[0, 16384:-16384])
    v["mts right"] = snr_db(host(inp["mr"])[0, 16384:-16384], host(r2)[0, 16384:-16384])
    v["mts pilot"] = float(torch.mean(pilot))
    l_rx, r_rx, parity, bits = outs["mac-sound"]
    v["mac-sound left"] = snr_db(host(inp["pl"]), host(l_rx))
    v["mac-sound right"] = snr_db(host(inp["pr"]), host(r_rx))
    v["mac-sound parity errors"] = int(parity.sum())
    return v, outs


def check_sound(dev, card: str) -> dict:
    """Phase 4h: the sound layer at full width against the JAX package's
    values, each chain on the card against the CPU on a small input, TF32
    on bit-identical, and no host-blocking operation (A2's decision: its
    one stacked fetch).  Returns the callables phase 5h times."""
    import warnings

    import torch

    from color_modem_tpu_torch.frame import a2

    chains, inp = sound_chains(dev)
    v, outs = sound_values(chains, inp)
    for key, want in SOUND_PSNR.items():
        print(f"4h {key}: {v[key]:.4f} dB (expected {want} +- {PSNR_TOL}) on {card}")
        _check(abs(v[key] - want) <= PSNR_TOL, f"4h {key}: {v[key]} dB")
    for key, want in SOUND_SNR.items():
        print(f"4h {key} SNR: {v[key]:.4f} dB (expected {want} +- {SNR_TOL}) on {card}")
        _check(abs(v[key] - want) <= SNR_TOL, f"4h {key}: {v[key]} dB")
    print(f"4h rf-sound NICAM: {NICAM_FRAMES} frames, {v['nicam parity errors']} parity errors, "
          f"{v['nicam bit errors']} bit errors against the frames sent, FAW at bit "
          f"{v['nicam offset bits']} (expected {NICAM_OFFSET_BITS})")
    _check(inp["cap"] == NICAM_FRAMES and v["nicam parity errors"] == 0
           and v["nicam bit errors"] == 0 and v["nicam offset bits"] == NICAM_OFFSET_BITS,
           "4h NICAM on the RF hop")
    print(f"4h a2 modes: stereo {v['a2 stereo modes']}, dual {v['a2 dual modes']}, mono "
          f"{v['a2 mono modes']}; pilot {v['a2 stereo pilot']:.5f} (sent 0.05); mts pilot "
          f"{v['mts pilot']:.5f} (sent 0.1); mac-sound parity errors "
          f"{v['mac-sound parity errors']}")
    _check(v["a2 stereo modes"] == ["stereo"] and v["a2 dual modes"] == ["dual"]
           and v["a2 mono modes"] == ["mono"] and v["mac-sound parity errors"] == 0,
           "4h A2 modes or packet sound")
    _check(abs(v["a2 stereo pilot"] - 0.05) < 0.015 and abs(v["mts pilot"] - 0.1) < 0.02,
           "4h pilot levels")

    # each chain on the card against the CPU, 2 frames of 64 lines
    small = {d: sound_chains(torch.device(d), 2, 64, 64)[0] for d in ("cpu", dev.type)}
    for name, atol in SOUND_CPU_ATOL.items():
        got = _flat_outputs(small[dev.type][name][1](small[dev.type][name][0]()))
        want = _flat_outputs(small["cpu"][name][1](small["cpu"][name][0]()))
        e = max(_max_err(a.cpu().double(), b.double()) for a, b in zip(got, want))
        print(f"4h {name} on the card vs the CPU, 2x64 lines: max|diff| {e:.3e} (<= {atol})")
        _check(e <= atol, f"4h {name}: card and CPU disagree: {e}")

    # TF32 on for the whole process: the same outputs, bit for bit
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for name, (tx, rx) in chains.items():
            diff = max(_max_err(a.double(), b.double())
                       for a, b in zip(_flat_outputs(rx(tx())), _flat_outputs(outs[name])))
            print(f"TF32 on: {name} max|diff| to TF32 off {diff:.3e} (== 0)")
            _check(diff == 0.0, f"TF32 on changed {name}: {diff}")
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    # no host-blocking operation in any chain; a2_decode fetches once
    calls = {name: (lambda tx=tx, rx=rx: rx(tx())) for name, (tx, rx) in chains.items()}
    a2_rf = inp["a2_tx"]("dual")
    for fn in calls.values():
        fn()
    a2.a2_decode(inp["a2p"], a2_rf, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls.values():
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            a2.a2_decode(inp["a2p"], a2_rf, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(c.message) for c in caught if "synchronizing CUDA" in str(c.message)]
    print(f"4h no host-blocking operation in: {', '.join(calls)}; a2_decode: {len(syncs)} "
          "synchronising operation (1 expected: its stacked fetch)")
    _check(len(syncs) == 1, f"a2_decode syncs: {syncs}")
    return {name: (tx, rx, BATCH * (576 if name.startswith(("a2", "mac")) else 480) * N / 1e6)
            for name, (tx, rx) in chains.items()}


def time_sound(card: str, chains: dict) -> dict:
    """Phase 5h: CUDA-event times of each sound chain per 16 frames, whole
    and each half (transmit, receive), median [min, max] of 10 windows of
    20 calls, with Mpix/s of composite (or MAC) pixels."""
    from color_modem_tpu_torch.kernels.measure import time_ms

    times = {}
    for name, (tx, rx, mpix) in chains.items():
        sig = tx()
        for part, fn in (("hop", lambda: rx(tx())), ("transmit", tx), ("receive", partial(rx, sig))):
            t = _stats(time_ms(fn) + time_ms(fn))
            times[name, part] = t
            print(f"time {name} {part} {BATCH} frames on {card}: {_fmt(t, mpix)} "
                  "(median [min, max] of 10 windows of 20 calls)")
    return times


def check_video(dev, card: str) -> dict:
    """Phase 6: the chunked, resumable runner on the card."""
    import glob
    import warnings

    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source
    from color_modem_tpu_torch.modem.plan import make_plan

    src = synthetic_device_source(480, N, seed=0, device=dev)
    # on the card before any run, so no run's set-up copies it there
    plan = make_plan(NTSC(), N).to(dev)
    noise = {"noise_sigma": 0.02}
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, source, n_frames, **kw):
            kw = {"decoder": "comb3", "chunk": VIDEO_CHUNK, "backend": "kernel", **kw}
            return process_video(plan, source, n_frames, os.path.join(tmp, name),
                                 device=dev, **kw)

        label = f"video ntsc comb3 {VIDEO_FRAMES}x3x480x{N} chunk {VIDEO_CHUNK}"
        reset_counts()
        s = run("kernel", src, VIDEO_FRAMES)
        chunks = VIDEO_FRAMES // VIDEO_CHUNK
        got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks})
        _check(s["frames_processed_this_run"] == VIDEO_FRAMES, f"{label}: {s}")
        print(f"{label}: min_psnr_db {s['min_psnr_db']} (expected {VIDEO_MIN_PSNR} +- "
              f"{PSNR_TOL}), launches {got}, {s['mpix_per_s']} Mpix/s (first run, cold) on "
              f"{card}")
        _check(abs(s["min_psnr_db"] - VIDEO_MIN_PSNR) <= PSNR_TOL, f"{label}: {s}")
        again = run("kernel", src, VIDEO_FRAMES)
        _check(again["frames_processed_this_run"] == 0, f"resume processed frames: {again}")
        print(f"{label}: the second call resumed and processed 0 frames")
        # the host blocks on the card once per wave of chunks (the stacked
        # metrics fetch), never per chunk: channel noise, NR and the
        # parity-major comb3d included (the plan is already on the card)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run("sync", src, VIDEO_FRAMES, decoder="comb3d", interlaced=True,
                    channel=dict(noise), nr=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(c.message) for c in caught if "synchronizing CUDA" in str(c.message)]
        print(f"video interlaced comb3d noise 0.02 + nr, {VIDEO_FRAMES} frames in one wave: "
              f"{len(syncs)} synchronising CUDA operation(s) (1 expected: the wave's fetch)")
        _check(len(syncs) == 1, f"video runner syncs: {syncs}")
        plain = run("plain", src, VIDEO_FRAMES, backend="plain")
        _check(abs(plain["min_psnr_db"] - s["min_psnr_db"]) <= PSNR_TOL, f"plain: {plain}")
        # throughput of fresh runs, warm, in the order plain, kernel, kernel, plain, twice
        rates = {"kernel": [], "plain": []}
        for i, backend in enumerate(("plain", "kernel", "kernel", "plain") * 2):
            rates[backend].append(run(f"rate_{i}", src, VIDEO_FRAMES,
                                      backend=backend)["mpix_per_s"])
        print(f"{label}: kernel backend {_fmt_rate(rates['kernel'])} Mpix/s, plain backend "
              f"{_fmt_rate(rates['plain'])} Mpix/s (median [min, max] of 4 fresh runs), "
              f"on {card}")
        summaries.update(kernel=s, plain=plain, rates=rates)

        for name, kw in (("progressive comb3", {}),
                         ("interlaced comb3d", {"decoder": "comb3d", "interlaced": True})):
            outs = {}
            for chunk in (16, 12):
                d = f"{name} {chunk}".replace(" ", "_")
                run(d, src, INDEP_FRAMES, chunk=chunk, channel=dict(noise), nr=True,
                    save_outputs=True, **kw)
                outs[chunk] = np.concatenate([
                    np.load(f) for f in sorted(glob.glob(os.path.join(tmp, d, "rgb_*.npy")))])
            _check(outs[16].shape == (INDEP_FRAMES, 3, 480, N), f"{name}: {outs[16].shape}")
            e = float(np.abs(outs[16] - outs[12]).max())
            print(f"video {name} noise 0.02 + nr, {INDEP_FRAMES} frames: chunk 16 vs 12 "
                  f"max|diff| {e:.3e} (<= {CHUNK_ATOL})")
            _check(e <= CHUNK_ATOL, f"{name}: chunk-size dependent output: {e}")

        # the transmission hops between encode and decode
        for hop, (kw, expected) in VIDEO_HOP.items():
            label = f"video ntsc comb3 {hop} hop {VIDEO_FRAMES}x3x480x{N} chunk {VIDEO_CHUNK}"
            reset_counts()
            s_hop = run(f"hop_{hop}", src, VIDEO_FRAMES, **kw)
            got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks})
            print(f"{label}: min_psnr_db {s_hop['min_psnr_db']} (expected {expected} +- "
                  f"{PSNR_TOL}), launches {got}, {s_hop['mpix_per_s']} Mpix/s on {card}")
            _check(abs(s_hop["min_psnr_db"] - expected) <= PSNR_TOL, f"{label}: {s_hop}")
            summaries[hop] = s_hop
        for hop, (kw, atol) in HOP_CHUNK.items():
            outs = {}
            for chunk in (16, 12):
                d = f"hop {hop} {chunk}".replace(" ", "_")
                run(d, src, INDEP_FRAMES, chunk=chunk, save_outputs=True, **kw)
                outs[chunk] = np.concatenate([
                    np.load(f) for f in sorted(glob.glob(os.path.join(tmp, d, "rgb_*.npy")))])
            e = float(np.abs(outs[16] - outs[12]).max())
            print(f"video {hop} hop, {INDEP_FRAMES} frames: chunk 16 vs 12 max|diff| {e:.3e} "
                  f"(<= {atol})")
            _check(e <= atol, f"{hop} hop: chunk-size dependent output: {e}")

        # a soundtrack on the RF hop's FM sound carrier, progressive and
        # interlaced, against the JAX runner
        track = _tone(((700.0, 0.5), (4000.0, 0.3)), VIDEO_FRAMES * 480 * N, plan.fs)
        for form, (want_q, want_snr) in VIDEO_AUDIO.items():
            label = f"video ntsc comb3 {form} rf hop + rf_audio {VIDEO_FRAMES}x3x480x{N}"
            reset_counts()
            s_aud = run(f"audio_{form}", src, VIDEO_FRAMES, rf=True, rf_audio=track,
                        interlaced=form == "interlaced")
            got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks})
            rx = np.concatenate([np.load(f) for f in sorted(
                glob.glob(os.path.join(tmp, f"audio_{form}", "aud_*.npy")))])
            _check(rx.shape == track.shape, f"{label}: audio {rx.shape}")
            q_snr = snr_db(track[8192:-8192], rx[8192:-8192])
            print(f"{label}: min_psnr_db {s_aud['min_psnr_db']} (expected {want_q} +- "
                  f"{PSNR_TOL}), audio SNR {q_snr:.4f} dB (expected {want_snr} +- {SNR_TOL}), "
                  f"launches {got}, {s_aud['mpix_per_s']} Mpix/s on {card}")
            _check(abs(s_aud["min_psnr_db"] - want_q) <= PSNR_TOL
                   and abs(q_snr - want_snr) <= SNR_TOL, f"{label}: {s_aud}, {q_snr}")
            summaries[f"rf_audio {form}"] = s_aud
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run("audio_sync", src, VIDEO_FRAMES, rf=True, rf_audio=track)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(c.message) for c in caught if "synchronizing CUDA" in str(c.message)]
        print(f"video rf hop + rf_audio, {VIDEO_FRAMES} frames in one wave: {len(syncs)} "
              "synchronising CUDA operation(s) (1 expected: the wave's fetch, audio included)")
        _check(len(syncs) == 1, f"video runner with rf_audio syncs: {syncs}")
        outs, auds = {}, {}
        for chunk in (16, 12):
            d = os.path.join(tmp, f"audio_chunk_{chunk}")
            run(d, src, INDEP_FRAMES, chunk=chunk, rf=True, save_outputs=True,
                rf_audio=track[: INDEP_FRAMES * 480 * N])
            outs[chunk] = np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/rgb_*.npy"))])
            auds[chunk] = np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/aud_*.npy"))])
        e_aud = float(np.abs(auds[16] - auds[12]).max())
        e_rgb = float(np.abs(outs[16] - outs[12]).max())
        print(f"video rf hop + rf_audio, {INDEP_FRAMES} frames: chunk 16 vs 12 max|diff| audio "
              f"{e_aud:.3e} (<= {AUDIO_CHUNK_ATOL}), frames {e_rgb:.3e} "
              f"(<= {HOP_CHUNK['rf'][1]})")
        _check(e_aud <= AUDIO_CHUNK_ATOL and e_rgb <= HOP_CHUNK["rf"][1],
               f"rf_audio: chunk-size dependent output: {e_aud}, {e_rgb}")

        static = full_scene(480, dev)
        raw = run("raw", lambda start, count: static[:count], BATCH, channel=dict(noise))
        den = run("den", lambda start, count: static[:count], BATCH, channel=dict(noise),
                  nr=True)
        gain = den["min_psnr_db"] - raw["min_psnr_db"]
        print(f"video nr on a noisy static source: {raw['min_psnr_db']} -> "
              f"{den['min_psnr_db']} dB, gain {gain:.2f} dB (> {NR_GAIN_DB})")
        _check(gain > NR_GAIN_DB, f"video NR gain {gain} dB")
    return summaries


def main() -> None:
    import numpy as np
    import torch

    # --- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from color_modem_tpu_torch import NIIR, NTSC, PAL
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels.build import load_library
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

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

    # --- 3b. the FIRs alone, and SECAM kernels vs plain on the card -------
    check_fir(dev)
    check_band_fir(dev)
    max_err["secam_encode"], max_err["secam_decode"] = 0.0, 0.0
    for frames, n in ((BATCH, N), (4, 2 * N)):
        e_enc, e_rgb = check_secam_kernels(dev, frames, n)
        max_err["secam_encode"] = max(max_err["secam_encode"], e_enc)
        max_err["secam_decode"] = max(max_err["secam_decode"], e_rgb)

    # --- 4. main path; 4b. the SECAM path -------------------------------------
    paths = {}
    rt_k, rt_p, launches = check_path(dev, "ntsc", "comb3", PSNR_EXPECTED, QAM_1_1)
    paths["ntsc", "comb3"] = (rt_k, rt_p)
    for decoder, expected in SECAM_PSNR.items():
        rt_k, rt_p, got = check_path(dev, "secam", decoder, expected, SECAM_1_1)
        if decoder == "interp":
            launches.update({k: got[k] for k in SECAM_1_1})
            paths["secam", decoder] = (rt_k, rt_p)

    # --- 4c. the rest of the QAM family ---------------------------------------
    for (name, decoder), (expected, (n_enc, n_dec)) in QAM_FAMILY.items():
        rt_k, rt_p, got = check_path(dev, name, decoder, expected,
                                     {"qam_encode": n_enc, "qam_decode": n_dec})
        paths[name, decoder] = (rt_k, rt_p)
        if (name, decoder) == ("pal", "delayline"):
            # the _shared forms: the same CUDA kernels with equal tile arrays
            launches["qam_encode_shared"] = got["qam_encode"]
            launches["qam_decode_shared"] = got["qam_decode"]

    # --- 4d. raster, channel and the receiver's countermeasures -----------------
    check_channel(dev)

    # --- 4e. the frame layer ----------------------------------------------------
    timed = check_frame_layer(dev)

    # --- 4f. TF32 switched on for the whole process ------------------------------
    check_tf32_on(dev, paths)

    # --- 4g. the transmission layer ---------------------------------------------
    hops = check_transmission(dev, card)

    # --- 4h. the sound layer ----------------------------------------------------
    sound = check_sound(dev, card)

    # --- 5. timing: main path and SECAM; 5c. PAL/NIIR; 5e. frame layer ---------
    times = {}
    for name, decoder in (("ntsc", "comb3"), ("secam", "interp"), ("pal", "delayline"),
                          ("niir", "avg")):
        times[name] = time_path(dev, card, name, decoder, paths)
    time_frame_layer(card, timed)
    time_transmission(card, hops)
    time_sound(card, sound)

    # --- 6. the video runner ----------------------------------------------------
    check_video(dev, card)

    _check("jax" not in sys.modules, "the port loaded jax")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    # entry -> (its CUDA kernel, the path it is timed on, the Pallas kernel)
    replaces = {
        "qam_encode": ("qam_encode", "ntsc", "color_modem_tpu/kernels/qam.py:85"),
        "qam_decode": ("qam_decode", "ntsc", "color_modem_tpu/kernels/qam.py:129"),
        "qam_encode_shared": ("qam_encode", "pal", "color_modem_tpu/kernels/qam.py:98"),
        "qam_decode_shared": ("qam_decode", "pal", "color_modem_tpu/kernels/qam.py:115"),
        "secam_encode": ("secam_encode", "secam", "color_modem_tpu/kernels/secam.py:118"),
        "secam_decode": ("secam_decode", "secam", "color_modem_tpu/kernels/secam.py:231"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"color_modem_tpu_torch/csrc/{kernel}.cu",
         "replaces": where, "launches": launches[name],
         "max_abs_err": max_err[kernel], "ms": times[path][kernel]["kernel"][0],
         "plain_ms": times[path][kernel]["plain"][0],
         "bound_ms": times[path][kernel]["bound"][0],
         "bound_by": times[path][kernel]["bound"][1],
         "library_ms": (times[path][kernel]["library"][0]
                        if times[path][kernel]["library"] else None),
         "ms_spread": list(times[path][kernel]["kernel"][1:]),
         "plain_ms_spread": list(times[path][kernel]["plain"][1:])}
        for name, (kernel, path, where) in replaces.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
