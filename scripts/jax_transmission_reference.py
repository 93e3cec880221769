"""The JAX package's values that ``chip_smoke.py`` phases 4g, 4h, 4i and 6
hold the PyTorch port's transmission, sound and data-service layers to,
computed by the JAX ``xla`` path on the CPU at the card's shapes.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/jax_transmission_reference.py [--only NAME ...]

Prints one JSON object per row as it finishes.  Rows:

* ``rf-vsb-hop``: NTSC composite (notch encode of ``smooth_scene(480, 720,
  seed=0)`` broadcast to 16 frames) through ``rf_roundtrip``: transparency
  over lines [2:-2], as ``scripts/chip_matrix_r02.py`` measures it;
* ``satellite-fm-hop``: the same composite through ``fm_modulate`` ->
  ``fm_demodulate``;
* ``d2mac``: the MAC round trip of ``smooth_scene(576, 720, seed=0)`` x 16,
  absolute lines ``b*625 + l``;
* ``mac-satellite``: those MAC lines through the satellite hop
  (``make_sat_plan(20.25e6, 1296)``), transparency;
* ``rf-ghost-gcr``: the rf-vsb-hop composite through an RF ghost (3 us,
  gain 0.3), then the GCR equalizer (guarded record through the same
  chain, 1281 taps, reg 1e-4, pivot ``video_zero``): PSNR before and after,
  and after with the same design done in float64 NumPy;
* ``tbc``: rastered NTSC comb3 of ``smooth_scene(480, 720, seed=0)`` x 16,
  0.3 us wobble, then ``tbc_correct``: RGB PSNR clean, wrecked, fixed;
* ``video-rf`` / ``video-satellite`` / ``video-channel-noise``:
  ``process_video`` NTSC comb3 on ``synthetic_device_source(480, 720,
  seed=0)``, 48 frames in chunks of 16, with ``rf=True`` / ``satellite=True,
  sat_cnr=12.0`` / ``channel={"noise_sigma": 0.02}``: ``min_psnr_db``;
* ``cli-noisy-rf``: the JAX CLI's ``roundtrip --demo --pattern scene
  --standard ntsc --decoder comb3 --noise 0.02 --rf --rf-noise 0.01
  --rf-dropouts 0.05 --rf-doc`` at full height (composite noise, RF noise
  and tape dropouts): ``psnr_db``;
* ``rf-sound``: the rf-vsb-hop composite through ``rf_modulate`` ->
  ``sound_on_rf`` (1 kHz at 0.6 plus 7 kHz at 0.3 over the 16 frames'
  joined stream, phi0 0) -> ``nicam_on_rf`` (800 and 2300 Hz at 0.5 at
  32 kHz, ``nicam_capacity`` frames) -> ``rf_demodulate``, ``sound_from_rf``
  and ``nicam_from_rf``: transparency over lines [2:-2], the FM audio SNR,
  NICAM parity errors, offset and L/R SNR;
* ``sat-sound``: the same composite through ``fm_modulate(audio=)`` with
  ``make_sat_plan(fs, 720, audio_subs=2)`` and whole-cycle tones of ~1 kHz
  (0.6) and ~3 kHz (0.5): transparency and each subcarrier's SNR;
* ``a2``: PAL delayline encode of ``smooth_scene(576, 720, seed=0)`` x 16,
  A2 stereo (L = 0.6 sin 800 Hz + 0.2 sin 5 kHz, R = 0.5 sin 2.3 kHz per
  frame), dual (L and R as two programs) and mono (carrier 1 only)
  through ``a2_decode``: the modes, stereo and dual L/R SNR (8192 samples
  cropped at each frame's ends), the pilot level;
* ``mts``: the rf-vsb-hop composite with an MTS multiplex (L 0.7 sin 1 kHz,
  R 0.5 sin 3 kHz per frame) on ``make_rf_plan(audio_bw=50e3)`` through
  ``rf_modulate(audio=)`` -> ``rf_demodulate_sound`` -> ``mts_decode``:
  L/R SNR (16384 cropped), the pilot level;
* ``mac-sound``: D2-MAC packet sound over 16 x 576 lines (``pack_sound``
  of 440 Hz at 0.7 and 997 Hz at 0.5, 32 kHz) through the satellite hop
  (``make_sat_plan(20.25e6, 1296)``) and ``unpack_sound``: bit errors,
  parity errors, L/R SNR;
* ``video-rf-audio`` / ``video-rf-audio-interlaced``: the ``video-rf`` run
  (interlaced for the second) with a soundtrack of 0.5 sin 700 Hz + 0.3
  sin 4 kHz: ``min_psnr_db`` and the audio SNR (8192 cropped at the
  track's ends).

The SECAM round trip at the chip matrix's width (phase 4b):

* ``secam-interp-1440``: SECAM ``interp`` of ``smooth_scene(576, 1440,
  seed=0)`` x 16 at frame 0: the round-trip PSNR over the batch.

The data services and instruments (phase 4i; every composite from the
``comb3`` pipeline of ``smooth_scene(L, N, seed=0)`` x 16 at frame 0):

* ``caption``: NTSC 480x720, frame f's row 0 carrying cell f of
  :data:`CAPTION_TEXT`: the picture PSNR over rows 1:, the cells decoded;
* ``teletext-wss-vitc``: PAL 576x1440, rows 0-2 of every frame a page
  (magazine 1, page 0x00, header ``P100 PAL`` and :data:`TELETEXT_ROWS`),
  row 3 WSS ``16:9 full (anamorphic)``, row 4 VITC (frame f's timecode):
  the picture PSNR over rows 5:, every service decoded;
* ``scramble``: NTSC 480x720, ``cutrotate`` with :data:`SCRAMBLE_KEY`: the
  subscriber's (descrambled) and the pirate's round-trip PSNR;
* ``vir``: NTSC 480x720, rows 0-1 VIR lines, a 25-degree chroma phase error
  and gain 0.7 (``impair``): the readout, the uncorrected and the
  VIR-corrected PSNR over rows 2:;
* ``measure``: NTSC 480x720 (``notch`` encode): the staircase through
  ``impair(diff_gain=0.3, diff_phase_deg=20)`` (DG, DP), the multiburst
  through ``vhs_playback`` and a ``comb3`` decode (per-packet gains of the
  decoded luma), the pulse-and-bar through a 1 us, 0.25 ghost (K-rating,
  P/B, chroma/luma gain and delay);
* ``palplus``: PAL 576x720 of :func:`palplus_scene`, progressive and
  interlaced, with and without the raster: the helper and zoom PSNRs;
* ``fullstack-nicam`` / ``fullstack-a2``: ``cli.py roundtrip`` with
  ``tests/test_fullstack.py``'s flags at 576 lines: the picture and pirate
  PSNRs, the sound SNRs, every service exact;
* ``video-caption``, ``video-scramble``, ``video-caption-scramble-rf`` and
  ``video-caption-scramble-interlaced``: the ``video-rf`` runner with
  :func:`video_caption_bits` and/or ``scramble=("cutrotate",
  SCRAMBLE_KEY)``: ``min_psnr_db``, the caption cells exact.

SNRs compare with each signal's own mean removed (the receivers are
AC-coupled or DC-exact).

This script imports JAX; the port and ``chip_smoke.py`` do not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, N = 16, 720
#: the data services' stimuli; chip_smoke.py phase 4i uses the same
CAPTION_TEXT = "CLOSED CAPTIONS RIDE LINE 21 OK!"
TELETEXT_ROWS = ("HELLO WORLD", "ROW TWO")
WSS_ASPECT = "16:9 full (anamorphic)"
SCRAMBLE_KEY = 0x5EC4E7
VIDEO_CAPTION = ("THE RUNNER CARRIES ONE CAPTION CELL PER FRAME ON ROW 0. " * 2)[:96]


def video_caption_bits():
    """(48, 16) cells of :data:`VIDEO_CAPTION`, one per frame."""
    import numpy as np

    from color_modem_tpu.frame.vbi import cc_pack

    return np.stack([np.asarray(cc_pack(VIDEO_CAPTION[2 * i : 2 * i + 2])) for i in range(48)])


def palplus_scene(lines: int, n: int):
    """``smooth_scene(lines, n, seed=0)`` plus helper-band vertical detail
    (tests/test_golden_palplus.py's fixture), clipped to [0, 1]."""
    import numpy as np

    from color_modem_tpu.utils.testimages import smooth_scene

    vert = 0.25 * np.cos(2 * np.pi * 0.42 * np.arange(lines)[:, None])
    return np.clip(smooth_scene(lines, n, seed=0) + vert[None], 0.0, 1.0).astype(np.float32)


def _composite():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(NTSC(), N)
    rgb = jnp.asarray(np.broadcast_to(smooth_scene(480, N, seed=0), (B, 3, 480, N)),
                      jnp.float32)
    enc, _, _ = make_pipeline(plan, "notch", "xla")
    return plan, np.asarray(enc(rgb, 0))


def row_rf():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.rf import make_rf_plan, rf_roundtrip
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    out = np.asarray(rf_roundtrip(make_rf_plan(plan), jnp.asarray(comp), 0))
    return {"transparency_db": psnr(out[:, 2:-2], comp[:, 2:-2])}


def row_satellite():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    sp = sat.make_sat_plan(plan.fs, N)
    out = np.asarray(sat.fm_demodulate(sp, sat.fm_modulate(sp, jnp.asarray(comp))))
    return {"transparency_db": psnr(out, comp)}


def _mac():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.modem import mac
    from color_modem_tpu.utils.testimages import smooth_scene

    mplan = mac.make_mac_plan(N)
    rgb = jnp.asarray(np.broadcast_to(smooth_scene(576, N, seed=0), (B, 3, 576, N)),
                      jnp.float32)
    g = jnp.arange(B)[:, None] * mplan.cfg.total_lines + jnp.arange(576)
    return mac, mplan, rgb, g


def row_d2mac():
    import numpy as np

    from color_modem_tpu.utils.metrics import psnr

    mac, mplan, rgb, g = _mac()
    return {"psnr_db": psnr(np.asarray(mac.roundtrip(mplan, rgb, g)), np.asarray(rgb))}


def row_mac_satellite():
    import numpy as np

    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.utils.metrics import psnr

    mac, mplan, rgb, g = _mac()
    sig = mac.encode(mplan, rgb, g)
    sp = sat.make_sat_plan(mplan.cfg.fs, mplan.cfg.samples_per_line)
    rx = np.asarray(sat.fm_demodulate(sp, sat.fm_modulate(sp, sig)))
    return {"transparency_db": psnr(rx, np.asarray(sig)),
            "picture_db": psnr(np.asarray(mac.decode(mplan, rx, g)), np.asarray(rgb))}


def row_rf_ghost():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.equalize import (
        apply_equalizer,
        design_equalizer,
        gcr_record_guarded,
    )
    from color_modem_tpu.frame.rf import make_rf_plan, rf_demodulate, rf_ghost, rf_modulate
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    rfp = make_rf_plan(plan)

    def chain(c):
        return np.asarray(rf_demodulate(rfp, rf_ghost(rfp, rf_modulate(rfp, jnp.asarray(c), 0),
                                                      3.0, 0.30), 0))

    ghosted = chain(comp)
    pv = rfp.video_zero
    rx = chain(gcr_record_guarded(plan)[None])[0][:3]
    taps = design_equalizer(plan, jnp.asarray(rx), ntaps=1281, reg=1e-4, pivot=pv)
    eq = np.asarray(apply_equalizer(jnp.asarray(ghosted), taps, pivot=pv))
    # the same ridge design in float64 NumPy: at reg 1e-4 the equalized
    # PSNR moves by ~0.1 dB with the float32 rounding of the design
    from color_modem_tpu.dsp.design import tukey
    from color_modem_tpu.frame.equalize import gcr_line

    r = rx[1:].reshape(-1).astype(np.float64) - pv
    s = gcr_line(plan, r.shape[-1]).astype(np.float64) - pv
    S, R = np.fft.rfft(s), np.fft.rfft(r)
    ps2 = np.abs(S) ** 2
    den = ps2 + 1e-4 * ps2.mean()
    H = R * np.conj(S) / den + (1.0 - ps2 / den)
    e = np.fft.irfft(np.conj(H) / (np.abs(H) ** 2 + 1e-4 * np.mean(np.abs(H) ** 2)),
                     n=r.shape[-1])
    t64 = np.concatenate([e[-640:], e[:641]]) * tukey(1281, alpha=0.4)
    eq64 = np.asarray(apply_equalizer(jnp.asarray(ghosted), jnp.asarray(t64, jnp.float32),
                                      pivot=pv))
    return {"ghosted_db": psnr(ghosted[:, 2:-2], comp[:, 2:-2]),
            "equalized_db": psnr(eq[:, 2:-2], comp[:, 2:-2]),
            "equalized_f64_design_db": psnr(eq64[:, 2:-2], comp[:, 2:-2])}


def row_tbc():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu.frame.raster import make_raster
    from color_modem_tpu.frame.timebase import impair_timebase, tbc_correct
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.metrics import psnr
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(NTSC(), N)
    rgb = np.broadcast_to(smooth_scene(480, N, seed=0), (B, 3, 480, N)).astype(np.float32)
    enc, dec, _ = make_pipeline(plan, "comb3", "xla", raster=True)
    ras = enc(jnp.asarray(rgb), 0)
    shifted, _ = impair_timebase(plan, ras, wobble_us=0.3)
    fixed = tbc_correct(plan, make_raster(plan), shifted, frame_line_index(plan, 0, B, 480))
    return {name: psnr(np.asarray(dec(x, 0)), rgb)
            for name, x in (("clean_db", ras), ("wrecked_db", shifted), ("fixed_db", fixed))}


def _video(**kw):
    from color_modem_tpu.frame.video import process_video, synthetic_device_source
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC

    with tempfile.TemporaryDirectory() as d:
        s = process_video(make_plan(NTSC(), N), synthetic_device_source(480, N, seed=0), 48, d,
                          decoder="comb3", chunk=16, backend="xla", **kw)
    return {"min_psnr_db": s["min_psnr_db"]}


def row_cli_noisy_rf():
    import contextlib
    import io

    from color_modem_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["roundtrip", "--demo", "--pattern", "scene", "--standard", "ntsc",
                  "--decoder", "comb3", "--noise", "0.02", "--rf", "--rf-noise", "0.01",
                  "--rf-dropouts", "0.05", "--rf-doc"])
    return {"psnr_db": json.loads(out.getvalue().strip().splitlines()[-1])["psnr_db"]}


def snr_db(ref, out) -> float:
    """Signal-to-error ratio of ``out`` against ``ref``, each with its own
    mean removed (``chip_smoke.py`` computes it the same way)."""
    import numpy as np

    ref = np.asarray(ref, np.float64)
    ref = ref - ref.mean()
    out = np.asarray(out, np.float64)
    err = (out - out.mean()) - ref
    return float(10.0 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30)))


def _tone(freqs_amps, n: int, fs: float):
    import numpy as np

    t = np.arange(n) / fs
    return sum(a * np.sin(2 * np.pi * f * t) for f, a in freqs_amps).astype(np.float32)


def row_rf_sound():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import nicam
    from color_modem_tpu.frame.rf import (make_rf_plan, rf_demodulate, rf_modulate,
                                          sound_from_rf, sound_on_rf)
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    rfp = make_rf_plan(plan)
    audio = _tone(((1000.0, 0.6), (7000.0, 0.3)), B * 480 * N, plan.fs).reshape(B, 480 * N)
    cap = nicam.nicam_capacity(rfp, (B, 480, N * rfp.r))
    nl = _tone(((800.0, 0.5),), 32 * cap, 32000.0)
    nr = _tone(((2300.0, 0.5),), 32 * cap, 32000.0)
    rf = rf_modulate(rfp, jnp.asarray(comp), 0)
    rf = sound_on_rf(rfp, rf, 0, jnp.asarray(audio), 0.0)
    rf = nicam.nicam_on_rf(rfp, rf, nl, nr)
    out = np.asarray(rf_demodulate(rfp, rf, 0))
    aud = np.asarray(sound_from_rf(rfp, rf, 0))
    l_rx, r_rx, rep, lock = nicam.nicam_from_rf(rfp, rf, cap)
    return {"transparency_db": psnr(out[:, 2:-2], comp[:, 2:-2]),
            "fm_audio_snr_db": snr_db(audio.reshape(-1)[8000:-8000],
                                      aud.reshape(-1)[8000:-8000]),
            "nicam_frames": int(cap),
            "nicam_parity_errors": int(np.asarray(rep["parity_errors"]).sum()),
            "nicam_offset_bits": int(lock["offset_bits"]),
            "nicam_left_snr_db": snr_db(nl, l_rx), "nicam_right_snr_db": snr_db(nr, r_rx)}


def row_sat_sound():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import satellite as sat
    from color_modem_tpu.utils.metrics import psnr

    plan, comp = _composite()
    sp = sat.make_sat_plan(plan.fs, N, audio_subs=2)
    n_tot = 480 * N

    def bin_tone(f, amp):
        k = max(1, round(f * n_tot / plan.fs))
        return amp * np.sin(2 * np.pi * k * np.arange(n_tot) / n_tot)

    a = np.broadcast_to(np.stack([bin_tone(1000.0, 0.6), bin_tone(3000.0, 0.5)]),
                        (B, 2, n_tot)).astype(np.float32)
    rf = sat.fm_modulate(sp, jnp.asarray(comp), audio=jnp.asarray(a))
    out = np.asarray(sat.fm_demodulate(sp, rf))
    aud = np.asarray(sat.fm_demodulate_audio(sp, rf))
    return {"transparency_db": psnr(out, comp),
            "audio_snr_db": [snr_db(a[0, j], aud[0, j]) for j in range(2)],
            "subcarriers_hz": list(sp.sub_freqs)}


def row_a2():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import a2
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.frame.rf import make_rf_plan, rf_modulate
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import PAL
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(PAL(), N)
    rgb = jnp.asarray(np.broadcast_to(smooth_scene(576, N, seed=0), (B, 3, 576, N)),
                      jnp.float32)
    enc, _, _ = make_pipeline(plan, "delayline", "xla")
    comp = enc(rgb, 0)
    rfp = make_rf_plan(plan)
    a2p = a2.make_a2_plan(rfp)
    t_item = 576 * N
    left = np.broadcast_to(_tone(((800.0, 0.6), (5000.0, 0.2)), t_item, plan.fs), (B, t_item))
    right = np.broadcast_to(_tone(((2300.0, 0.5),), t_item, plan.fs), (B, t_item))
    crop = 8192

    def snrs(ref, got):
        return [snr_db(ref[i, crop:-crop], np.asarray(got)[i, crop:-crop]) for i in (0, B - 1)]

    res = {}
    rf = a2.a2_on_rf(a2p, rf_modulate(rfp, comp, 0, jnp.asarray(0.5 * (left + right))), 0,
                     jnp.asarray(right), "stereo")
    gl, gr, info = a2.a2_decode(a2p, rf, 0)
    res["stereo"] = {"modes": sorted(set(info["mode"])), "left_snr_db": snrs(left, gl),
                     "right_snr_db": snrs(right, gr),
                     "pilot_level": float(np.mean(info["pilot_level"]))}
    rf = a2.a2_on_rf(a2p, rf_modulate(rfp, comp, 0, jnp.asarray(left)), 0,
                     jnp.asarray(right), "dual")
    g1, g2, info = a2.a2_decode(a2p, rf, 0)
    res["dual"] = {"modes": sorted(set(info["mode"])), "left_snr_db": snrs(left, g1),
                   "right_snr_db": snrs(right, g2)}
    _, _, info = a2.a2_decode(a2p, rf_modulate(rfp, comp, 0, jnp.asarray(left)), 0)
    res["mono"] = {"modes": sorted(set(info["mode"]))}
    return res


def row_mts():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.mts import mts_decode, mts_encode
    from color_modem_tpu.frame.rf import make_rf_plan, rf_demodulate_sound, rf_modulate

    plan, comp = _composite()
    t_item = 480 * N
    left = np.broadcast_to(_tone(((1000.0, 0.7),), t_item, plan.fs), (B, t_item))
    right = np.broadcast_to(_tone(((3000.0, 0.5),), t_item, plan.fs), (B, t_item))
    rfp = make_rf_plan(plan, audio_bw=50e3)
    a = mts_encode(plan, jnp.asarray(left), jnp.asarray(right))
    l2, r2, pilot = mts_decode(plan, rf_demodulate_sound(
        rfp, rf_modulate(rfp, jnp.asarray(comp), 0, a), 0))
    crop = 16384
    return {"left_snr_db": snr_db(left[0, crop:-crop], np.asarray(l2)[0, crop:-crop]),
            "right_snr_db": snr_db(right[0, crop:-crop], np.asarray(r2)[0, crop:-crop]),
            "pilot_level": float(np.mean(np.asarray(pilot)))}


def row_mac_sound():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import satellite as sat

    mac, mplan, rgb, g = _mac()
    n_lines = B * 576
    n_f = mac.sound_capacity(mplan, n_lines)
    left = _tone(((440.0, 0.7),), 32 * n_f, 32000.0)
    right = _tone(((997.0, 0.5),), 32 * n_f, 32000.0)
    payload, n_f = mac.pack_sound(mplan, jnp.asarray(left), jnp.asarray(right), n_lines)
    payload = payload.reshape(B, 576, -1)
    sig = mac.encode(mplan, rgb, g, payload)
    sp = sat.make_sat_plan(mplan.cfg.fs, mplan.cfg.samples_per_line)
    ok, bits = mac.decode_data(mplan, sat.fm_demodulate(sp, sat.fm_modulate(sp, sig)))
    gl, gr, rep = mac.unpack_sound(mplan, bits, n_f)
    return {"audio_frames": int(n_f), "sync_ok_lines": int(np.asarray(ok).sum()),
            "bit_errors": int(np.asarray(bits != payload).sum()),
            "parity_errors": int(np.asarray(rep["parity_errors"]).sum()),
            "left_snr_db": snr_db(left, gl), "right_snr_db": snr_db(right, gr)}


def _video_audio(interlaced: bool):
    import glob

    import numpy as np

    from color_modem_tpu.frame.video import process_video, synthetic_device_source
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC

    plan = make_plan(NTSC(), N)
    aud = _tone(((700.0, 0.5), (4000.0, 0.3)), 48 * 480 * N, plan.fs)
    with tempfile.TemporaryDirectory() as d:
        s = process_video(plan, synthetic_device_source(480, N, seed=0), 48, d,
                          decoder="comb3", chunk=16, backend="xla", rf=True, rf_audio=aud,
                          interlaced=interlaced)
        got = np.concatenate([np.load(p) for p in sorted(glob.glob(d + "/aud_*.npy"))])
    return {"min_psnr_db": s["min_psnr_db"],
            "audio_snr_db": snr_db(aud[8192:-8192], got[8192:-8192])}


def _frames(std, lines: int, n: int, decoder: str = "comb3"):
    """(plan, (B, 3, L, N) scene, encode, decode) of ``std`` at L x N."""
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.utils.testimages import smooth_scene

    plan = make_plan(std, n)
    rgb = jnp.asarray(np.broadcast_to(smooth_scene(lines, n, seed=0), (B, 3, lines, n)),
                      jnp.float32)
    enc, dec, _ = make_pipeline(plan, decoder, "xla")
    return plan, rgb, enc, dec


def row_secam_interp_1440():
    import numpy as np

    from color_modem_tpu.standards import SECAM
    from color_modem_tpu.utils.metrics import psnr

    _, rgb, enc, dec = _frames(SECAM(), 576, 2 * N, "interp")
    return {"psnr_db": psnr(np.asarray(dec(enc(rgb, 0), 0)), np.asarray(rgb))}


def row_caption():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.vbi import cc_pack, cc_spec, decode_data_line, encode_data_line
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.metrics import psnr

    plan, rgb, enc, dec = _frames(NTSC(), 480, N)
    spec = cc_spec(plan)
    bits = np.stack([np.asarray(cc_pack(CAPTION_TEXT[2 * i : 2 * i + 2])) for i in range(B)])
    comp = enc(rgb, 0).at[:, 0, :].set(encode_data_line(plan, spec, jnp.asarray(bits)))
    got, margin = decode_data_line(plan, spec, comp[:, 0, :])
    out = np.asarray(dec(comp, 0))
    return {"psnr_db": psnr(out[:, :, 1:], np.asarray(rgb)[:, :, 1:]),
            "exact": bool(np.array_equal(np.asarray(got), bits)),
            "worst_margin": float(np.asarray(margin).min())}


def row_teletext_wss_vitc():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import teletext, vitc, wss
    from color_modem_tpu.standards import PAL
    from color_modem_tpu.utils.metrics import psnr

    plan, rgb, enc, dec = _frames(PAL(), 576, 2 * N)
    page = teletext.encode_page(plan, 1, 0x00, list(TELETEXT_ROWS), header="P100 PAL")
    tcs = np.stack([vitc.vitc_pack(*vitc.timecode_for_frame(f)) for f in range(B)])
    comp = enc(rgb, 0)
    comp = comp.at[:, :3, :].set(jnp.broadcast_to(page, (B,) + page.shape))
    comp = comp.at[:, 3, :].set(wss.encode_wss(plan, jnp.broadcast_to(
        wss.wss_word(WSS_ASPECT), (B, 14))))
    comp = comp.at[:, 4, :].set(vitc.encode_vitc_line(plan, jnp.asarray(tcs)))
    out = np.asarray(dec(comp, 0))
    pkts = teletext.decode_packets(plan, comp[:, :3, :].reshape(3 * B, -1))
    wss_bits, _ = wss.decode_wss(plan, comp[:, 3, :])
    vitc_bits, score = vitc.decode_vitc_line(plan, comp[:, 4, :])
    return {
        "psnr_db": psnr(out[:, :, 5:], np.asarray(rgb)[:, :, 5:]),
        "teletext_exact": all(p.address_ok and bool(p.parity_ok.all()) for p in pkts)
        and [p.text.rstrip() for p in pkts] == ["P100 PAL", *TELETEXT_ROWS] * B,
        "wss_exact": all(wss.parse_wss(b)["aspect"] == WSS_ASPECT
                         for b in np.asarray(wss_bits)),
        "vitc_exact": bool(np.array_equal(np.asarray(vitc_bits), tcs)),
        "vitc_min_score": int(np.asarray(score).min()),
    }


def row_scramble():
    import numpy as np

    from color_modem_tpu.frame.pipeline import frame_line_index
    from color_modem_tpu.frame.scramble import descramble, scramble
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.metrics import psnr

    plan, rgb, enc, dec = _frames(NTSC(), 480, N)
    g = frame_line_index(plan, 0, B, 480)
    scr = scramble(plan, enc(rgb, 0), g, "cutrotate", SCRAMBLE_KEY)
    sub = dec(descramble(plan, scr, g, "cutrotate", SCRAMBLE_KEY), 0)
    return {"subscriber_db": psnr(np.asarray(sub), np.asarray(rgb)),
            "pirate_db": psnr(np.asarray(dec(scr, 0)), np.asarray(rgb))}


def row_vir():
    import numpy as np

    from color_modem_tpu.frame.channel import impair
    from color_modem_tpu.frame.pipeline import decode_block, frame_line_index
    from color_modem_tpu.frame.vir import decode_vir_corrected, measure_vir, vir_lines
    from color_modem_tpu.standards import NTSC
    from color_modem_tpu.utils.metrics import psnr

    plan, rgb, enc, _ = _frames(NTSC(), 480, N)
    g = frame_line_index(plan, 0, B, 480)
    comp = enc(rgb, 0).at[:, :2, :].set(vir_lines(plan, g[:, :2]))
    bad = impair(plan, comp, chroma_phase_deg=25.0, chroma_gain=0.7)
    rep = measure_vir(plan, bad[:, :2], g[:, :2])
    ref = np.asarray(rgb)[:, :, 2:]
    corr = np.asarray(decode_vir_corrected(plan, bad, g, 2, "comb3"))
    plain = np.asarray(decode_block(plan, bad[:, 2:], g[:, 2:], "comb3"))
    return {"phase_err_deg": float(np.degrees(np.asarray(rep["phase_err"])).mean()),
            "chroma_gain_corr": float(np.asarray(rep["chroma_gain_corr"]).mean()),
            "corrected_db": psnr(corr, ref), "uncorrected_db": psnr(plain, ref)}


def row_measure():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame import measure
    from color_modem_tpu.frame.channel import impair, vhs_playback
    from color_modem_tpu.frame.pipeline import decode_block, encode_block, frame_line_index
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC

    plan = make_plan(NTSC(), N)
    g = frame_line_index(plan, 0, B, 480)

    def enc(stim):
        return encode_block(plan, jnp.asarray(np.broadcast_to(stim, (B,) + stim.shape)), g)

    dif = measure.measure_differential(plan, impair(
        plan, enc(measure.modulated_staircase(plan, 480, N)), diff_gain=0.3,
        diff_phase_deg=20.0), g)
    rgb = np.asarray(decode_block(plan, vhs_playback(plan, enc(measure.multiburst(plan, 480))),
                                  g, "comb3"))
    y = np.tensordot(plan.rgb_to_ycc[0], rgb, axes=(0, 1)).astype(np.float32)
    fr = measure.measure_frequency_response(plan, jnp.asarray(y))
    pb = measure.measure_pulse_bar(plan, impair(
        plan, enc(measure.pulse_and_bar(plan, 480)), ghost_delay_us=1.0, ghost_gain=0.25), g)
    return {"dg": dif["dg"], "dp_deg": dif["dp_deg"],
            "frequency_response": {str(f): v for f, v in fr.items()}, **pb}


def row_palplus():
    import jax.numpy as jnp
    import numpy as np

    from color_modem_tpu.frame.palplus import (make_interlaced_palplus_pipeline,
                                               make_palplus_pipeline)
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import PAL
    from color_modem_tpu.utils.metrics import psnr

    plan = make_plan(PAL(), N)
    rgb = np.broadcast_to(palplus_scene(576, N), (B, 3, 576, N))
    out = {}
    for interlaced in (False, True):
        for raster in (False, True):
            mk = make_interlaced_palplus_pipeline if interlaced else make_palplus_pipeline
            enc, dec, _ = mk(plan, "comb3", "xla", 1.0, raster)
            comp = enc(jnp.asarray(rgb), 0)
            key = f"{'interlaced' if interlaced else 'progressive'}{'-raster' if raster else ''}"
            out[key] = {"helper_db": psnr(np.asarray(dec(comp, 0)), rgb),
                        "zoom_db": psnr(np.asarray(dec(comp, 0, use_helper=False)), rgb)}
    return out


def _fullstack(extra):
    import contextlib
    import io

    from color_modem_tpu.cli import main as cli

    flags = ["roundtrip", "--standard", "pal", "--decoder", "comb3", "--demo", "--pattern",
             "scene", "--lines", "576", "--width", "1440", "--raster", "--interlaced",
             "--teletext", "|".join(TELETEXT_ROWS), "--wss", WSS_ASPECT,
             "--vitc", "01:02:03:04", "--caption", "FULL STACK", "--scramble", "cutrotate",
             "--rf", "--rf-audio"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(flags + extra)
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {"psnr_db": rep["psnr_db"], "pirate_psnr_db": rep["scramble"]["pirate_psnr_db"],
            "services_exact": all(rep[k]["exact"] for k in ("caption", "teletext", "wss",
                                                              "vitc")),
            "rf": rep["rf"]}


def _video_services(caption=False, **kw):
    import glob

    import numpy as np

    from color_modem_tpu.frame.video import process_video, synthetic_device_source
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC

    bits = video_caption_bits() if caption else None
    with tempfile.TemporaryDirectory() as d:
        s = process_video(make_plan(NTSC(), N), synthetic_device_source(480, N, seed=0), 48, d,
                          decoder="comb3", chunk=16, backend="xla", caption_bits=bits, **kw)
        cells = [np.load(p) for p in sorted(glob.glob(d + "/cc_*.npy"))]
    res = {"min_psnr_db": s["min_psnr_db"]}
    if caption:
        res["caption_exact"] = bool(np.array_equal(np.concatenate(cells), bits))
    return res


ROWS = {
    "rf-vsb-hop": row_rf,
    "satellite-fm-hop": row_satellite,
    "d2mac": row_d2mac,
    "mac-satellite": row_mac_satellite,
    "rf-ghost-gcr": row_rf_ghost,
    "tbc": row_tbc,
    "video-rf": lambda: _video(rf=True),
    "video-satellite": lambda: _video(satellite=True, sat_cnr=12.0),
    "video-channel-noise": lambda: _video(channel={"noise_sigma": 0.02}),
    "cli-noisy-rf": row_cli_noisy_rf,
    "rf-sound": row_rf_sound,
    "sat-sound": row_sat_sound,
    "a2": row_a2,
    "mts": row_mts,
    "mac-sound": row_mac_sound,
    "video-rf-audio": lambda: _video_audio(False),
    "video-rf-audio-interlaced": lambda: _video_audio(True),
    "secam-interp-1440": row_secam_interp_1440,
    "caption": row_caption,
    "teletext-wss-vitc": row_teletext_wss_vitc,
    "scramble": row_scramble,
    "vir": row_vir,
    "measure": row_measure,
    "palplus": row_palplus,
    "fullstack-nicam": lambda: _fullstack(["--rf-nicam"]),
    "fullstack-a2": lambda: _fullstack(["--rf-a2", "stereo"]),
    "video-caption": lambda: _video_services(caption=True),
    "video-scramble": lambda: _video_services(scramble=("cutrotate", SCRAMBLE_KEY)),
    "video-caption-scramble-rf": lambda: _video_services(
        caption=True, scramble=("cutrotate", SCRAMBLE_KEY), rf=True),
    "video-caption-scramble-interlaced": lambda: _video_services(
        caption=True, scramble=("cutrotate", SCRAMBLE_KEY), interlaced=True),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(ROWS), default=None)
    args = ap.parse_args()
    import jax

    for name in args.only or ROWS:
        t0 = time.perf_counter()
        res = ROWS[name]()
        print(json.dumps({"row": name, "backend": jax.default_backend(), **res,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
