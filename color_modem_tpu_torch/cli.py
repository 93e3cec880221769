"""Command-line interface of the port: encode | decode | roundtrip | video |
transcode | mac | measure | gallery | bench | info.

Port of ``color_modem_tpu/cli.py``: the same verbs, flags, validation
messages and JSON report keys, over the PyTorch modules of this package.
Every verb runs on the card unless ``--device cpu`` is given; without CUDA
the default raises instead of falling back.  ``--backend`` picks the hand
kernels (``kernel``, the default) or the plain PyTorch versions
(``plain``), ``frame/pipeline.py::BACKENDS``.

    python -m color_modem_tpu_torch.cli roundtrip --standard pal --decoder delayline \\
        --input in.png --output out.png --composite comp.png
    python -m color_modem_tpu_torch.cli video --standard ntsc --decoder comb3 \\
        --input clip.y4m --output out.y4m --out run/ --chunk 16
    python -m color_modem_tpu_torch.cli info

``video --mesh FxL`` runs once per rank under ``python -m
torch.distributed.run --nproc-per-node F*L``: NCCL on the card, gloo with
``--device cpu``; rank 0 alone prints the report and writes ``--output``.

Noise is the JAX CLI's: each site draws from the ``PRNGKey`` the JAX CLI
gives it (``utils/prng.py``), the same numbers on every device.  Results print as one JSON
object (the ``mac`` verb prints lines of text, as the JAX one does).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from color_modem_tpu_torch.frame.pipeline import BACKENDS
from color_modem_tpu_torch.utils.prng import PRNGKey, add_normal

STANDARD_NAMES = ["ntsc", "pal", "secam", "niir", "ntsc443", "pal_m", "pal_n", "pal60"]


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' for a CPU run)")


def _add_common(p):
    p.add_argument("--standard", default="ntsc", choices=STANDARD_NAMES)
    p.add_argument("--decoder", default="notch")
    p.add_argument("--width", type=int, default=720, help="samples per line")
    p.add_argument("--frame", type=int, default=0, help="frame index (phase sequence)")
    p.add_argument("--backend", default="kernel", choices=BACKENDS)
    _add_device(p)


def _add_raster(p):
    p.add_argument(
        "--raster", action="store_true",
        help="full rastered lines: sync pulse + color burst in blanking",
    )


def _add_roundtrip_flags(rt):
    rt.add_argument("--input", help="image file; omit with --demo")
    rt.add_argument("--demo", action="store_true", help="use generated color bars")
    rt.add_argument(
        "--pattern", default="bars", choices=("bars", "card", "ramp", "scene", "zone", "smpte"),
        help="demo image: 75%% color bars, the broadcast test card (crosshatch + circle + "
        "bars + gray steps + multiburst), a luminance ramp, a band-limited pseudo-natural "
        "scene, a zone plate (cross-color/aliasing sweep), or SMPTE engineering bars with "
        "the blue-only strip and PLUGE band",
    )
    rt.add_argument("--lines", type=int, default=0, help="demo height (0=standard)")
    rt.add_argument("--output", help="decoded PNG")
    rt.add_argument("--composite", help="composite visualization PNG")
    rt.add_argument("--noise", type=float, default=0.0,
                    help="channel white-noise sigma (composite units)")
    rt.add_argument("--chroma-gain", type=float, default=1.0,
                    help="channel differential chroma gain")
    rt.add_argument("--chroma-phase", type=float, default=0.0,
                    help="channel differential chroma phase, degrees")
    rt.add_argument("--interlaced", action="store_true",
                    help="transmit as two 2:1 interlaced fields (authentic line numbering; "
                    "weaves decoded fields back)")
    rt.add_argument("--svideo", action="store_true",
                    help="transmit separate Y/C planes (no shared wire: no separation stage, "
                    "no cross-color; decoder choice is ignored)")
    rt.add_argument("--diff-gain", type=float, default=0.0,
                    help="differential (luma-tracking) chroma gain error at 100%% luma")
    rt.add_argument("--diff-phase", type=float, default=0.0,
                    help="differential (luma-tracking) chroma phase at 100%% luma, deg")
    rt.add_argument("--ghost-delay-us", type=float, default=0.0,
                    help="multipath ghost delay, microseconds")
    rt.add_argument("--ghost-gain", type=float, default=0.0,
                    help="multipath ghost amplitude (0 = off; negative = inverted echo)")
    rt.add_argument("--vhs", action="store_true",
                    help="VHS color-under playback: luma to ~3 MHz, chroma to fsc±0.4 MHz "
                    "with phase-locked envelope delay")
    rt.add_argument("--tbe-us", type=float, default=0.0,
                    help="time-base error: vertical wobble amplitude, microseconds "
                    "(needs --raster)")
    rt.add_argument("--tbe-flagging-us", type=float, default=0.0,
                    help="time-base error: top-of-field flagging amplitude, us")
    rt.add_argument("--tbc", action="store_true",
                    help="time-base-correct from the sync/burst timing before decode")
    rt.add_argument("--equalize", action="store_true",
                    help="GCR ghost cancellation: send a reference line through the same "
                    "channel, estimate it, and equalize before decoding")
    rt.add_argument("--burst-locked", action="store_true",
                    help="decode with the burst-measured subcarrier phase (needs --raster; "
                    "cancels --chroma-phase like a real receiver)")
    rt.add_argument("--caption", default=None, metavar="TEXT",
                    help="embed TEXT as EIA-608-framed caption cells (2 chars per line-21 "
                    "cell, one cell per top row), ride the full channel/RF chain, decode and "
                    "parity-check at the receiver (reported in the JSON; the picture PSNR "
                    "then excludes the data rows)")
    rt.add_argument("--teletext", default=None, metavar="ROWS",
                    help="embed a WST teletext page ('|'-separated display rows, Hamming-8/4 "
                    "addresses + odd-parity chars at the real 444*fh bit rate) on the top "
                    "rows, ride the channel/RF chain, decode and render at the receiver "
                    "(needs --width >= 1440; 625-line standards)")
    rt.add_argument("--pal-ident", action="store_true",
                    help="PAL family only: slip the receiver's line counter by one and let "
                    "the receiver recover the V-switch parity from the swinging burst before "
                    "the burst-locked decode (the PAL ident flip-flop; needs --burst-locked "
                    "and --raster)")
    rt.add_argument("--secam-ident", action="store_true",
                    help="SECAM only: transmit identification lines (the 'bottles': "
                    "content-free sawtooth FM sweeps), slip the receiver's line counter by "
                    "one, and let the receiver recover the Dr/Db parity from the bottles "
                    "before decoding")
    rt.add_argument("--scramble", default=None, choices=("cutrotate", "linedelay", "shuffle"),
                    help="pay-TV scrambling of the composite (Videocrypt-style cut-and-rotate "
                    "/ Discret-style line delay / Nagravision-style line shuffle); the "
                    "receiver descrambles bit-exactly with the key and the JSON also reports "
                    "the pirate's (undescrambled) PSNR; composes with --raster (active region "
                    "only, sync/burst in the clear), --interlaced, and the --rf/--satellite "
                    "hops (no --equalize/--tbc)")
    rt.add_argument("--scramble-key", type=int, default=0x5EC4E7,
                    help="scrambling key (any 32-bit integer)")
    rt.add_argument("--vir", action="store_true",
                    help="insert VIR vertical-interval reference lines (EIA-516 shape: chroma "
                    "reference on a 70-IRE pedestal + luminance/black references) before the "
                    "channel, and decode with the VIR-measured hue/saturation corrections "
                    "(QAM standards, no --raster)")
    rt.add_argument("--palplus", action="store_true",
                    help="PALplus mode (QAM standards): treat the input as a full-height "
                    "16:9 programme, transmit it as a 4:3-compatible letterbox with the "
                    "vertical-helper signal modulated into the black bars, and reconstruct "
                    "full vertical resolution at the receiver; reports the PSNR with and "
                    "without the helper (composes with --noise only)")
    rt.add_argument("--vits", action="store_true",
                    help="insert vertical-interval test signals (modulated staircase + "
                    "multiburst) on the bottom rows before encoding; measures DG/DP off the "
                    "received composite and the luma frequency response off the decoded "
                    "picture")
    rt.add_argument("--wss", default=None, metavar="ASPECT",
                    help="embed a widescreen-signalling status line (EN 300 294 odd-weight "
                    "aspect codebook, biphase at 330*fh) on the row after the "
                    "caption/teletext rows; decoded aspect is reported in the JSON (625-line "
                    "standards; e.g. '16:9 full (anamorphic)')")
    rt.add_argument("--vitc", default=None, metavar="HH:MM:SS:FF",
                    help="embed a vertical-interval timecode line (SMPTE 12M-shaped 90-bit "
                    "word, NRZ at 115*fh with embedded sync pairs + CRC) on the row after the "
                    "other data services; the decoded timecode is reported in the JSON")
    rt.add_argument("--acc", action="store_true",
                    help="automatic chroma control: scale chroma by spec-over-measured burst "
                    "amplitude (cancels --chroma-gain; needs --burst-locked)")
    rt.add_argument("--color-kill", type=float, default=0.0,
                    help="color-killer threshold (fraction of spec burst amplitude): kill "
                    "chroma on lines whose burst falls below it (needs --burst-locked; "
                    "typical 0.3-0.5)")
    rt.add_argument("--rf", action="store_true",
                    help="transmit over the RF layer: VSB negative-AM picture at a low IF, "
                    "Nyquist-flank receiver + synchronous detection (frame/rf.py) between "
                    "encode and the composite channel")
    rt.add_argument("--satellite", action="store_true",
                    help="transmit over the SATELLITE layer instead: wideband video FM at IF "
                    "with CCIR-405-shaped emphasis and a quadrature discriminator "
                    "(frame/satellite.py); mutually exclusive with --rf")
    rt.add_argument("--sat-cnr", type=float, default=None, metavar="DB",
                    help="satellite channel carrier-to-noise ratio in dB; implies --satellite")
    rt.add_argument("--sat-audio", action="store_true",
                    help="analog FM audio subcarrier on the satellite multiplex (mono demo "
                    "tones); implies --satellite")
    rt.add_argument("--sat-stereo", action="store_true",
                    help="two audio subcarriers (L/R demo tones, the Astra-pair style); "
                    "implies --satellite")
    rt.add_argument("--sat-audio-in", default=None, metavar="IN.wav",
                    help="real audio for the satellite subcarrier(s): WAV file, resampled to "
                    "the composite grid (stereo files use two subcarriers); implies "
                    "--satellite")
    rt.add_argument("--rf-noise", type=float, default=0.0,
                    help="AWGN sigma added at RF (fractions of peak carrier); implies --rf")
    rt.add_argument("--rf-detection", default="sync", choices=["sync", "envelope"],
                    help="receiver detector: coherent product detection or envelope "
                    "detection (phase-immune, authentic VSB quadrature distortion); implies "
                    "--rf")
    rt.add_argument("--rf-phase-error", type=float, default=0.0,
                    help="channel carrier phase offset, degrees (cancelled by --rf-recover)")
    rt.add_argument("--rf-recover", action="store_true",
                    help="quasi-synchronous receiver: recover the carrier phase from the "
                    "signal before sync detection")
    rt.add_argument("--rf-freq-error", type=float, default=0.0,
                    help="transmitter mistuning, Hz; corrected by --rf-aft; implies --rf")
    rt.add_argument("--rf-aft", action="store_true",
                    help="automatic fine tuning: estimate the carrier frequency offset, "
                    "retune the stream back onto the Nyquist flank, and recover the remaining "
                    "carrier phase (implies --rf-recover); implies --rf")
    rt.add_argument("--rf-audio", action="store_true",
                    help="transmit a 1+7 kHz two-tone test signal on the intercarrier FM "
                    "sound channel and report the recovered audio SNR; implies --rf")
    rt.add_argument("--rf-ghost-delay-us", type=float, default=3.0,
                    help="RF multipath ghost delay (used with --rf-ghost-gain)")
    rt.add_argument("--rf-ghost-gain", type=float, default=0.0,
                    help="RF multipath ghost gain (may be negative); implies --rf")
    rt.add_argument("--rf-equalize", action="store_true",
                    help="send a guarded GCR record through the same RF chain and equalize "
                    "about the zero-carrier pivot after detection; implies --rf")
    rt.add_argument("--rf-audio-in", default=None, metavar="IN.wav",
                    help="transmit a real audio file on the FM sound channel (resampled to "
                    "the composite grid; mono, or stereo with --rf-stereo); implies --rf")
    rt.add_argument("--audio-out", default=None, metavar="OUT.wav",
                    help="write the recovered sound-channel audio as 48 kHz 16-bit PCM "
                    "(mono, or L/R with --rf-stereo)")
    rt.add_argument("--rf-dropouts", type=float, default=0.0,
                    help="tape-dropout rate: probability per line of an RF carrier loss; "
                    "implies --rf")
    rt.add_argument("--rf-doc", action="store_true",
                    help="dropout compensator: replace carrier-loss samples with the previous "
                    "line (1H DOC); implies --rf")
    rt.add_argument("--rf-gain", type=float, default=1.0,
                    help="channel RF gain factor; washes the picture out unless --rf-agc; "
                    "implies --rf")
    rt.add_argument("--rf-agc", action="store_true",
                    help="sync-tip keyed automatic gain control (needs --raster); implies "
                    "--rf")
    rt.add_argument("--rf-a2", default=None, choices=("stereo", "dual"),
                    help="A2/Zweikanalton two-carrier sound: a second FM sound carrier 15.5 "
                    "fh up carries R (stereo) or a second program (dual), with the AM-ident "
                    "pilot; the receiver reports the DETECTED mode and per-channel SNR; "
                    "implies --rf")
    rt.add_argument("--rf-stereo", action="store_true",
                    help="transmit an MTS/BTSC-style stereo pair (1 kHz left, 3 kHz right) "
                    "on the sound channel; reports per-ear SNR and the pilot level; implies "
                    "--rf")
    rt.add_argument("--rf-nicam", action="store_true",
                    help="transmit a NICAM-728 digital stereo burst on the RF channel; "
                    "reports per-ear SNR, parity errors and the frame-alignment lock; "
                    "implies --rf")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="color_modem_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode", help="RGB image -> composite image")
    _add_common(enc)
    _add_raster(enc)
    enc.add_argument("--input", required=True)
    enc.add_argument("--output", required=True, help="composite PNG (grayscale)")
    enc.add_argument("--raw", help="also dump float32 composite .npy")

    dec = sub.add_parser("decode", help="float32 composite .npy -> RGB image")
    _add_common(dec)
    _add_raster(dec)
    dec.add_argument("--input", required=True, help="composite .npy from encode --raw")
    dec.add_argument("--output", required=True)

    rt = sub.add_parser("roundtrip", help="RGB -> composite -> RGB")
    _add_common(rt)
    _add_raster(rt)
    _add_roundtrip_flags(rt)

    vid = sub.add_parser("video", help="chunked, resumable synthetic-video roundtrip run")
    _add_common(vid)
    vid.add_argument("--frames", type=int, default=0,
                     help="frame count (0 = the whole --input clip, or 32 synthetic frames)")
    vid.add_argument("--lines", type=int, default=0, help="0 = standard active lines")
    vid.add_argument("--chunk", type=int, default=8)
    vid.add_argument("--out", required=True, help="output/manifest directory")
    vid.add_argument("--input", default=None, metavar="CLIP.y4m",
                     help="real video input (YUV4MPEG2, e.g. from `ffmpeg -i clip.mp4 "
                     "clip.y4m`); the clip's geometry sets the plan width and line count")
    vid.add_argument("--output", default=None, metavar="OUT.y4m",
                     help="write the decoded frames as a C444 .y4m clip (assembled from the "
                     "per-chunk outputs after the run)")
    vid.add_argument("--caption", default=None, metavar="TEXT",
                     help="stream TEXT as line-21 caption cells, one 2-char cell per frame "
                     "(padded with spaces), decoded off the received composite and reported "
                     "in the JSON")
    vid.add_argument("--mesh", default="",
                     help="FxL rank mesh, e.g. 2x2 (empty = unsharded); run the verb once "
                     "per rank under python -m torch.distributed.run")
    vid.add_argument("--no-resume", action="store_true")
    vid.add_argument("--rf", action="store_true",
                     help="transmit every chunk over the RF/VSB layer (frame/rf.py)")
    vid.add_argument("--satellite", action="store_true",
                     help="transmit every chunk over the FM satellite layer "
                     "(frame/satellite.py) instead of --rf; noise keyed per absolute frame, "
                     "so runs are chunk-size independent and resume-safe")
    vid.add_argument("--sat-cnr", type=float, default=None, metavar="DB",
                     help="satellite carrier-to-noise ratio in dB; implies --satellite")
    vid.add_argument("--rf-audio-in", default=None, metavar="IN.wav",
                     help="soundtrack for the RF hop: WAV resampled to one audio sample per "
                     "video sample, riding the intercarrier FM sound carrier "
                     "phase-continuously across frames and chunks; needs --rf")
    vid.add_argument("--rf-stereo", action="store_true",
                     help="carry the soundtrack as an MTS/BTSC stereo multiplex on the sound "
                     "carrier (stereo WAV via --rf-audio-in, or L/R demo tones); the receiver "
                     "decodes L/R and reports per-ear SNR; implies the wider 50 kHz sound "
                     "channel")
    vid.add_argument("--audio-out", default=None, metavar="OUT.wav",
                     help="write the receiver's recovered soundtrack as 48 kHz PCM (mono, or "
                     "L/R with --rf-stereo; needs --rf-audio-in or --rf-stereo)")
    vid.add_argument("--host-source", action="store_true",
                     help="generate frames on the host (default: on the device; the host "
                     "path uploads every chunk)")
    vid.add_argument("--noise", type=float, default=0.0, help="channel white-noise sigma")
    vid.add_argument("--chroma-gain", type=float, default=1.0)
    vid.add_argument("--chroma-phase", type=float, default=0.0,
                     help="channel differential chroma phase, degrees")
    vid.add_argument("--diff-gain", type=float, default=0.0,
                     help="differential chroma gain error at 100%% luma")
    vid.add_argument("--diff-phase", type=float, default=0.0,
                     help="differential chroma phase at 100%% luma, deg")
    vid.add_argument("--ghost-delay-us", type=float, default=0.0,
                     help="multipath ghost delay, microseconds")
    vid.add_argument("--ghost-gain", type=float, default=0.0,
                     help="multipath ghost amplitude (0 = off)")
    vid.add_argument("--equalize", action="store_true",
                     help="per-chunk GCR ghost cancellation before decode")
    vid.add_argument("--vhs", action="store_true",
                     help="VHS color-under playback signature per chunk")
    vid.add_argument("--scramble", default=None, choices=("cutrotate", "linedelay", "shuffle"),
                     help="pay-TV scrambling of every transmitted frame (frame/scramble.py), "
                     "descrambled with the key at the receiver; composes with "
                     "--rf/--satellite, the channel impairments, --caption and --interlaced "
                     "(no --equalize); keyed on the absolute line index")
    vid.add_argument("--scramble-key", type=int, default=0x5EC4E7,
                     help="scrambling key (any 32-bit integer)")
    vid.add_argument("--nr", type=float, default=None, metavar="SIGMA",
                     help="motion-gated temporal noise reduction with this expected noise "
                     "sigma")
    vid.add_argument("--interlaced", action="store_true",
                     help="transmit frames as 2:1 interlaced fields")

    tc = sub.add_parser(
        "transcode",
        help="standards conversion: decode one standard's composite and re-encode another's "
        "(held-frame rate conversion)",
    )
    tc.add_argument("--from", dest="src", required=True, choices=STANDARD_NAMES)
    tc.add_argument("--to", dest="dst", required=True, choices=STANDARD_NAMES)
    tc.add_argument("--width", type=int, default=720)
    tc.add_argument("--input", help="image file; omit with --demo")
    tc.add_argument("--demo", action="store_true", help="use generated color bars")
    tc.add_argument("--decoder", default=None, help="source decoder (default: best line-local)")
    tc.add_argument("--backend", default="kernel", choices=BACKENDS)
    _add_device(tc)
    tc.add_argument("--output", help="decoded-at-destination PNG")
    tc.add_argument("--composite", help="destination composite PNG")

    mc = sub.add_parser(
        "mac",
        help="D2-MAC time-multiplexed components: round trip an image (no subcarrier, no "
        "cross-color) and ride text on the duobinary data burst (99 bits/line at 10.125 "
        "Mbaud)",
    )
    mc.add_argument("--width", type=int, default=720)
    mc.add_argument("--variant", default="d2", choices=("d2", "d"),
                    help="d2 = 10.125 Mbaud duobinary burst (cable, the default); d = "
                    "full-rate D-MAC, 20.25 Mbaud, double the payload (204 vs 99 bits/line)")
    mc.add_argument("--lines", type=int, default=0,
                    help="demo height (0 = 576, the 625-family active count)")
    mc.add_argument("--input", help="image file; omit with --demo")
    mc.add_argument("--demo", action="store_true", help="use generated color bars")
    mc.add_argument("--noise", type=float, default=0.0,
                    help="AWGN sigma on the MAC baseband signal")
    mc.add_argument("--satellite", action="store_true",
                    help="ride the FM satellite layer (frame/satellite.py), the channel D2-MAC "
                    "was designed for; adds the frame-synchronous energy dispersal, which the "
                    "MAC clamp period removes")
    mc.add_argument("--audio-in", default=None, metavar="IN.wav",
                    help="MAC packet sound: NICAM-companded stereo audio in the duobinary "
                    "burst (resampled to 32 kHz, fills the frame's burst capacity); mutually "
                    "exclusive with --data")
    mc.add_argument("--audio-out", default=None, metavar="OUT.wav",
                    help="write the burst-decoded audio (with --audio-in)")
    mc.add_argument("--sat-cnr", type=float, default=None, metavar="DB",
                    help="satellite carrier-to-noise ratio in dB; implies --satellite")
    mc.add_argument("--data", default=None, metavar="TEXT",
                    help="text payload for the data burst (UTF-8, packed 12 bytes + 3 zero "
                    "bits per line)")
    mc.add_argument("--output", help="decoded RGB PNG")
    mc.add_argument("--signal", help="MAC baseband as grayscale PNG")
    _add_device(mc)

    ms = sub.add_parser(
        "measure",
        help="broadcast T&M loop: staircase + multiburst through a channel, report "
        "differential gain/phase and frequency response",
    )
    ms.add_argument("--standard", default="ntsc", choices=STANDARD_NAMES)
    ms.add_argument("--width", type=int, default=720)
    ms.add_argument("--lines", type=int, default=64)
    ms.add_argument("--noise", type=float, default=0.0)
    ms.add_argument("--chroma-gain", type=float, default=1.0)
    ms.add_argument("--chroma-phase", type=float, default=0.0)
    ms.add_argument("--diff-gain", type=float, default=0.0)
    ms.add_argument("--diff-phase", type=float, default=0.0)
    ms.add_argument("--ghost-delay-us", type=float, default=0.0)
    ms.add_argument("--ghost-gain", type=float, default=0.0)
    ms.add_argument("--vhs", action="store_true")
    ms.add_argument("--pulse-bar", action="store_true",
                    help="also run the ITU-R pulse-and-bar line: 2T K-rating and 20T "
                    "chrominance/luminance gain+delay inequality")
    ms.add_argument("--vectorscope", metavar="PNG",
                    help="also render the vectorscope instrument display of 75%% bars through "
                    "the same channel")
    ms.add_argument("--waveform", metavar="PNG",
                    help="also render the waveform monitor: RASTERED 75%% bars through the "
                    "same channel, every line overlaid, IRE graticule")
    ms.add_argument("--spectrum", metavar="PNG",
                    help="also render the spectrum analyzer: full band on top, fsc±16fh zoom "
                    "below")
    _add_device(ms)

    gal = sub.add_parser(
        "gallery",
        help="render every standard x decoder to PNGs for side-by-side artifact comparison",
    )
    gal.add_argument("--out", required=True, help="output directory")
    gal.add_argument("--input", help="image file (default: color bars)")
    gal.add_argument("--width", type=int, default=720)
    gal.add_argument("--lines", type=int, default=0, help="0 = standard lines")
    gal.add_argument("--backend", default="kernel", choices=BACKENDS)
    _add_device(gal)
    gal.add_argument("--chroma-phase", type=float, default=0.0,
                     help="also render each pair through this channel phase error (deg)")
    gal.add_argument("--animate", type=int, default=0, metavar="K",
                     help="also save a K-frame dot-crawl GIF per standard (the 4/8-field "
                     "chroma phase sequence, notch decoder)")
    gal.add_argument("--fullstack", action="store_true",
                     help="also render the full-stack 'authentic broadcast' row: rastered "
                     "interlaced PAL at 576x1440 with teletext/WSS/VITC/captions, "
                     "Videocrypt-style scrambling, RF hop with FM + NICAM sound")

    from color_modem_tpu_torch.benchmark import add_bench_args

    bm = sub.add_parser("bench", help="round-trip throughput benchmark (the protocol of "
                        "python -m color_modem_tpu_torch.benchmark)")
    add_bench_args(bm)

    sub.add_parser("info", help="list standards, decoders, devices")
    return ap


# --- shared helpers ----------------------------------------------------------------------


def _host(x):
    """A tensor (or array) as a host NumPy array."""
    import numpy as np
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _psnr(a, b) -> float:
    import torch

    from color_modem_tpu_torch.utils.metrics import psnr

    return psnr(torch.as_tensor(_host(a)), torch.as_tensor(_host(b)))


def _plan(cfg, width: int, dev):
    from color_modem_tpu_torch.modem.plan import make_plan, plan_on

    return plan_on(make_plan(cfg, width), dev)


def _fit_width(rgb, width: int, dev):
    """Resample an image's rows to ``width`` samples on ``dev`` (one
    windowed-sinc matmul), clipping the sinc ringing: the encoder's contract
    is RGB in [0, 1]."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.dsp.resample import resample_width
    from color_modem_tpu_torch.utils.upload import upload

    if rgb.shape[-1] == width:
        return rgb
    out = torch.clamp(resample_width(upload(rgb, dev, np.float32), width), 0.0, 1.0)
    return _host(out).astype(np.float32)


def _load_input(args, dev):
    import numpy as np

    from color_modem_tpu_torch.frame.image_io import load_rgb
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.utils import testimages

    cfg = ALL_STANDARDS[args.standard]()
    if getattr(args, "demo", False) or not getattr(args, "input", None):
        lines = getattr(args, "lines", 0) or cfg.active_lines
        make = {"card": testimages.test_card, "ramp": testimages.gray_ramp,
                "scene": testimages.smooth_scene, "zone": testimages.zone_plate,
                "smpte": testimages.smpte_bars}.get(getattr(args, "pattern", "bars"),
                                                    testimages.color_bars)
        return make(lines, args.width).astype(np.float32), cfg
    return _fit_width(load_rgb(args.input), args.width, dev), cfg


def _validate(args) -> None:
    """Refuse flag combinations before any compute."""
    # quality-qualified SECAM configuration: 1440 samples = 27 MHz keeps the
    # ~6.2 MHz FM sidebands inside Nyquist.  Only advise where --width picks
    # the encode grid (not on decode, whose geometry came from encode).
    secam_encoding = (
        "secam" in (args.src, args.dst) if args.cmd == "transcode"
        else getattr(args, "standard", None) == "secam" and args.cmd != "decode"
    )
    if secam_encoding and args.width < 1440:
        print("note: secam at --width %d; --width 1440 (27 MHz) is the quality-qualified "
              "configuration (~+3 dB round trip)" % args.width, file=sys.stderr)
    if getattr(args, "decoder", None) in ("comb3d", "comb3dA") and args.cmd != "video":
        raise SystemExit(f"{args.decoder} is a temporal decoder (combs along the frame "
                         "axis) — use the 'video' subcommand")
    if getattr(args, "burst_locked", False):
        # needs a rastered line and a standard that carries a burst
        if not args.raster:
            raise SystemExit("--burst-locked requires --raster")
        if args.standard == "secam":
            raise SystemExit("secam has no color burst to lock to")
    if getattr(args, "pal_ident", False):
        if not getattr(args, "burst_locked", False):
            raise SystemExit("--pal-ident is the ident stage of the burst-locked receiver: "
                             "add --burst-locked (and --raster)")
        from color_modem_tpu_torch.standards import ALL_STANDARDS
        from color_modem_tpu_torch.standards.base import QamParams

        chroma = ALL_STANDARDS[args.standard]().chroma
        if not (isinstance(chroma, QamParams) and chroma.v_switch):
            raise SystemExit(f"{args.standard} has no swinging burst — --pal-ident is a "
                             "PAL-family feature")
    if getattr(args, "acc", False) or getattr(args, "color_kill", 0.0) > 0.0:
        if not getattr(args, "burst_locked", False):
            raise SystemExit("--acc/--color-kill are keyed on the measured burst: add "
                             "--burst-locked (and --raster)")
    if (getattr(args, "tbe_us", 0.0) or getattr(args, "tbe_flagging_us", 0.0)
            or getattr(args, "tbc", False)):
        # the TBC locks to the sync edge of a rastered line
        if not args.raster or getattr(args, "interlaced", False):
            raise SystemExit("--tbe-us/--tbc need --raster (the TBC locks to the sync edge) "
                             "and are progressive-only in the CLI")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        # broadcast-batch frames: the temporal decoders are fine here, so
        # the still-image guards of _validate do not apply
        from color_modem_tpu_torch.benchmark import run as bench_run

        bench_run(args)
        return 0
    _validate(args)
    if args.cmd == "info":
        return _info()
    import torch

    from color_modem_tpu_torch.frame.pipeline import resolve_device

    dev = resolve_device(args.device)
    with torch.inference_mode():
        if getattr(args, "palplus", False):
            return _palplus(args, dev)
        verb = {"mac": _mac, "measure": _measure, "transcode": _transcode,
                "gallery": _gallery, "video": _video}.get(args.cmd, _single_frame)
        return verb(args, dev)


# --- info ---------------------------------------------------------------------------------


def _info() -> int:
    import torch

    from color_modem_tpu_torch.frame.rf import make_rf_plan
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.standards.decoders import allowed_decoders

    def rf_info(cfg):
        try:
            rfp = make_rf_plan(make_plan(cfg, 720))
        except ValueError:
            return None
        return {
            "fc_mhz": round(rfp.fc / 1e6, 3),
            "f_video_mhz": round(rfp.f_video / 1e6, 2),
            "f_vestige_mhz": round(rfp.f_vestige / 1e6, 2),
            "f_snd_mhz": round(rfp.f_snd / 1e6, 3),
            "snd_dev_khz": round(rfp.snd_dev / 1e3, 1),
            "fs_rf_mhz": round(rfp.fs_rf / 1e6, 2),
        }

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "standards": {k: list(allowed_decoders(f())) for k, f in ALL_STANDARDS.items()},
        "rf_defaults": {k: rf_info(f()) for k, f in ALL_STANDARDS.items()},
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
    }))
    return 0


# --- roundtrip --palplus -------------------------------------------------------------------


def _palplus(args, dev) -> int:
    """PALplus is its own transmission geometry (letterbox + helper bars),
    so it leaves the composable roundtrip; the transmission stack composes
    with it: --interlaced (one helper reference per field), --raster, the
    --rf VSB hop (with --rf-noise) and the white-noise composite channel."""
    t0 = time.perf_counter()
    # the palplus path honours exactly these flags; any other roundtrip flag
    # left at a non-default value is a composition it would silently ignore
    honored = {
        "cmd", "standard", "decoder", "width", "frame", "backend", "device",
        "input", "demo", "pattern", "lines", "output", "composite",
        "noise", "palplus", "interlaced", "raster", "rf", "rf_noise",
    }
    defaults = vars(build_parser().parse_args(["roundtrip", "--demo"]))
    blocked = sorted("--" + k.replace("_", "-") for k, v in vars(args).items()
                     if k not in honored and v != defaults.get(k, v))
    if blocked:
        raise SystemExit("--palplus composes with --interlaced/--raster/--rf/--rf-noise/"
                         "--noise only; remove " + " ".join(blocked))
    if args.rf_noise > 0.0 and not args.rf:
        raise SystemExit("--rf-noise needs --rf")
    from color_modem_tpu_torch.frame.image_io import save_composite, save_rgb
    from color_modem_tpu_torch.frame.palplus import (
        PalPlusGeometry,
        make_interlaced_palplus_pipeline,
        make_palplus_pipeline,
    )

    rgb, cfg = _load_input(args, dev)
    if cfg.is_fm:
        raise SystemExit(f"--palplus needs a QAM subcarrier for the helper; {cfg.name} is FM")
    try:
        PalPlusGeometry(rgb.shape[1])
        if args.interlaced and rgb.shape[1] % 16:
            raise ValueError(f"interlaced PALplus needs lines divisible by 16, got "
                             f"{rgb.shape[1]}")
    except ValueError as e:
        raise SystemExit(f"--palplus: {e}")
    plan = _plan(cfg, args.width, dev)
    make = make_interlaced_palplus_pipeline if args.interlaced else make_palplus_pipeline
    enc, dec, _ = make(plan, args.decoder, args.backend, raster=args.raster, device=dev)
    units = 2 if args.interlaced else 1
    comp = enc(rgb[None], args.frame)
    if args.rf:
        from color_modem_tpu_torch.frame.raster import make_raster
        from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate, rf_modulate

        rf_kw = {"row_samples": make_raster(plan).n_total} if args.raster else {}
        rfp = make_rf_plan(plan, **rf_kw)
        # the absolute leading-axis index (fields when interlaced) keys the
        # carrier row law, as in frame/video.py
        g0 = args.frame * units
        rf_sig = rf_modulate(rfp, comp, g0)
        if args.rf_noise > 0.0:
            rf_sig = add_normal(rf_sig, args.rf_noise, PRNGKey(1))
        comp = rf_demodulate(rfp, rf_sig, g0)
    if args.noise > 0.0:
        comp = add_normal(comp, args.noise, PRNGKey(0))
    out = _host(dec(comp, args.frame, use_helper=True))[0]
    out_lb = _host(dec(comp, args.frame, use_helper=False))[0]
    result = {
        "cmd": "roundtrip", "standard": cfg.name, "palplus": True,
        "decoder": args.decoder,
        "psnr_db": round(_psnr(out, rgb), 2),
        "psnr_without_helper_db": round(_psnr(out_lb, rgb), 2),
        "lines": int(rgb.shape[1]),
    }
    for k in ("interlaced", "raster", "rf"):
        if getattr(args, k):
            result[k] = True
    if args.output:
        save_rgb(args.output, out)
        result["output"] = args.output
    if args.composite:
        save_composite(args.composite, _host(comp)[0])
        result["composite"] = args.composite
    result["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(result))
    return 0


# --- mac ----------------------------------------------------------------------------------


def _mac(args, dev) -> int:
    import numpy as np
    import torch

    from color_modem_tpu_torch.frame.image_io import load_rgb, save_rgb
    from color_modem_tpu_torch.modem import mac
    from color_modem_tpu_torch.modem.mac_plan import make_mac_plan
    from color_modem_tpu_torch.utils.testimages import color_bars
    from color_modem_tpu_torch.utils.upload import upload

    if args.demo or not args.input:
        rgb = color_bars(args.lines or 576, args.width).astype(np.float32)
    else:
        rgb = _fit_width(load_rgb(args.input), args.width, dev)
    n_lines = rgb.shape[1]
    plan = make_mac_plan(args.width, args.variant)
    mac_cap = plan.cfg.data_symbols - len(plan.cfg.line_sync_word)
    gline = torch.arange(n_lines, device=dev)
    rgb_t = upload(rgb, dev)

    payload = None
    n_audio_frames = 0
    audio_ref = None
    if args.audio_in is not None:
        if args.data is not None:
            raise SystemExit("--audio-in and --data share the burst payload; pick one")
        from color_modem_tpu_torch.utils.wav import read_wav, resample_linear

        wav_x, wav_rate = read_wav(args.audio_in)
        if wav_x.shape[0] < 2:
            wav_x = np.concatenate([wav_x, wav_x])
        n_samp = mac.sound_capacity(plan, n_lines) * 32
        audio_ref = resample_linear(wav_x[:2], wav_rate, 32000.0,
                                    n_out=n_samp).astype(np.float32)
        payload, n_audio_frames = mac.pack_sound(plan, upload(audio_ref[0], dev),
                                                 upload(audio_ref[1], dev), n_lines)
    if args.data is not None:
        # whole bytes per line slot, zero-padded (d2: 12 bytes of the 99-bit
        # slot; d: 25 of the 204-bit slot)
        raw = args.data.encode("utf-8")
        per = mac_cap // 8
        n_needed = -(-len(raw) // per)
        if n_needed > n_lines:
            raise SystemExit(f"--data needs {n_needed} lines, image has {n_lines}")
        raw = raw.ljust(n_lines * per, b"\0")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(n_lines, per), axis=1)
        payload = upload(np.pad(bits, ((0, 0), (0, mac_cap - 8 * per))), dev, np.int32)

    sig = mac.encode(plan, rgb_t, gline, payload)
    if args.satellite or args.sat_cnr is not None:
        from color_modem_tpu_torch.frame import satellite as sat_mod

        sp = sat_mod.make_sat_plan(plan.cfg.fs, plan.cfg.samples_per_line, dispersal=0.1,
                                   total_lines=plan.cfg.total_lines)
        tx = sig[None]
        rx = sat_mod.sat_roundtrip(sp, tx, gline=gline[None], key=PRNGKey(11),
                                   cnr_db=args.sat_cnr)
        # transparency measured clamp to clamp: the receiver clamp removes
        # the dispersal ramp, so compare both sides DC-restored
        rx_c = rx - mac.clamp_correction(plan, rx)
        tx_c = tx - mac.clamp_correction(plan, tx)
        print("satellite FM hop (with energy dispersal): transparency "
              f"{_psnr(rx_c, tx_c):.1f} dB"
              + (f" at CNR {args.sat_cnr} dB" if args.sat_cnr is not None else " (noise-free)"))
        sig = rx[0]
    if args.noise > 0.0:
        sig = add_normal(sig, args.noise, PRNGKey(0))
    out = mac.decode(plan, sig, gline)
    print(f"{plan.cfg.name} roundtrip: {n_lines}x{args.width} "
          f"psnr {_psnr(out, np.clip(rgb, 0, 1)):.1f} dB"
          + (f" (awgn sigma={args.noise})" if args.noise else ""))
    sync_ok, bits = mac.decode_data(plan, sig)
    print(f"line sync: {int(sync_ok.sum())}/{n_lines} bursts")
    if args.data is not None:
        per = mac_cap // 8
        got = _host(bits)[:, : 8 * per]
        text = (np.packbits(got.astype(np.uint8), axis=1).tobytes().rstrip(b"\0")
                .decode("utf-8", errors="replace"))
        ber = float(np.mean(got != _host(payload)[:, : 8 * per]))
        print(f"data burst payload (ber {ber:.2e}): {text!r}")
    if n_audio_frames:
        left, right, rep = mac.unpack_sound(plan, bits, n_audio_frames)
        rx = np.stack([_host(left), _host(right)])
        err = float(np.mean((rx - audio_ref) ** 2))
        # full-scale SNR: the 14 -> 10-bit companding floor is ~60 dB;
        # channel bit errors show far below it
        snr = 10.0 * np.log10(1.0 / max(err, 1e-12))
        print(f"packet sound: {n_audio_frames} NICAM frames ({n_audio_frames * 32} samples/ch "
              f"at 32 kHz), audio SNR {snr:.1f} dB, "
              f"parity errors {int(_host(rep['parity_errors']).sum())}")
        if args.audio_out:
            from color_modem_tpu_torch.utils.wav import write_wav

            write_wav(args.audio_out, rx, 32000)
            print(f"wrote {args.audio_out}")
    if args.output:
        save_rgb(args.output, _host(out))
        print(f"wrote {args.output}")
    if args.signal:
        from color_modem_tpu_torch.frame.image_io import save_composite

        save_composite(args.signal, _host(sig), lo=0.0, hi=1.0)
        print(f"wrote {args.signal}")
    return 0


# --- measure ------------------------------------------------------------------------------


def _measure(args, dev) -> int:
    import torch

    from color_modem_tpu_torch.frame.channel import impair, vhs_playback
    from color_modem_tpu_torch.frame.image_io import save_rgb
    from color_modem_tpu_torch.frame.measure import (
        measure_differential,
        measure_frequency_response,
        modulated_staircase,
        multiburst,
    )
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.utils.testimages import color_bars, smooth_scene

    plan = _plan(ALL_STANDARDS[args.standard](), args.width, dev)
    enc, _, _ = make_pipeline(plan, "notch", device=dev)
    kw = dict(
        noise_sigma=args.noise, chroma_gain=args.chroma_gain,
        chroma_phase_deg=args.chroma_phase, diff_gain=args.diff_gain,
        diff_phase_deg=args.diff_phase,
        ghost_delay_us=args.ghost_delay_us, ghost_gain=args.ghost_gain,
    )
    stim_counter = [0]

    def through(rgb):
        # each stimulus sees its own noise realisation
        key = PRNGKey(stim_counter[0]) if args.noise > 0.0 else None
        stim_counter[0] += 1
        comp = impair(plan, enc(rgb[None], 0), key=key, **kw)
        return vhs_playback(plan, comp) if args.vhs else comp

    g = frame_line_index(plan, 0, 1, args.lines, dev)
    is_fm = plan.cfg.is_fm
    if is_fm:
        # SECAM: the FM chroma carrier rides the composite at constant
        # amplitude everywhere, so raw-waveform readings would rate the
        # system's own carrier as distortion; SECAM plants measured the luma
        # path off the decoded picture.  DG/DP stays QAM-only.
        _, dec_fm, _ = make_pipeline(plan, "interp", device=dev)

        def luma_of(comp):
            return torch.einsum("c,bcln->bln", plan.rgb_to_ycc[0], dec_fm(comp, 0))

        report = {"standard": args.standard, "dg": None, "dp_deg": None,
                  "note": "DG/DP omitted: SECAM FM chroma is immune by design; luma "
                          "measurements are off the decoded picture"}
    else:
        stair = through(modulated_staircase(plan, args.lines, args.width))
        rep = measure_differential(plan, stair, g)
        report = {
            "standard": args.standard,
            "dg": round(rep["dg"], 4),
            "dp_deg": round(rep["dp_deg"], 2),
            "step_phase_deg": [round(float(v), 2) for v in rep["step_phase_deg"]],
        }
    burst = through(multiburst(plan, args.lines))
    freq = measure_frequency_response(plan, luma_of(burst) if is_fm else burst)
    report["frequency_response"] = {f"{f}MHz": round(v, 3) for f, v in freq.items()}
    if args.pulse_bar:
        from color_modem_tpu_torch.frame.measure import (
            measure_k_rating,
            measure_pulse_bar,
            pulse_and_bar,
        )

        pb = through(pulse_and_bar(plan, args.lines))
        pbr = measure_k_rating(plan, luma_of(pb)) if is_fm else measure_pulse_bar(plan, pb, g)
        report["pulse_bar"] = {k: round(v, 3) for k, v in pbr.items()}
    if args.vectorscope and is_fm:
        raise SystemExit("--vectorscope is a QAM instrument (it demodulates the quadrature "
                         "subcarrier); SECAM has no chroma phase plane")
    if args.vectorscope:
        from color_modem_tpu_torch.frame.measure import vectorscope_image

        img = vectorscope_image(plan, through(color_bars(args.lines, args.width)), g)
        save_rgb(args.vectorscope, img.transpose(2, 0, 1))
        report["vectorscope"] = args.vectorscope
    if args.waveform or args.spectrum:
        enc_r, _, _ = make_pipeline(plan, "notch", raster=True, device=dev)

        def rastered(rgb):
            key = PRNGKey(99) if args.noise > 0.0 else None
            return impair(plan, enc_r(rgb[None], 0), key=key, **kw)

    if args.waveform:
        from color_modem_tpu_torch.frame.measure import waveform_image

        img = waveform_image(rastered(color_bars(args.lines, args.width)))
        save_rgb(args.waveform, img.transpose(2, 0, 1))
        report["waveform"] = args.waveform
    if args.spectrum:
        from color_modem_tpu_torch.frame.measure import spectrum_image

        # a natural scene shows the interleave comb best (bars' step edges
        # smear broadband energy across the teeth); rastered rows, so the
        # fh comb rides the true line period
        img = spectrum_image(plan, rastered(smooth_scene(args.lines, args.width, seed=2)))
        save_rgb(args.spectrum, img.transpose(2, 0, 1))
        report["spectrum"] = args.spectrum
    print(json.dumps(report))
    return 0


# --- transcode ----------------------------------------------------------------------------


def _transcode(args, dev) -> int:
    import numpy as np

    from color_modem_tpu_torch.frame.image_io import load_rgb, save_composite, save_rgb
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.frame.transcode import (
        best_decoder,
        make_transcoder,
        resample_lines,
    )
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.utils.testimages import color_bars
    from color_modem_tpu_torch.utils.upload import upload

    plan_s = _plan(ALL_STANDARDS[args.src](), args.width, dev)
    plan_d = _plan(ALL_STANDARDS[args.dst](), args.width, dev)
    l_src = plan_s.cfg.active_lines
    if args.input:
        rgb = load_rgb(args.input, size=(args.width, l_src))
    elif args.demo:
        rgb = color_bars(l_src, args.width).astype(np.float32)
    else:
        raise SystemExit("transcode needs --input or --demo")
    enc_s, _, _ = make_pipeline(plan_s, "notch", args.backend, dev)
    comp_s = enc_s(rgb[None], 0)
    conv = make_transcoder(plan_s, plan_d, args.decoder, args.backend, dev)
    comp_d = conv(comp_s, 0)
    _, dec_d, _ = make_pipeline(plan_d, best_decoder(plan_d), args.backend, dev)
    out = _host(dec_d(comp_d, 0))[0]
    ref = resample_lines(upload(rgb, dev)[None], out.shape[-2])[0]
    result = {
        "from": args.src, "to": args.dst, "width": args.width,
        "lines": [int(l_src), int(out.shape[-2])],
        "decoder": args.decoder or best_decoder(plan_s),
        "psnr_db_vs_resampled_source": round(_psnr(out, ref), 2),
    }
    if args.output:
        save_rgb(args.output, out)
        result["output"] = args.output
    if args.composite:
        save_composite(args.composite, _host(comp_d)[0])
        result["composite"] = args.composite
    print(json.dumps(result))
    return 0


# --- gallery ------------------------------------------------------------------------------


def _gallery(args, dev) -> int:
    import contextlib
    import io
    import os

    import numpy as np

    from color_modem_tpu_torch.frame.channel import impair
    from color_modem_tpu_torch.frame.image_io import load_rgb, save_composite, save_rgb
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.standards.decoders import allowed_decoders
    from color_modem_tpu_torch.utils.testimages import color_bars, smooth_scene
    from color_modem_tpu_torch.utils.upload import upload

    os.makedirs(args.out, exist_ok=True)
    report = {}

    def row(tag, out, ref):
        save_rgb(os.path.join(args.out, f"{tag}.png"), out)
        report[tag] = round(_psnr(out, ref), 2)

    for name, factory in ALL_STANDARDS.items():
        cfg = factory()
        lines = args.lines or cfg.active_lines
        rgb = (load_rgb(args.input, size=(args.width, lines)) if args.input
               else color_bars(lines, args.width).astype(np.float32))
        try:
            plan = _plan(cfg, args.width, dev)
        except ValueError as e:
            # e.g. SECAM needs >= 720-sample lines; skip, don't abort
            report[f"{name}_skipped"] = str(e)
            continue
        # the encode and the impaired composite do not depend on the
        # decoder: build them once per standard
        enc, _, _ = make_pipeline(plan, "notch", args.backend, dev)
        comp = enc(rgb[None], 0)
        save_composite(os.path.join(args.out, f"{name}_composite.png"), _host(comp)[0])
        bad = (impair(plan, comp, chroma_phase_deg=args.chroma_phase)
               if args.chroma_phase != 0.0 else None)
        dec_notch = None
        for decoder in allowed_decoders(cfg):
            if decoder in ("comb3d", "comb3dA"):
                continue  # temporal: needs a frame sequence, not a still
            _, dec, _ = make_pipeline(plan, decoder, args.backend, dev)
            if decoder == "notch":
                dec_notch = dec  # reused by --animate
            row(f"{name}_{decoder}", _host(dec(comp, 0))[0], rgb)
            if bad is not None:
                row(f"{name}_{decoder}_phase", _host(dec(bad, 0))[0], rgb)
        # the S-Video row: the same standard without the shared wire
        _, _, rt_s = make_svideo_pipeline(plan, args.backend, dev)
        row(f"{name}_svideo", _host(rt_s(rgb[None], 0))[0], rgb)
        # the RF rows (core standards): the VSB hop is transparent under
        # synchronous detection; the envelope-detected row shows the
        # authentic quadrature distortion
        if name in ("ntsc", "pal", "secam") and dec_notch is not None:
            from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate, rf_modulate

            rfp = make_rf_plan(plan)
            rf_sig = rf_modulate(rfp, comp, 0)
            for det in ("sync", "envelope"):
                row(f"{name}_rf" + ("" if det == "sync" else "_envelope"),
                    _host(dec_notch(rf_demodulate(rfp, rf_sig, 0, det), 0))[0], rgb)
            if name == "ntsc":
                # tape-dropout rows: raw damage vs the 1H compensator
                from color_modem_tpu_torch.frame.equalize import (
                    apply_equalizer,
                    design_equalizer,
                    gcr_record_guarded,
                )
                from color_modem_tpu_torch.frame.rf import rf_dropout, rf_ghost

                hit = rf_dropout(rfp, rf_sig, 7, rate=0.1)
                for tag, use_doc in (("ntsc_rf_dropouts", False), ("ntsc_rf_doc", True)):
                    row(tag, _host(dec_notch(rf_demodulate(rfp, hit, 0, doc=use_doc), 0))[0],
                        rgb)
                # RF multipath ghost vs the pivot-aware GCR canceller
                gh = rf_demodulate(rfp, rf_ghost(rfp, rf_sig, 3.0, 0.3), 0)
                row("ntsc_rf_ghost", _host(dec_notch(gh, 0))[0], rgb)
                rx_g = rf_demodulate(rfp, rf_ghost(rfp, rf_modulate(
                    rfp, upload(gcr_record_guarded(plan), dev)[None], 0), 3.0, 0.3), 0)[0][:3]
                pv = rfp.video_zero
                taps = design_equalizer(plan, rx_g, ntaps=1281, reg=1e-4, pivot=pv)
                row("ntsc_rf_ghost_eq",
                    _host(dec_notch(apply_equalizer(gh, taps, pivot=pv), 0))[0], rgb)
        if name == "pal":
            # conditional-access row: cut-and-rotate on the rastered signal
            # (active video scrambles, sync and burst stay in the clear), the
            # pirate's screen against the keyed subscriber's
            from color_modem_tpu_torch.frame.pipeline import frame_line_index
            from color_modem_tpu_torch.frame.raster import make_raster
            from color_modem_tpu_torch.frame.scramble import descramble, scramble

            enc_r, dec_r, _ = make_pipeline(plan, "comb3", args.backend, dev, raster=True)
            comp_r = enc_r(rgb[None], 0)
            g_g = frame_line_index(plan, 0, 1, lines, dev)
            off_g = make_raster(plan).n_blank
            scr_g = scramble(plan, comp_r, g_g, "cutrotate", 0x5EC4E7, active_start=off_g)
            row("pal_scrambled_pirate", _host(dec_r(scr_g, 0))[0], rgb)
            row("pal_descrambled", _host(dec_r(descramble(
                plan, scr_g, g_g, "cutrotate", 0x5EC4E7, active_start=off_g), 0))[0], rgb)
        if args.animate > 0:
            from color_modem_tpu_torch.frame.image_io import save_gif

            crawl = [_host(dec_notch(enc(rgb[None], i), i))[0] for i in range(args.animate)]
            save_gif(os.path.join(args.out, f"{name}_crawl.gif"), crawl)
    # D2-MAC row: the time-multiplexed family, whose composite PNG shows
    # burst, chroma and luma segments side by side
    from color_modem_tpu_torch.modem import mac as mac_mod
    from color_modem_tpu_torch.modem.mac_plan import make_mac_plan

    lines = args.lines or 576
    rgb = (load_rgb(args.input, size=(args.width, lines)) if args.input
           else color_bars(lines, args.width).astype(np.float32))
    mplan = make_mac_plan(args.width)
    g = upload(np.arange(lines), dev)
    sig = mac_mod.encode(mplan, upload(rgb, dev), g)
    save_composite(os.path.join(args.out, "d2mac_signal.png"), _host(sig), lo=0.0, hi=1.0)
    row("d2mac", _host(mac_mod.decode(mplan, sig, g)), rgb)
    # PALplus row: the 625i service over the full stack (interlaced,
    # rastered, VSB RF hop) on the helper-band fixture (a smooth scene plus
    # a 0.42-cycles/line vertical cosine, the band plain letterboxing
    # destroys), with the conventional receiver's zoom beside it
    if lines % 16 == 0:
        from color_modem_tpu_torch.frame.palplus import make_interlaced_palplus_pipeline
        from color_modem_tpu_torch.frame.raster import make_raster
        from color_modem_tpu_torch.frame.rf import make_rf_plan, rf_demodulate, rf_modulate

        pp_plan = _plan(ALL_STANDARDS["pal"](), args.width, dev)
        if args.input:
            rgb_pp = load_rgb(args.input, size=(args.width, lines))
        else:
            vert = 0.25 * np.cos(2 * np.pi * 0.42 * np.arange(lines))[:, None]
            rgb_pp = np.clip(smooth_scene(lines, args.width, seed=3) + vert[None], 0.0,
                             1.0).astype(np.float32)
        enc_pp, dec_pp, _ = make_interlaced_palplus_pipeline(pp_plan, "comb3", args.backend,
                                                             raster=True, device=dev)
        comp_pp = enc_pp(rgb_pp[None], 0)
        rfp_pp = make_rf_plan(pp_plan, row_samples=make_raster(pp_plan).n_total)
        comp_pp = rf_demodulate(rfp_pp, rf_modulate(rfp_pp, comp_pp, 0), 0)
        for tag, use_h in (("palplus", True), ("palplus_zoom", False)):
            row(tag, _host(dec_pp(comp_pp, 0, use_helper=use_h))[0], rgb_pp)
    if args.fullstack:
        # the full-stack row, rendered through the same one-shot roundtrip
        # verb the full-stack tests drive, so the picture and the asserted
        # composition cannot drift apart
        stacks = (
            ("pal_fullstack", ["--teletext", "FULL STACK|AUTHENTIC BROADCAST", "--rf",
                               "--rf-audio", "--rf-nicam"]),
            ("pal_fullstack_satellite", ["--teletext", "FULL STACK|VIA ASTRA",
                                         "--satellite", "--sat-stereo"]),
        )
        for tag, extra in stacks:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main([
                    "roundtrip", "--standard", "pal", "--decoder", "comb3", "--demo",
                    "--pattern", "scene", "--lines", "576", "--width", "1440", "--raster",
                    "--interlaced", "--wss", "16:9 full (anamorphic)", "--vitc",
                    "01:02:03:04", "--caption", "FULL STACK", "--scramble", "cutrotate",
                    *extra, "--backend", args.backend, "--device", str(dev),
                    "--output", os.path.join(args.out, f"{tag}.png"),
                ])
            if rc != 0:
                raise SystemExit(f"gallery --fullstack: sub-roundtrip {tag} failed (rc={rc}); "
                                 f"output:\n{buf.getvalue()}")
            rep = json.loads(buf.getvalue().strip().splitlines()[-1])
            report[tag] = rep["psnr_db"]
            if tag == "pal_fullstack":
                report["pal_fullstack_pirate"] = rep["scramble"]["pirate_psnr_db"]
            else:
                report["pal_fullstack_satellite_audio"] = rep["satellite"].get("audio_snr_db")
            report[f"{tag}_services"] = {k: rep[k]["exact"]
                                         for k in ("caption", "teletext", "wss", "vitc")}
    print(json.dumps({"out": args.out, "psnr_db": report}))
    return 0


# --- video --------------------------------------------------------------------------------


def _snr_crop(got, want, crop: int) -> float:
    import numpy as np

    e = got[..., crop:-crop] - want[..., crop:-crop]
    return round(float(10 * np.log10(max(float(np.mean(want[..., crop:-crop] ** 2)), 1e-20)
                                     / max(float(np.mean(e ** 2)), 1e-20))), 2)


def _video(args, dev) -> int:
    import glob
    import os

    import numpy as np
    import torch

    from color_modem_tpu_torch.frame.video import (
        process_video,
        synthetic_device_source,
        synthetic_source,
    )
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.utils.upload import upload

    cfg = ALL_STANDARDS[args.standard]()
    fps = (30000, 1001) if cfg.total_lines == 525 else (25, 1)
    mesh = None
    if args.mesh:
        from color_modem_tpu_torch.parallel.mesh import make_mesh

        f, l = (int(v) for v in args.mesh.split("x"))
        # NCCL on the card (one card per rank), gloo on the CPU; every rank
        # computes on its mesh's device
        mesh = make_mesh(f, l, backend="nccl" if dev.type == "cuda" else "gloo",
                         device="cpu" if dev.type == "cpu" else None)
        dev = mesh.device
    if args.input:
        from color_modem_tpu_torch.frame.y4m import prefetch_source, y4m_source

        source, clip_n, clip_h, clip_w = y4m_source(args.input)
        # double-buffered loader: the next chunk's disk read and YCbCr decode
        # overlap the device's work on this one
        source = prefetch_source(source, clip_n)
        lines, width = clip_h, clip_w
        n_frames = min(args.frames, clip_n) if args.frames else clip_n
    else:
        lines, width = args.lines or cfg.active_lines, args.width
        n_frames = args.frames or 32
        source = (synthetic_source(lines, width) if args.host_source
                  else synthetic_device_source(lines, width, device=dev))
    plan = _plan(cfg, width, dev)
    # sparse dict, only non-default keys: the resume manifest compares
    # channel configs by equality, so a new option must not change it
    sparse = {
        "noise_sigma": (args.noise, 0.0),
        "chroma_gain": (args.chroma_gain, 1.0),
        "chroma_phase_deg": (args.chroma_phase, 0.0),
        "diff_gain": (args.diff_gain, 0.0),
        "diff_phase_deg": (args.diff_phase, 0.0),
        "ghost_delay_us": (args.ghost_delay_us, 0.0),
        "ghost_gain": (args.ghost_gain, 0.0),
        "equalize": (args.equalize, False),
        "vhs": (args.vhs, False),
    }
    channel = {k: v for k, (v, dflt) in sparse.items() if v != dflt}
    # a ghost delay alone (gain 0) is a no-op knob, not a channel config
    if set(channel) == {"ghost_delay_us"}:
        channel = {}
    channel = channel or None
    cap_bits = None
    if args.caption:
        from color_modem_tpu_torch.frame.vbi import cc_pack

        text = args.caption.ljust(2 * n_frames)[: 2 * n_frames]
        if len(args.caption) > 2 * n_frames:
            raise SystemExit(f"--caption: {len(args.caption)} chars need "
                             f"{(len(args.caption) + 1) // 2} frames, run has {n_frames}")
        cap_bits = np.stack([cc_pack(text[2 * i : 2 * i + 2]).numpy() for i in range(n_frames)])
    vid_audio = None
    vid_st = None  # (2, T) source pair when --rf-stereo (for SNRs)
    if args.rf_audio_in or args.rf_stereo:
        if not args.rf:
            raise SystemExit("--rf-audio-in/--rf-stereo ride the RF sound carrier: add --rf")
        n_samp = n_frames * lines * width
        if args.rf_audio_in:
            from color_modem_tpu_torch.utils.wav import read_wav, resample_linear

            wv, wr = read_wav(args.rf_audio_in)
            if args.rf_stereo and wv.shape[0] < 2:
                wv = np.concatenate([wv, wv])
            tracks = resample_linear(wv[: 2 if args.rf_stereo else 1], wr, plan.fs,
                                     n_out=n_samp).astype(np.float32)
        else:  # --rf-stereo demo tones
            tt = np.arange(n_samp) / plan.fs
            tracks = np.stack([0.7 * np.sin(2 * np.pi * 1000 * tt),
                               0.5 * np.sin(2 * np.pi * 3000 * tt)]).astype(np.float32)
        if args.rf_stereo:
            from color_modem_tpu_torch.frame.mts import mts_encode

            vid_st = tracks
            # the MTS multiplex is itself a composite-rate stream: the
            # runner carries it like mono audio; L/R come out at the end
            vid_audio = _host(mts_encode(plan, upload(tracks[:1], dev),
                                         upload(tracks[1:2], dev)))[0].astype(np.float32)
        else:
            vid_audio = tracks[0]
    summary = process_video(
        plan, source, n_frames, args.out,
        decoder=args.decoder, chunk=args.chunk, mesh=mesh, backend=args.backend,
        device=dev, resume=not args.no_resume, lines=lines, channel=channel,
        interlaced=args.interlaced, nr=args.nr is not None, nr_sigma=args.nr,
        rf=args.rf, rf_audio=vid_audio, rf_audio_bw=50e3 if args.rf_stereo else 15e3,
        satellite=args.satellite or args.sat_cnr is not None, sat_cnr=args.sat_cnr,
        save_outputs=args.output is not None, caption_bits=cap_bits,
        scramble=(args.scramble, args.scramble_key) if args.scramble else None,
    )
    if mesh is not None:
        torch.distributed.destroy_process_group()
        if summary is None:  # ranks other than 0 report nothing
            return 0
    if vid_audio is not None and (args.audio_out or vid_st is not None):
        from color_modem_tpu_torch.utils.wav import resample_linear, write_wav

        rec = np.concatenate([np.load(p) for p in sorted(
            glob.glob(os.path.join(args.out, "aud_*.npy")))])
        if vid_st is not None:
            from color_modem_tpu_torch.frame.mts import mts_decode

            l2, r2, pilot = mts_decode(plan, upload(rec[None], dev))
            chans = np.stack([_host(l2)[0], _host(r2)[0]])
            crop = min(16384, rec.size // 4)
            summary["stereo"] = {
                "left_snr_db": _snr_crop(chans[0], vid_st[0], crop),
                "right_snr_db": _snr_crop(chans[1], vid_st[1], crop),
                "pilot": round(float(np.mean(_host(pilot))), 4),
            }
        else:
            chans = rec[None]
        if args.audio_out:
            write_wav(args.audio_out, resample_linear(chans, plan.fs, 48000.0), 48000)
            summary["audio_out"] = args.audio_out
    if args.caption:
        # the receiver's text, assembled from the per-chunk decoded cells
        from color_modem_tpu_torch.frame.vbi import cc_unpack

        got, ok = [], True
        for p in sorted(glob.glob(os.path.join(args.out, "cc_*.npy"))):
            for cell in np.load(p):
                s, good = cc_unpack(cell)
                got.append(s)
                ok = ok and good
        received = "".join(got)
        summary["caption"] = {"sent": text.rstrip(), "received": received.rstrip(),
                              "exact": received == text and ok, "parity_ok": ok}
    if args.output:
        # one clip from the per-chunk outputs, in chunk order (every finished
        # chunk left its rgb_*.npy behind, so a resumed run assembles too)
        from color_modem_tpu_torch.frame.y4m import write_y4m

        files = sorted(glob.glob(os.path.join(args.out, "rgb_*.npy")))
        written = write_y4m(args.output, (np.load(p) for p in files), fps=fps)
        summary["output"] = args.output
        summary["output_frames"] = written
        if written != n_frames:
            summary["output_incomplete"] = (
                "some chunks predate --output (resumed run without save_outputs) — rerun "
                "with --no-resume to regenerate")
    print(json.dumps(summary))
    return 0


# --- encode, decode, roundtrip ------------------------------------------------------------


def _single_frame(args, dev) -> int:
    """The one-frame verbs: encode, decode and the composable roundtrip."""
    import numpy as np

    from color_modem_tpu_torch.frame.image_io import save_composite, save_rgb
    from color_modem_tpu_torch.frame.pipeline import make_pipeline

    if args.cmd == "decode":
        from color_modem_tpu_torch.standards import ALL_STANDARDS

        rgb, cfg = None, ALL_STANDARDS[args.standard]()
    else:
        rgb, cfg = _load_input(args, dev)
    plan = _plan(cfg, args.width, dev)
    interlaced = getattr(args, "interlaced", False)
    svideo = getattr(args, "svideo", False)
    wants_rf = any(
        getattr(args, k, None) not in (None, False, 0.0, "sync")
        for k in ("rf", "rf_noise", "rf_recover", "rf_audio", "rf_stereo", "rf_nicam",
                  "rf_detection", "rf_phase_error", "rf_agc", "rf_freq_error", "rf_aft",
                  "rf_ghost_gain", "rf_equalize", "rf_audio_in", "audio_out")
    ) or getattr(args, "rf_gain", 1.0) != 1.0
    if getattr(args, "rf_agc", False) and not getattr(args, "raster", False):
        raise SystemExit("--rf-agc needs --raster: the AGC is keyed on the sync tip, which "
                         "only exists in a rastered composite")
    if getattr(args, "rf_agc", False) and getattr(args, "rf_equalize", False):
        raise SystemExit("--rf-agc and --rf-equalize don't combine: the equalizer corrects "
                         "gain itself (a flat gain is a linear channel), and AGC-normalizing "
                         "only the picture path would double-correct")
    if svideo:
        if interlaced or args.raster or getattr(args, "burst_locked", False):
            raise SystemExit("--svideo does not combine with --interlaced/--raster/"
                             "--burst-locked (separate wires carry no raster)")
        if wants_rf:
            raise SystemExit("--svideo does not combine with --rf* (the RF layer transmits "
                             "the single composite wire; Y/C are two wires)")
        if getattr(args, "caption", None) or getattr(args, "teletext", None):
            raise SystemExit("--svideo does not combine with --caption/--teletext (the data "
                             "line rides the composite wire)")
        from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline

        encode, decode, _ = make_svideo_pipeline(plan, args.backend, dev)
    elif interlaced:
        if getattr(args, "burst_locked", False):
            raise SystemExit("--interlaced does not combine with --burst-locked")
        from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline

        encode, decode, _ = make_interlaced_pipeline(plan, args.decoder, args.backend, dev,
                                                     raster=args.raster)
    else:
        encode, decode, _ = make_pipeline(plan, args.decoder, args.backend, dev,
                                          raster=args.raster)
    result = {"standard": args.standard, "decoder": args.decoder, "width": args.width,
              "backend": args.backend, "device": dev.type, "raster": args.raster}
    if interlaced:
        result["interlaced"] = True
    if svideo:
        result["svideo"] = True
        result["decoder"] = "svideo"

    t0 = time.perf_counter()
    if args.cmd == "encode":
        comp = _host(encode(rgb[None], args.frame))[0]
        save_composite(args.output, comp)
        if args.raw:
            np.save(args.raw, comp)
        result.update(output=args.output, lines=comp.shape[0])
    elif args.cmd == "decode":
        comp = np.load(args.input).astype(np.float32)
        out = _host(decode(comp[None], args.frame))[0]
        save_rgb(args.output, out)
        result.update(output=args.output, lines=comp.shape[0])
    else:
        _roundtrip(args, dev, plan, rgb, encode, decode, result)
    result["seconds"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(result))
    return 0


def _data_offset(args, plan) -> int:
    """Where a data or test line starts: after the blanking of a rastered
    row, else at sample 0."""
    if not args.raster:
        return 0
    from color_modem_tpu_torch.frame.raster import make_raster

    return make_raster(plan).n_blank


def _roundtrip(args, dev, plan, rgb, encode, decode, result) -> None:
    """RGB -> the transmitter's services -> a hop -> the channel -> the
    receiver's corrections -> RGB, in the JAX CLI's order; fills
    ``result``."""
    import numpy as np

    from color_modem_tpu_torch.frame.channel import impair
    from color_modem_tpu_torch.frame.image_io import save_composite, save_rgb
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.utils.upload import upload

    interlaced, svideo = args.interlaced, args.svideo
    off = _data_offset(args, plan)
    n_lines = rgb.shape[1]
    n_vits = 0
    if args.vits:
        # the test stimuli replace the bottom rows of the input before
        # encoding, so they ride every channel, RF and receiver stage:
        # in-service measurement
        if svideo or interlaced:
            raise SystemExit("--vits does not combine with --svideo/--interlaced")
        from color_modem_tpu_torch.frame.measure import modulated_staircase, multiburst

        k = 4
        is_qam = not plan.cfg.is_fm
        n_vits = (2 * k) if is_qam else k
        if n_lines < 2 * n_vits:
            raise SystemExit(f"--vits needs >= {2*n_vits} lines, frame has {n_lines}")
        rgb = rgb.copy()
        if is_qam:
            rgb[:, -2 * k : -k] = modulated_staircase(plan, k, rgb.shape[2])
        rgb[:, -k:] = multiburst(plan, k)[..., : rgb.shape[2]]
    # an interlaced encode of one frame yields two field blocks, so the
    # composite stays batch-shaped (and on the device) throughout
    comp_b = encode(rgb[None], args.frame)
    cap_rows, cap_text, cap_spec = 0, None, None
    if args.caption:
        # line-21 style caption cells on the top rows (a still frame stacks
        # what a broadcast spreads over successive frames)
        from color_modem_tpu_torch.frame.vbi import cc_pack, cc_spec, encode_data_line

        cap_text = args.caption + (" " if len(args.caption) % 2 else "")
        cells = [cap_text[i : i + 2] for i in range(0, len(cap_text), 2)]
        cap_rows = len(cells)
        if cap_rows > n_lines // 4:
            raise SystemExit(f"--caption: {len(cap_text)} chars need {cap_rows} data rows — "
                             f"too many for a {n_lines}-line frame")
        cap_spec = cc_spec(plan)
        comp_b[0, :cap_rows, off:] = encode_data_line(
            plan, cap_spec, upload(np.stack([cc_pack(c).numpy() for c in cells]), dev))
    ttx_rows, ttx_texts = 0, None
    if args.teletext:
        # a WST teletext page on the rows after the captions
        from color_modem_tpu_torch.frame import teletext as ttx_mod

        ttx_texts = args.teletext.split("|")
        try:
            ttx_mod.wst_spec(plan)  # validate the grid before encoding
        except ValueError as e:
            raise SystemExit(f"--teletext: {e}")
        n_need = 1 + len(ttx_texts)
        if cap_rows + n_need > n_lines // 2:
            raise SystemExit(f"--teletext: {n_need} data rows (header + {len(ttx_texts)}) "
                             f"don't fit a {n_lines}-line frame alongside {cap_rows} caption "
                             "rows")
        waves = ttx_mod.encode_page(plan, 1, 0x00, ttx_texts,
                                    header=f"P100 {plan.cfg.name.upper()}", device=dev)
        ttx_rows = int(waves.shape[0])
        comp_b[0, cap_rows : cap_rows + ttx_rows, off:] = waves
    ident_rows = 0
    if args.secam_ident:
        if not plan.cfg.is_fm:
            raise SystemExit("--secam-ident is a SECAM feature")
        if interlaced or svideo:
            raise SystemExit("--secam-ident does not combine with --interlaced/--svideo")
        from color_modem_tpu_torch.modem import secam as secam_mod

        if args.caption or args.teletext or args.wss:
            raise SystemExit("--secam-ident shares the top rows with the data-line options; "
                             "use it alone")
        ident_rows = 4
        # with --raster the bottles ride the active region of normal
        # rastered lines, as broadcast
        g_tx = frame_line_index(plan, args.frame, 1, n_lines, dev)
        comp_b[:, :ident_rows, off:] = secam_mod.ident_lines(plan, g_tx[:, :ident_rows])
    vir_rows = 0
    if args.vir:
        if plan.cfg.is_fm:
            raise SystemExit("--vir needs a QAM subcarrier (FM chroma has no amplitude/phase "
                             "to reference)")
        if svideo or args.burst_locked:
            # burst-locked decoding measures the same phase and gain the VIR
            # would: the two corrections would fight
            raise SystemExit("--vir does not combine with --svideo/--burst-locked")
        if interlaced and args.decoder in ("comb3d", "comb3dA"):
            raise SystemExit("--vir --interlaced decodes per field with per-field "
                             "corrections; the temporal combs need frame batches")
        if args.caption or args.teletext or args.secam_ident or args.wss or args.vitc:
            raise SystemExit("--vir shares the top rows with the other data-line options; "
                             "use it alone")
        from color_modem_tpu_torch.frame.vir import vir_lines

        vir_rows = 2
        if interlaced:
            # one reference line atop each field (the real line 19 rode every
            # field's vertical interval); the two rows weave to the frame's
            # top 2 rows for the accounting
            from color_modem_tpu_torch.frame.interlace import field_line_index

            g_vir = field_line_index(plan, args.frame, 1, n_lines // 2, dev)
            comp_b[:, :1, off:] = vir_lines(plan, g_vir[:, :1])
        else:
            g_vir = frame_line_index(plan, args.frame, 1, n_lines, dev)
            comp_b[:, :vir_rows, off:] = vir_lines(plan, g_vir[:, :vir_rows])
    wss_row = -1
    if args.wss:
        from color_modem_tpu_torch.frame import wss as wss_mod

        if args.wss not in wss_mod.ASPECT_CODES:
            raise SystemExit(f"--wss: unknown aspect {args.wss!r}; one of "
                             f"{sorted(wss_mod.ASPECT_CODES)}")
        wss_row = cap_rows + ttx_rows
        comp_b[0, wss_row, off:] = wss_mod.encode_wss(
            plan, upload(wss_mod.wss_word(args.wss).numpy(), dev))
    vitc_row, vitc_sent = -1, None
    if args.vitc:
        from color_modem_tpu_torch.frame import vitc as vitc_mod

        try:
            hh, mm, ss, ff = (int(v) for v in args.vitc.split(":"))
        except ValueError:
            raise SystemExit(f"--vitc: want HH:MM:SS:FF, got {args.vitc!r}")
        vitc_sent = (hh, mm, ss, ff)
        vitc_row = cap_rows + ttx_rows + (1 if wss_row >= 0 else 0)
        comp_b[0, vitc_row, off:] = vitc_mod.encode_vitc_line(
            plan, upload(vitc_mod.vitc_pack(hh, mm, ss, ff), dev))
    pirate_comp = None
    if args.scramble:
        # transmitter-side scrambling of the finished composite, after the
        # data services (they descramble bit-exactly like the picture);
        # composes with --raster (active video scrambles, sync and burst
        # stay in the clear), --interlaced (the key schedule follows the
        # field-sequential line numbering) and the --rf / --satellite hops
        if svideo:
            raise SystemExit("--scramble does not combine with --svideo (scrambling is a "
                             "single-wire composite operation)")
        if args.equalize or args.tbc:
            raise SystemExit("--scramble does not combine with --equalize/--tbc (both lock "
                             "onto stream continuity the scrambled signal deliberately "
                             "destroys; descramble first)")
        from color_modem_tpu_torch.frame.scramble import SHUFFLE_WINDOW, scramble

        scr_rows = n_lines // 2 if interlaced else n_lines
        if args.scramble == "shuffle" and scr_rows % SHUFFLE_WINDOW:
            raise SystemExit(f"--scramble shuffle permutes within {SHUFFLE_WINDOW}-line "
                             f"windows: needs the {'field' if interlaced else 'frame'} line "
                             f"count ({scr_rows}) divisible by {SHUFFLE_WINDOW}")
        if interlaced:
            from color_modem_tpu_torch.frame.interlace import field_line_index

            g_scr = field_line_index(plan, args.frame, 1, n_lines // 2, dev)
        else:
            g_scr = frame_line_index(plan, args.frame, 1, n_lines, dev)
        comp_b = scramble(plan, comp_b, g_scr, args.scramble, args.scramble_key,
                          active_start=off)
    sat_sound = bool(args.sat_audio or args.sat_stereo or args.sat_audio_in)
    sat_hop = args.satellite or args.sat_cnr is not None or sat_sound
    if sat_hop:
        if args.rf or args.rf_noise > 0.0:
            raise SystemExit("--satellite (FM) and --rf (VSB-AM) are different transmission "
                             "layers; pick one")
        comp_b = _satellite_hop(args, dev, plan, comp_b, sat_sound, result)
    if (args.rf or args.rf_noise > 0.0 or args.rf_recover or args.rf_audio
            or args.rf_stereo or args.rf_nicam or args.rf_a2
            or args.rf_dropouts > 0.0 or args.rf_doc
            or args.rf_detection != "sync" or args.rf_phase_error != 0.0
            or args.rf_gain != 1.0 or args.rf_agc
            or args.rf_freq_error != 0.0 or args.rf_aft
            or args.rf_ghost_gain != 0.0 or args.rf_equalize
            or args.rf_audio_in or (args.audio_out and not sat_hop)):
        # the RF hop first (it is the transmission); the composite-level
        # impairments below model the receiver-side degradations
        comp_b = _rf_hop(args, dev, plan, comp_b, result)
    channel = {"noise": args.noise, "chroma_gain": args.chroma_gain,
               "chroma_phase_deg": args.chroma_phase, "diff_gain": args.diff_gain,
               "diff_phase_deg": args.diff_phase, "ghost_delay_us": args.ghost_delay_us,
               "ghost_gain": args.ghost_gain}
    impair_kw = dict(
        noise_sigma=args.noise, chroma_gain=args.chroma_gain,
        chroma_phase_deg=args.chroma_phase, diff_gain=args.diff_gain,
        diff_phase_deg=args.diff_phase, ghost_delay_us=args.ghost_delay_us,
        ghost_gain=args.ghost_gain,
    )
    if any([args.noise > 0.0, args.chroma_gain != 1.0, args.chroma_phase != 0.0,
            args.diff_gain != 0.0, args.diff_phase != 0.0, args.ghost_gain != 0.0]):
        key = PRNGKey(0) if args.noise > 0.0 else None
        comp_b = impair(plan, comp_b, key=key, **impair_kw)
        result["channel"] = channel
    if args.equalize:
        from color_modem_tpu_torch.frame.equalize import (
            apply_equalizer,
            design_equalizer,
            gcr_record,
            ntaps_for_delay,
        )

        # the GCR record sees its own noise realisation
        rx = impair(plan, upload(gcr_record(plan), dev)[None],
                    key=PRNGKey(1) if args.noise > 0.0 else None, **impair_kw)[0]
        # reach the requested ghost's echoes, not just the default 64
        taps = design_equalizer(plan, rx, ntaps=ntaps_for_delay(plan, args.ghost_delay_us))
        comp_b = apply_equalizer(comp_b, taps)
        result["equalized"] = True
    if args.vhs:
        from color_modem_tpu_torch.frame.channel import vhs_playback

        comp_b = vhs_playback(plan, comp_b)
        result["vhs"] = True
    if args.tbe_us != 0.0 or args.tbe_flagging_us != 0.0 or args.tbc:
        # (the raster and interlace preconditions were validated up front)
        from color_modem_tpu_torch.frame.raster import make_raster
        from color_modem_tpu_torch.frame.timebase import (
            correctable_reach,
            impair_timebase,
            tbc_correct,
        )

        rp = make_raster(plan)
        # refuse to claim correction beyond the estimator's physical reach:
        # outside it the estimate degrades silently
        worst = (abs(args.tbe_us) + abs(args.tbe_flagging_us)) * 1e-6
        need = int(np.ceil(worst * plan.fs)) + 1
        reach = correctable_reach(rp)
        if args.tbc and need > reach:
            raise SystemExit(f"--tbc cannot reach {worst*1e6:.2f} us of time-base error: the "
                             "single-line sync/burst estimator's limit at this geometry is "
                             f"~{reach/plan.fs*1e6:.2f} us ({reach} samples)")
        if args.tbe_us != 0.0 or args.tbe_flagging_us != 0.0:
            comp_b, _ = impair_timebase(plan, comp_b, wobble_us=args.tbe_us,
                                        flagging_us=args.tbe_flagging_us)
            result["tbe"] = {"wobble_us": args.tbe_us, "flagging_us": args.tbe_flagging_us}
        if args.tbc:
            g = frame_line_index(plan, args.frame, 1, n_lines, dev)
            comp_b = tbc_correct(plan, rp, comp_b, g)
            result["tbc"] = True
    if args.scramble:
        # receiver side: keep the pirate's view, then descramble
        from color_modem_tpu_torch.frame.scramble import descramble

        pirate_comp = comp_b
        comp_b = descramble(plan, comp_b, g_scr, args.scramble, args.scramble_key,
                            active_start=off)
    out = _receive(args, dev, plan, comp_b, decode, n_lines, ident_rows, vir_rows, result,
                   g_tx if ident_rows else None)
    if cap_rows:
        # the data lines are read off the received composite, after every
        # receiver correction (equalizer, TBC, RF loops)
        from color_modem_tpu_torch.frame.vbi import cc_unpack, decode_data_line

        bits, margin = decode_data_line(plan, cap_spec, comp_b[0, :cap_rows, off:])
        cells = [cc_unpack(b) for b in bits.cpu()]
        received = "".join(s for s, _ in cells)
        result["caption"] = {
            "sent": cap_text,
            "received": received,
            "exact": received == cap_text,
            "parity_ok": all(ok for _, ok in cells),
            "worst_margin": round(min(1.0, float(margin.min())), 3),
        }
    if ttx_rows:
        from color_modem_tpu_torch.frame import teletext as ttx_mod

        pkts = ttx_mod.decode_packets(plan, comp_b[0, cap_rows : cap_rows + ttx_rows, off:])
        got_rows = [p.text.rstrip() for p in pkts[1:]]
        result["teletext"] = {
            "page": pkts[0].page,
            "header": pkts[0].text.rstrip(),
            "rows": got_rows,
            "exact": got_rows == [t.rstrip() for t in ttx_texts],
            "address_ok": all(p.address_ok for p in pkts),
            "parity_ok": all(bool(p.parity_ok.all()) for p in pkts),
            "worst_margin": round(min(p.margin for p in pkts), 3),
        }
    if wss_row >= 0:
        from color_modem_tpu_torch.frame import wss as wss_mod

        got, margin = wss_mod.decode_wss(plan, comp_b[0, wss_row, off:])
        rep = wss_mod.parse_wss(got)
        result["wss"] = {
            "sent": args.wss,
            "received": rep["aspect"],
            "exact": rep["aspect"] == args.wss and rep["aspect_ok"],
            "margin": round(float(margin), 3),
        }
    if vitc_row >= 0:
        from color_modem_tpu_torch.frame import vitc as vitc_mod

        got, score = vitc_mod.decode_vitc_line(plan, comp_b[0, vitc_row, off:])
        rep = vitc_mod.vitc_unpack(got)
        rx_tc = (rep["hours"], rep["minutes"], rep["seconds"], rep["frames"])
        result["vitc"] = {
            "sent": "%02d:%02d:%02d:%02d" % vitc_sent,
            "received": "%02d:%02d:%02d:%02d" % rx_tc,
            "exact": rx_tc == vitc_sent and rep["crc_ok"],
            "crc_ok": rep["crc_ok"],
            "sync_score": int(score),
        }
    if n_vits:
        # the staircase off the received composite (vectorscope readings),
        # the multiburst off the decoded luma (frequency response)
        from color_modem_tpu_torch.frame.measure import (
            measure_differential,
            measure_frequency_response,
        )

        k, L = 4, n_lines
        vits_report = {}
        if not plan.cfg.is_fm:
            g = frame_line_index(plan, args.frame, 1, L, dev)
            rep = measure_differential(plan, comp_b[:, L - 2 * k : L - k, off:],
                                       g[:, L - 2 * k : L - k])
            vits_report["dg"] = round(rep["dg"], 4)
            vits_report["dp_deg"] = round(rep["dp_deg"], 2)
        y = np.tensordot(plan.host["rgb_to_ycc"][0], out[:, L - k:], axes=(0, 0))
        freq = measure_frequency_response(plan, upload(y, dev, np.float32))
        vits_report["frequency_response"] = {f"{f}MHz": round(v, 3) for f, v in freq.items()}
        result["vits"] = vits_report
    svc_rows = (cap_rows + ttx_rows + (1 if wss_row >= 0 else 0)
                + (1 if vitc_row >= 0 else 0) + ident_rows)
    # interlaced: the data services ride field 0's top rows, which weave to
    # the even frame rows 0, 2, .., 2*svc_rows-2; leave the whole band out.
    # VIR keeps its own accounting (its decode rebuilds `out` with a
    # vir_rows zero prefix)
    data_rows = (2 * svc_rows if interlaced else svc_rows) + vir_rows
    hi = n_lines - n_vits
    if data_rows or n_vits:
        result["psnr_db"] = round(_psnr(out[:, data_rows:hi], rgb[:, data_rows:hi]), 2)
    else:
        result["psnr_db"] = round(_psnr(out, rgb), 2)
    if pirate_comp is not None:
        # the pirate's PSNR over the same picture rows as psnr_db
        pirate = _host(decode(pirate_comp, args.frame))[0]
        result["scramble"] = {
            "mode": args.scramble,
            "key": args.scramble_key,
            "pirate_psnr_db": round(_psnr(pirate[:, data_rows:hi], rgb[:, data_rows:hi]), 2),
        }
    result["lines"] = int(n_lines)
    if args.output:
        save_rgb(args.output, out)
        result["output"] = args.output
    if args.composite:
        if interlaced:
            from color_modem_tpu_torch.frame.interlace import weave_fields

            save_composite(args.composite, _host(weave_fields(comp_b))[0])
        elif svideo:
            # two wires: show the luma plane (the C plane has no meaningful
            # grayscale rendering)
            save_composite(args.composite, _host(comp_b)[0, 0])
        else:
            save_composite(args.composite, _host(comp_b)[0])
        result["composite"] = args.composite


def _receive(args, dev, plan, comp_b, decode, n_lines, ident_rows, vir_rows, result, g_tx):
    """The receiver's decode: burst-locked (with PAL ident), SECAM ident,
    VIR-corrected, or the plain decoder.  Returns the frame (3, L, N) on
    the host."""
    import numpy as np

    from color_modem_tpu_torch.frame.pipeline import decode_block, frame_line_index

    if args.burst_locked:
        from color_modem_tpu_torch.frame.raster import decode_burst_locked, make_raster

        rp = make_raster(plan)
        g = frame_line_index(plan, args.frame, 1, n_lines, dev)
        if args.pal_ident:
            # a slipped receiver line counter; the ident stage recovers the
            # V-switch parity from the burst
            from color_modem_tpu_torch.frame.raster import identify_vswitch

            g_rx = g + 1
            slip = identify_vswitch(plan, rp, comp_b, g_rx)
            g = g_rx + slip[..., None]
            slip0 = int(_host(slip)[0])
            result["pal_ident"] = {"rx_line_slip": 1, "identified_slip": slip0,
                                   "recovered": slip0 == 1}
        out = _host(decode_burst_locked(plan, rp, comp_b, g, args.decoder, args.backend,
                                        acc=args.acc, color_kill=args.color_kill))[0]
        result["burst_locked"] = True
        if args.acc:
            result["acc"] = True
        if args.color_kill > 0.0:
            result["color_kill"] = args.color_kill
        return out
    if ident_rows:
        # the receiver's line counter slipped one line; the bottles tell it
        # the D'R/D'B parity anyway.  With --raster the sync separator runs
        # first, then the data-line machinery: the real receiver's order
        from color_modem_tpu_torch.modem import secam as secam_mod

        comp_a = comp_b
        if args.raster:
            from color_modem_tpu_torch.frame.raster import make_raster, strip_raster

            comp_a = strip_raster(make_raster(plan), comp_b)
        rx_g = g_tx + 1
        swap = secam_mod.identify_from_ident(plan, comp_a[:, :ident_rows], rx_g[:, :ident_rows])
        out = _host(decode_block(plan, comp_a, rx_g + swap[..., None], args.decoder,
                                 args.backend))[0]
        swap0 = int(_host(swap)[0])
        result["secam_ident"] = {"rx_line_slip": 1, "identified_swap": swap0,
                                 "recovered": swap0 == 1}
        return out
    if vir_rows:
        # decode with the VIR-measured picture-level corrections; with
        # --raster, sync separation first, then the references
        from color_modem_tpu_torch.frame.vir import decode_vir_corrected, measure_vir

        comp_a = comp_b
        if args.raster:
            from color_modem_tpu_torch.frame.raster import make_raster, strip_raster

            comp_a = strip_raster(make_raster(plan), comp_b)
        if args.interlaced:
            # per-field references and corrections, then the corrected
            # fields weave back to the frame
            import torch

            from color_modem_tpu_torch.frame.interlace import field_line_index, weave_fields

            g_f = field_line_index(plan, args.frame, 1, comp_a.shape[-2], dev)
            rep = measure_vir(plan, comp_a[:, :1], g_f[:, :1])
            g_pic = g_f[:, 1:]
            ones = torch.ones(g_pic.shape, dtype=torch.float32, device=dev)
            fields = decode_block(plan, comp_a[:, 1:], g_pic, args.decoder, args.backend,
                                  phase_err=rep["phase_err"][..., None] * ones,
                                  chroma_gain=rep["chroma_gain_corr"][..., None] * ones)
            pic = _host(weave_fields(fields))[0]
        else:
            g = frame_line_index(plan, args.frame, 1, n_lines, dev)
            rep = measure_vir(plan, comp_a[:, :vir_rows], g[:, :vir_rows])
            pic = _host(decode_vir_corrected(plan, comp_a, g, vir_rows, args.decoder,
                                             args.backend))[0]
        # `out` stays frame-shaped for the PSNR accounting (the VIR rows
        # themselves are left out there)
        vals = {k: float(_host(rep[k])[0]) for k in ("chroma_gain_corr", "phase_err", "luma_ref")}
        result["vir"] = {
            "chroma_gain_corr": round(vals["chroma_gain_corr"], 3),
            "phase_err_deg": round(float(np.degrees(vals["phase_err"])), 2),
            "luma_ref": round(vals["luma_ref"], 3),
        }
        return np.concatenate([np.zeros_like(pic[:, :vir_rows]), pic], axis=1)
    return _host(decode(comp_b, args.frame))[0]


def _satellite_hop(args, dev, plan, comp_b, sat_sound: bool, result):
    """The FM satellite hop (with its audio subcarriers); returns the
    received composite."""
    import numpy as np

    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.utils.upload import upload

    b_s, l_s, n_row = comp_b.shape
    n_tot = l_s * n_row
    k_subs = 0
    sat_tx = None
    if sat_sound:
        k_subs = 2 if args.sat_stereo else 1
        if args.sat_audio_in:
            from color_modem_tpu_torch.utils.wav import read_wav, resample_linear

            wx, wr = read_wav(args.sat_audio_in)
            if args.sat_stereo or wx.shape[0] >= 2:
                k_subs = 2
            wav = resample_linear(wx, wr, plan.fs, n_out=n_tot)
            sat_tx = np.stack([wav[min(i, wav.shape[0] - 1)] for i in range(k_subs)]).astype(
                np.float32)
        else:
            # demo tones snapped to frame-periodic bins (the satellite block
            # is one period, frame/satellite.py)
            t_s = np.arange(n_tot) / plan.fs

            def bin_tone(f, amp):
                kk = max(1, round(f * n_tot / plan.fs))
                return amp * np.sin(2 * np.pi * (kk * plan.fs / n_tot) * t_s)

            if k_subs == 2:
                sat_tx = np.stack([bin_tone(1000, 0.7), bin_tone(3000, 0.5)]).astype(np.float32)
            else:
                sat_tx = (bin_tone(1000, 0.6) + bin_tone(7000, 0.3)).astype(np.float32)[None]
    sp = sat_mod.make_sat_plan(plan.fs, n_row, total_lines=plan.cfg.total_lines,
                               audio_subs=k_subs)
    comp_tx = comp_b
    sat_rf = sat_mod.fm_modulate(
        sp, comp_b,
        audio=upload(np.broadcast_to(sat_tx, (b_s, k_subs, n_tot)), dev) if k_subs else None)
    if args.sat_cnr is not None:
        sat_rf = sat_mod.awgn(sp, sat_rf, PRNGKey(11), args.sat_cnr)
    comp_b = sat_mod.fm_demodulate(sp, sat_rf)
    sat_transparency = _psnr(comp_b, comp_tx)
    result["satellite"] = {
        "deviation_mhz": round(sp.deviation / 1e6, 1),
        "fs_rf_mhz": round(sp.fs_rf / 1e6, 2),
        "transparency_db": round(sat_transparency, 2),
        **({"cnr_db": args.sat_cnr} if args.sat_cnr is not None else {}),
    }
    print("satellite FM hop: transparency "
          f"{sat_transparency:.1f} dB"
          + (f" at CNR {args.sat_cnr} dB" if args.sat_cnr is not None else " (noise-free)"))
    if k_subs:
        sat_rx = _host(sat_mod.fm_demodulate_audio(sp, sat_rf))[0]
        snrs = []
        for i in range(k_subs):
            ref = sat_tx[i] - sat_tx[i].mean()  # the receiver is AC-coupled
            err = sat_rx[i] - ref
            snrs.append(round(float(10 * np.log10(np.mean(ref ** 2)
                                                  / max(np.mean(err ** 2), 1e-30))), 1))
        subs_mhz = [round(f / 1e6, 2) for f in sp.sub_freqs]
        result["satellite"]["subcarriers_mhz"] = subs_mhz
        result["satellite"]["audio_snr_db"] = snrs
        print(f"satellite sound: {k_subs} FM subcarrier(s) at {subs_mhz} MHz, audio SNR "
              f"{snrs} dB")
        if args.audio_out:
            from color_modem_tpu_torch.utils.wav import resample_linear, write_wav

            write_wav(args.audio_out, resample_linear(sat_rx, plan.fs, 48000.0), 48000)
            print(f"wrote {args.audio_out}")
    return comp_b


def _rf_hop(args, dev, plan, comp_b, result):
    """The RF/VSB hop with its sound carriers, the receiver's tuning loops
    and the RF GCR equalizer; fills ``result["rf"]`` and returns the
    detected composite."""
    import dataclasses

    import numpy as np

    from color_modem_tpu_torch.frame.rf import (
        make_rf_plan,
        recover_carrier_phase,
        rf_demodulate,
        rf_modulate,
    )
    from color_modem_tpu_torch.utils.upload import upload

    rf_kw = {}
    if args.rf_stereo:
        # MTS needs the wider sound channel (sidebands ~45 kHz)
        rf_kw["audio_bw"] = 50e3
    rf_row = None
    if args.raster:
        # rastered lines are longer rows on the same sample clock; the
        # carrier law snaps to the actual row length
        from color_modem_tpu_torch.frame.raster import make_raster

        rf_row = make_raster(plan).n_total
        rf_kw["row_samples"] = rf_row
    rfp = make_rf_plan(plan, **rf_kw)
    # a channel carrier offset is a transmitter on a rotated carrier (the
    # receiver's mixers stay nominal)
    tx_rfp = rfp if args.rf_phase_error == 0.0 else dataclasses.replace(
        rfp, ramp=rfp.ramp + np.deg2rad(args.rf_phase_error))
    audio = None
    b_rf, l_rf, n_rf = comp_b.shape
    t = np.arange(l_rf * n_rf) / plan.fs
    wav_in = None
    if args.rf_audio_in:
        # real audio, resampled to the composite grid (one audio sample per
        # video sample, frame/rf.py)
        from color_modem_tpu_torch.utils.wav import read_wav, resample_linear

        wav_x, wav_rate = read_wav(args.rf_audio_in)
        wav_in = resample_linear(wav_x, wav_rate, plan.fs, n_out=l_rf * n_rf)
    a2_l = a2_r = None
    if args.rf_a2:
        if args.rf_stereo:
            raise SystemExit("--rf-a2 and --rf-stereo are different stereo systems (A2 "
                             "two-carrier vs MTS multiplex); pick one")
        if args.rf_nicam:
            raise SystemExit("--rf-a2 and --rf-nicam cannot share a channel: A2's second "
                             "carrier (FM sound + 15.5 fh = +242 kHz) sits inside NICAM's "
                             "lower sideband (+245..755 kHz) — no real channel plan carried "
                             "both (Germany used A2, NICAM countries NICAM); pick one")
        if wav_in is not None:
            st = wav_in if wav_in.shape[0] >= 2 else np.concatenate([wav_in, wav_in])
            a2_l, a2_r = st[0], st[1]
        else:
            a2_l = (0.6 * np.sin(2 * np.pi * 800 * t)
                    + 0.2 * np.sin(2 * np.pi * 5000 * t)).astype(np.float32)
            a2_r = (0.5 * np.sin(2 * np.pi * 2300 * t)).astype(np.float32)
        a2_l = np.broadcast_to(a2_l, (b_rf, l_rf * n_rf))
        a2_r = np.broadcast_to(a2_r, (b_rf, l_rf * n_rf))
        # carrier 1: the compatible mono sum (stereo) or program 1
        audio = upload(0.5 * (a2_l + a2_r) if args.rf_a2 == "stereo" else a2_l, dev)
    elif args.rf_stereo:
        from color_modem_tpu_torch.frame.mts import mts_encode

        if wav_in is not None:
            st = wav_in if wav_in.shape[0] >= 2 else np.concatenate([wav_in, wav_in])
            st_l = np.broadcast_to(st[0], (b_rf, l_rf * n_rf))
            st_r = np.broadcast_to(st[1], (b_rf, l_rf * n_rf))
        else:
            st_l = np.broadcast_to((0.7 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
                                   (b_rf, l_rf * n_rf))
            st_r = np.broadcast_to((0.5 * np.sin(2 * np.pi * 3000 * t)).astype(np.float32),
                                   (b_rf, l_rf * n_rf))
        audio = mts_encode(plan, upload(st_l, dev, np.float32), upload(st_r, dev, np.float32),
                           row_samples=rf_row)
    elif args.rf_audio or wav_in is not None:
        mono = (wav_in[0] if wav_in is not None else
                (0.6 * np.sin(2 * np.pi * 1000 * t)
                 + 0.3 * np.sin(2 * np.pi * 7000 * t)).astype(np.float32))
        audio = upload(np.broadcast_to(mono, (b_rf, l_rf * n_rf)), dev, np.float32)
    rf_sig = rf_modulate(tx_rfp, comp_b, args.frame, audio, df=args.rf_freq_error)
    a2p = None
    if args.rf_a2:
        from color_modem_tpu_torch.frame import a2 as a2_mod

        a2p = a2_mod.make_a2_plan(rfp)
        rf_sig = a2_mod.a2_on_rf(a2p, rf_sig, args.frame, upload(a2_r, dev, np.float32),
                                 args.rf_a2)
    nic_l = nic_r = None
    nic_cap = 0
    if args.rf_nicam:
        from color_modem_tpu_torch.frame import nicam as nicam_mod

        nic_cap = nicam_mod.nicam_capacity(rfp, rf_sig.shape)
        if nic_cap < 1:
            raise SystemExit("--rf-nicam: the RF block is shorter than one 728-bit NICAM "
                             "frame (~1 ms) — raise --lines")
        ta = np.arange(nicam_mod.BLOCK * nic_cap) / 32000.0
        nic_l = (0.7 * np.sin(2 * np.pi * 1000 * ta)).astype(np.float32)
        nic_r = (0.5 * np.sin(2 * np.pi * 3000 * ta)).astype(np.float32)
        rf_sig = nicam_mod.nicam_on_rf(rfp, rf_sig, upload(nic_l, dev), upload(nic_r, dev))
    if args.rf_gain != 1.0:
        # channel attenuation scales the carrier; receiver noise below is
        # added after it (noise lives at the receiver)
        rf_sig = args.rf_gain * rf_sig
    if args.rf_ghost_gain != 0.0:
        from color_modem_tpu_torch.frame.rf import rf_ghost

        rf_sig = rf_ghost(rfp, rf_sig, args.rf_ghost_delay_us, args.rf_ghost_gain)
    if args.rf_dropouts > 0.0:
        from color_modem_tpu_torch.frame.rf import rf_dropout

        rf_sig = rf_dropout(rfp, rf_sig, 7, rate=args.rf_dropouts)
    if args.rf_noise > 0.0:
        rf_sig = add_normal(rf_sig, args.rf_noise, PRNGKey(2))
    pe = 0.0
    df_hat = None
    if args.rf_aft:
        # AFT: estimate the offset, retune the stream back onto the Nyquist
        # flank; the phase recovery below locks the leftover static phase
        from color_modem_tpu_torch.frame.rf import recover_carrier_frequency, rf_retune

        df_hat = float(_host(recover_carrier_frequency(rfp, rf_sig, args.frame))[0])
        rf_sig = rf_retune(rfp, rf_sig, df_hat, args.frame)
    if args.rf_recover or args.rf_aft:
        # a circular mean: averaging atan2 angles is wrong near the wrap
        est = _host(recover_carrier_phase(rfp, rf_sig, args.frame))
        pe = float(np.arctan2(np.mean(np.sin(est)), np.mean(np.cos(est))))
    comp_b = rf_demodulate(rfp, rf_sig, args.frame, args.rf_detection, pe, doc=args.rf_doc,
                           agc=args.rf_agc)
    if args.rf_equalize:
        # the receiver's GCR path: the reference record rides the same RF
        # chain (its own noise realisation); estimation and correction
        # about the zero-carrier pivot (an RF channel is linear in the
        # envelope, not the composite)
        from color_modem_tpu_torch.frame.equalize import (
            apply_equalizer,
            design_equalizer,
            gcr_record_guarded,
        )
        from color_modem_tpu_torch.frame.rf import rf_ghost

        g = upload(gcr_record_guarded(plan, samples=rf_row), dev)[None]
        g_rf = rf_modulate(tx_rfp, g, args.frame, df=args.rf_freq_error)
        if args.rf_gain != 1.0:
            g_rf = args.rf_gain * g_rf
        if args.rf_ghost_gain != 0.0:
            g_rf = rf_ghost(rfp, g_rf, args.rf_ghost_delay_us, args.rf_ghost_gain)
        if args.rf_noise > 0.0:
            g_rf = add_normal(g_rf, args.rf_noise, PRNGKey(3))
        if args.rf_aft:
            g_rf = rf_retune(rfp, g_rf, df_hat, args.frame)
        rx_g = rf_demodulate(rfp, g_rf, args.frame, args.rf_detection, pe)[0][:3]
        per = 2 * (rf_row or plan.n_samples)
        ntaps = min(1281, per - 1)
        ntaps -= 1 - ntaps % 2
        pv = rfp.video_zero
        taps = design_equalizer(plan, rx_g, ntaps=ntaps,
                                reg=1e-4 if args.rf_noise == 0.0 else 1e-3, pivot=pv)
        comp_b = apply_equalizer(comp_b, taps, pivot=pv)
    audio_snr = stereo_report = a2_report = None
    audio_rec = None  # the recovered (channels, n) at the composite rate
    if args.rf_a2:
        # interlaced: the two fields are consecutive broadcast time, so the
        # ident-mode decision integrates over the field pair (one field is a
        # sub-cycle window for the 117/274 Hz ident tones)
        gl, gr, a2_info = a2_mod.a2_decode(a2p, rf_sig, args.frame,
                                           group=2 if args.interlaced else 1)
        gl, gr = _host(gl), _host(gr)
        audio_rec = np.stack([gl[0], gr[0]])
        crop = min(8192, gl.shape[-1] // 4)
        mono = a2_info["mode"][0] == "mono"
        want_l = 0.5 * (a2_l + a2_r) if mono else a2_l
        want_r = a2_r if not mono else want_l
        a2_report = {
            "mode_sent": args.rf_a2,
            "mode_detected": a2_info["mode"][0],
            "left_snr_db": _snr_crop(gl, want_l, crop),
            "right_snr_db": _snr_crop(gr, want_r, crop),
            "pilot_level": round(float(a2_info["pilot_level"][0]), 4),
            "carrier2_mhz": round(a2p.f_snd2 / 1e6, 4),
        }
    elif args.rf_stereo:
        from color_modem_tpu_torch.frame.mts import mts_decode
        from color_modem_tpu_torch.frame.rf import rf_demodulate_sound

        aud = rf_demodulate_sound(rfp, rf_sig, args.frame)
        l2, r2, pilot = mts_decode(plan, aud, row_samples=rf_row)
        l2, r2 = _host(l2), _host(r2)
        audio_rec = np.stack([l2[0], r2[0]])
        crop = min(16384, aud.shape[-1] // 4)
        stereo_report = {
            "left_snr_db": _snr_crop(l2, st_l, crop),
            "right_snr_db": _snr_crop(r2, st_r, crop),
            "pilot": round(float(np.mean(_host(pilot))), 4),
        }
    elif args.rf_audio or args.rf_audio_in:
        from color_modem_tpu_torch.frame.rf import rf_demodulate_sound

        aud = _host(rf_demodulate_sound(rfp, rf_sig, args.frame))
        audio_rec = aud[:1]
        crop = min(8192, aud.shape[-1] // 4)  # the audio LPF's transient
        audio_snr = _snr_crop(aud, _host(audio), crop)
    nicam_report = None
    if args.rf_nicam:
        n_l, n_r, n_rep, n_lock = nicam_mod.nicam_from_rf(rfp, rf_sig, nic_cap)

        def nsnr(got, want):
            e = _host(got) - want
            return 10.0 * np.log10(max(float(np.mean(want ** 2)), 1e-20)
                                   / max(float(np.mean(e ** 2)), 1e-20))

        nicam_report = {
            "frames": nic_cap,
            "left_snr_db": round(nsnr(n_l, nic_l), 2),
            "right_snr_db": round(nsnr(n_r, nic_r), 2),
            "parity_errors": int(_host(n_rep["parity_errors"]).sum()),
            "faw_ok": bool(_host(n_rep["faw_ok"]).all()),
            "offset_bits": int(_host(n_lock["offset_bits"])),
        }
    if args.audio_out:
        if audio_rec is None:
            raise SystemExit("--audio-out needs a sound transmission: add --rf-audio, "
                             "--rf-audio-in or --rf-stereo")
        from color_modem_tpu_torch.utils.wav import resample_linear, write_wav

        write_wav(args.audio_out, resample_linear(audio_rec, plan.fs, 48000.0), 48000)
        result["audio_out"] = args.audio_out
    result["rf"] = {
        "fc_mhz": round(rfp.fc / 1e6, 3),
        "f_snd_mhz": round(rfp.f_snd / 1e6, 3),
        "fs_rf_mhz": round(rfp.fs_rf / 1e6, 2),
        "detection": args.rf_detection,
        **({"noise": args.rf_noise} if args.rf_noise else {}),
        **({"dropouts": args.rf_dropouts, "doc": args.rf_doc}
           if args.rf_dropouts or args.rf_doc else {}),
        **({"phase_error_deg": args.rf_phase_error} if args.rf_phase_error else {}),
        **({"gain": args.rf_gain, "agc": args.rf_agc}
           if args.rf_gain != 1.0 or args.rf_agc else {}),
        **({"ghost_delay_us": args.rf_ghost_delay_us, "ghost_gain": args.rf_ghost_gain}
           if args.rf_ghost_gain else {}),
        **({"equalized": True} if args.rf_equalize else {}),
        **({"recovered_phase_deg": round(float(np.degrees(pe)), 2)}
           if args.rf_recover or args.rf_aft else {}),
        **({"freq_error_hz": args.rf_freq_error} if args.rf_freq_error else {}),
        **({"aft_recovered_hz": round(df_hat, 1)} if df_hat is not None else {}),
        **({"audio_snr_db": audio_snr} if audio_snr is not None else {}),
        **({"stereo": stereo_report} if stereo_report is not None else {}),
        **({"a2": a2_report} if a2_report is not None else {}),
        **({"nicam": nicam_report} if nicam_report is not None else {}),
    }
    return comp_b


if __name__ == "__main__":
    sys.exit(main())
