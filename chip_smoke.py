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
   same way, zero edges, <= 2e-6, over 18 shapes (ragged last tiles of lines
   included); each SECAM kernel (the tensor-core form with the lines as
   columns) against its plain version at 16x576x720 (the pipelined
   kernels: one block holds a line), 4x576x1440 (the serial kernels) and
   1x576x2160 (the serial kernels, the decoder cutting the line into 14
   spans), each width's kernel printed as the C sources choose it: encode
   <= 2e-4, decoded RGB and luma <= 5e-4, and the raw demodulated
   component's error printed;
3c. the kernels' memory sanitizer (``kernels/sanitize.py``): the poisoned
   build (``-DCMT_POISON``: shared memory filled with a NaN before the
   first staging) and the normal one, every input in a NaN-guarded
   allocation and every output in a sentinel-filled one, for each kernel
   row (NTSC, PAL and NIIR pairs, SECAM pair) at 1/63/65/481 lines x
   720/722/1440 samples (and 2160 on the SECAM pair) x 1/3 frames: poisoned
   bit-equal to normal, no NaN,
   sentinels and inputs intact, every output sample written, 20 launches
   identical; per kernel and shape a line; no wrapper launch counted; the
   threefry rows (the runner's per-item keys, one key, the normal alone,
   the raw bits) and the colour matrix's (``csrc/colour_matrix.cu``: the
   encoder's matrix, the decoder's with its clamp) at the QAM rows' shapes;
3d. the threefry generator (``csrc/threefry.cu``, JAX's ``jax.random``
   on the card): the bits against the plain version at 2^20 words exactly,
   ``x + sigma * normal`` at 16 x 480 x 2880 (the runner's satellite noise
   per chunk of 16 NTSC frames) with per-item ``fold_in`` from index 37
   within 1e-6, the normal alone, ``bernoulli`` and ``randint`` at
   ``rf_dropout``'s shape exactly; the card against the CPU (bits equal,
   normals within 1e-6); the card against values taken from ``jax.random``
   on the CPU (:data:`JAX_PINNED`); CUDA-event times of each entry point
   against its plain version, with ``torch.randn`` at the same shape as a
   yardstick (not the same function) and the bound;
3e. the colour matrix (``csrc/colour_matrix.cu``) against its plain version
   on the card at phase 4's 16x3x480x720, the NTSC batch's 64x3x480x720 and
   SECAM's 16x3x576x720, each standard's two matrices, the clamp on and
   off, within 1e-6, a NaN put into an input kept in its three outputs;
   CUDA-event times of each matrix against the plain version and the bound
   (``measure.colour_matrix_bound``).  The pipelines' plain backend takes
   the plain colour matrix, so the agreements of phases 4-4i cover it too.
   Then the delay-line pass (``delayline_matrix``: C1 and C2 averaged with
   the line before, then the decoder's matrix and clamp) against its plain
   composition at 16x3x576x720 and 64x3x576x720 on every standard's
   matrix (each has an averaging decoder), bit for bit, NaNs kept where the composition has
   them, and timed against it with the same six-plane bound.  Then the comb
   stencil's pass (``comb_stencil``: 'comb2' and 'comb3' at NTSC's spacing of
   1 line and PAL's of 2) against its plain composition at phase 4's
   16x480x720, the NTSC batch cell's 64x480x720 and PAL's 64x576x720, bit
   for bit, a NaN reaching the lines that read it, and timed against the
   composition with its two-plane bound (``measure.comb_stencil_bound``);
4. the main path, NTSC encode -> comb3 decode at 16x3x480x720 through
   ``make_pipeline(..., backend="kernel")``: round-trip PSNR 46.62 +- 0.02 dB,
   one launch of each kernel and two of the colour matrix, agreement with
   the plain backend on the card and with the plain backend on the CPU on a
   small input (:func:`check_path`);
4b. the SECAM path, encode -> interp/avg/notch decode at 16x3x576x720, the
   same way: PSNR 38.8644/33.3755/35.3157 +- 0.02 dB, one launch of each
   SECAM kernel per round trip; and interp at 16x3x576x1440 (the chip
   matrix's row: the serial kernels) against the JAX CPU value, one
   launch of each, timed in phase 5;
4c. the rest of the QAM family at full width (16 frames, 576 or 480 lines,
   720 samples): PAL/PAL-M/PAL-N/PAL-60, NIIR, NTSC-4.43 and the temporal
   and adaptive combs, each round trip's PSNR +- 0.02 dB, its launches
   (combA/comb3dA separate outside the decode kernel, as in the JAX
   package: 0 decode launches), the same two agreements;
4k. the card against the port's own oracle (``color_modem_tpu_torch/golden/``,
   NumPy float64 per line): every frame path of 4, 4b and 4c on frames 0-1
   of the 16-frame scene, encode and decode >= 60 dB (the temporal combs
   through ``golden.decode_sequence``); the RF and satellite hops and the
   sound chains (intercarrier, MTS, satellite subcarriers, A2) on two frames
   of phases 4g and 4h's 480 x 720, D2-MAC and PALplus on two frames of 576
   x 720, each within its CPU test's bound against golden; each row's dB
   and the time of 3c + 4k;
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
4i. the data services and instruments at full width, no kernel of their
   own (the QAM kernels under them): caption cells on row 0 of NTSC
   16x480x720 through the comb3 round trip, a teletext page with WSS and
   VITC on PAL 16x576x1440, scrambling in all three modes with and without
   ``active_start`` (descramble exact) and the subscriber's and pirate's
   PSNR, the VIR readout and corrected decode under a chroma phase error,
   DG/DP, the multiburst response through VHS playback and the
   pulse-and-bar K-rating, PALplus progressive and interlaced with and
   without the raster (helper and zoom PSNRs, the ``_shared`` kernels
   against the plain backend), and the full-stack 576x1440 broadcast
   (``scripts/torch_fullstack.py``) with FM + NICAM and with FM + A2; every
   bit exact, each PSNR +- 0.02 dB of the JAX CPU value, each chain's
   launches, each chain on the card against the CPU, TF32 on bit-identical,
   no host-blocking operation outside the host-side parses;
4j. the parallel layer (``color_modem_tpu_torch/parallel/``) on the one
   card: ``parallel/multihost.py`` launches 4 gloo ranks, every one
   computing on cuda:0 (NCCL refuses two ranks on one GPU), each on its own
   (frame, lineblk) block: NTSC comb3 at 16x3x480x720 on the (2,2), (4,1)
   and (1,4) meshes (PSNR 46.62 +- 0.02 dB), SECAM interp and PAL
   delayline at 16x3x576x720 on (2,2) (38.8644 and 37.9984 dB), then the
   rest of the JAX multi-chip gate's case list at 4 frames x 64 lines
   (comb3d/comb3dA's dual rings, the interlaced pipeline, MAC, PALplus, the
   RF and satellite hops, RF sound, satellite audio): each gathered on rank
   0 against the unsharded pipeline on the card (QAM bit for bit, the
   adaptive comb3dA 1e-6 on the card, whose plain separation products
   cuBLAS sums in an order that follows the product's row count, SECAM and
   MAC 1e-5, PALplus 1e-6, RF hop 2e-6, satellite hop 1e-3, RF sound 2e-5 /
   1e-5, satellite audio 1e-3 / 1e-5), each rank's launches (one encode and
   one decode of its block) and device, the main path once more under
   ``set_sync_debug_mode("error")`` outside the halo exchange's host
   staging, each rank's round-trip and halo-exchange times (4 ranks sharing
   one card: not a scaling figure); the comb3dA witness (the (2,2) and
   (4,1) blocks decoded in this process from the full composite, no rank
   involved, against the full frame, and the separation's FIR product on a
   block's rows against the full frame's, timed); then NCCL on a 1x1 mesh
   (2x2 with 4 cards), printing which ran;
5. CUDA-event times (median of 10 windows of 20 calls, with their spread)
   of each kernel and round trip against its plain version: NTSC comb3 and
   SECAM interp (and SECAM interp at 16x3x576x1440, the serial kernels),
   then 5c PAL delayline and NIIR avg (the shared-filter
   case); per kernel its bound (bytes or operations, ``kernels/measure.py``)
   and the share of it reached, and one grouped conv2d of each kernel's
   FIRs alone (TF32 off) as the library yardstick; 5e the frame layer's
   round trips, the resample matmul and NR; 5g the three hops (and each
   half), in Mpix/s of composite or picture pixels; 5h each sound chain
   whole and each half (transmit, receive); 5i the caption line, the
   teletext page, the three scramble modes, the PALplus round trip against
   the plain PAL comb3 round trip, and the full-stack chain;
6. the video runner: ``process_video`` NTSC comb3 at 480x720, 48 frames in
   chunks of 16 from the device source (PSNR +- 0.02 dB of the JAX CPU run,
   3 launches of each kernel), a resume that processes nothing, one
   synchronising CUDA operation per wave of chunks (interlaced comb3d with
   noise and NR), chunk sizes 16 and 12 agreeing to 1e-6 under channel
   noise with NR (progressive comb3 and interlaced comb3d), NR gaining >
   2.5 dB on a noisy static source, and Mpix/s on both backends; then the
   same run through the RF hop and through the satellite hop at 12 dB CNR
   (PSNR +- 0.02 dB of the JAX CPU run: the noise is JAX's) and with
   channel noise (the same), the noisy runs one ``threefry_add_normal``
   launch per chunk, and chunk sizes 16 and 12 through
   the RF hop, the satellite hop, and the satellite hop at 12 dB CNR; the
   RF hop with a soundtrack (``rf_audio``), progressive and interlaced,
   against the JAX runner's PSNR and audio SNR, one synchronising operation
   per wave with the audio in the fetch, and chunk sizes 16 and 12 equal to
   1e-4 on the audio and 1e-5 on the frames; then the runner with
   ``caption_bits``, with ``scramble=("cutrotate", key)``, with both through
   the RF hop and with both interlaced: PSNR +- 0.02 dB of the JAX CPU run,
   the caption cells exact, chunk sizes 16 and 12 alike (1e-6, 1e-5 through
   the RF hop), one synchronising operation per wave; last, the runner over
   a (2,2) mesh of 4 gloo ranks on the card (``process_video(mesh=)``, NTSC
   comb3 48x480x720 in chunks of 16): PSNR +- 0.02 dB of the unsharded run,
   the frames equal to it bit for bit, 3 launches of each kernel per rank;
   and over the mesh with captions and cutrotate through the RF hop, each
   rank transmitting its share: the unsharded run's PSNR, the cells exact;
7. the surfaces: (a) the native host codec built with g++ and equal to its
   NumPy path (576x720 u8<->f32, a 4:2:0 Y4M decode); (b) the main path
   through the CLI, ``video --standard ntsc --decoder comb3 --input
   clip.y4m --output out.y4m --chunk 16`` on a 48-frame 480x720 clip from
   ``write_y4m``: PSNR and chunk fingerprints equal to ``process_video``'s
   on the same frames, the clip equal to ``write_y4m`` of that runner's
   frames, 3 launches of rows 1-2, and warm Mpix/s with and without the
   clip beside phase 6's runner; (c) ``roundtrip --demo --pattern scene``
   at full height, NTSC comb3, PAL delayline, SECAM interp and NIIR avg,
   each PSNR +- 0.02 dB of the JAX CLI's CPU value and one launch per
   kernel, and NTSC comb3 with composite noise, RF noise, tape dropouts and
   DOC (the threefry bits kernel's path: three launches, two of the normal
   one); (d) ``encode --raw`` then ``decode`` against ``roundtrip`` and
   ``gallery``, where Pillow imports (a line says whether it did); (e) the
   per-line modems over 24 lines, 24 one-line encode launches each, against
   the batch pipeline (encode 2e-5 / 2e-4 SECAM, interior lines 5e-4), a
   one-line kernel encode against the plain encode, lines per second;
   (f) ``checked`` raising on a NaN in a composite, naming the operation
   and the port's line of a NaN made and removed inside a decode, and the
   CUDA kernel whose output holds a NaN; (g) ``cli video
   --mesh`` under ``torch.distributed.run`` over NCCL (1x1; 2x2 with four
   cards), rank 0 alone reporting, frames and clip equal to the unsharded
   verb's;
8. the benchmark: ``python -m color_modem_tpu_torch.benchmark --roofline``
   in its own process at the four flagship shapes (NTSC comb3 16x480x720;
   SECAM interp, PAL delayline, NIIR avg 16x576x720) from a temporary
   directory, and ``cli bench`` once in this process: the last line the
   four keys with a finite positive value, the record's PSNR +- 0.02 dB of
   the JAX CPU value, one launch of each path kernel per call, every
   roofline share in (0, 1.05], the CLI's PSNR equal to the module's; each
   printed beside the Mpix/s phase 5's kernel round trip implies, and the
   record's power limit (read by the card's UUID) equal to ``nvidia-smi``'s;
   (b) ``entry()``'s step once on the card (shape, finite, one launch
   each) and ``dryrun_multichip(4)`` on 4 gloo ranks on the card(s).

The line before the last is ``{"kernels": [...]}``, one entry per Pallas
kernel of the JAX package and one per entry point of the threefry
generator, which replaces ``jax.random`` (the QAM pair's ``_shared`` forms run the same
CUDA kernels with equal tile arrays, on the PAL delayline path), with the
QAM kernels' launches on phase 4i's paths beside (``launches_data_services``:
the NTSC caption round trip, the PALplus round trip) and each rank's
launches on phase 4j's (2,2) full-width round trips (``launches_sharded``),
on the CLI's video run of phase 7b (``launches_cli_video``), on phase
7e's per-line modems (``launches_line_api``) and per call of phase 8's
benchmark (``launches_bench``); the last line is ``{"ok": true, "device":
{...}}``.
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
#: phase 4b at 1440 samples: SECAM interp of
#: smooth_scene(576, 1440, seed=0) x 16 at frame 0, the JAX xla path on the
#: CPU (scripts/jax_transmission_reference.py --only secam-interp-1440)
SECAM_PSNR_1440 = 38.6482
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
#: phase 6 with channel noise 0.02: min_psnr_db of the JAX xla run on the
#: CPU (scripts/jax_transmission_reference.py video-channel-noise)
VIDEO_CHANNEL_NOISE_PSNR = 34.09  # the summary rounds to 0.01 dB
#: phase 6 through the hops and the noisy channel: min_psnr_db of the JAX
#: xla run on the CPU (scripts/jax_transmission_reference.py video-rf /
#: video-satellite / video-channel-noise), the noise JAX's
VIDEO_HOP = {"rf": ({"rf": True}, 47.28),
             "satellite": ({"satellite": True, "sat_cnr": 12.0}, 27.92),
             "channel noise": ({"channel": {"noise_sigma": 0.02}}, VIDEO_CHANNEL_NOISE_PSNR)}
#: phase 6's noise keying on the main path: the noisy runner on the card
#: (chunk 16) and on the CPU (chunk 6) over 18 frames of 32 lines, so the
#: card's second chunk keys its noise from frame 16 (field 32 interlaced)
#: and the CPU's chunks from 6 and 12.  tests/test_torch_video.py holds the
#: CPU run to the JAX runner; a noise drawn from any other key moves the
#: frames by the noise's own size (sigma 0.02, 12 dB CNR), far above each
#: bound: the decode bound, and near the FM threshold HOP_CHUNK's.  Each
#: case: (options, bound, threefry launches per card chunk: the equalizer's
#: noisy GCR record is one more)
KEYING_FRAMES, KEYING_LINES, KEYING_CPU_CHUNK = 18, 32, 6
KEYING_CASES = {
    "channel noise interlaced": ({"channel": {"noise_sigma": 0.02}, "interlaced": True},
                                 DEC_ATOL, 1),
    "equalize noise": ({"channel": {"ghost_delay_us": 3.0, "ghost_gain": 0.3,
                                    "noise_sigma": 0.02, "equalize": True}}, DEC_ATOL, 2),
    "satellite cnr 12": ({"satellite": True, "sat_cnr": 12.0}, 2e-3, 1),
}
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
def roundtrip_launches(name: str, decoder: str, n_enc: int = 1, n_dec: int = 1,
                       n_enc_matrices: int = 1) -> dict:
    """One round trip's launches: ``n_enc`` encodes and ``n_dec`` decodes of
    the standard's modem kernels (SECAM's or QAM's), the comb stencil's pass
    in front of each 'comb2' or 'comb3' decode, ``n_enc_matrices`` of the
    encoder's colour matrix, and the decoder's last step: the delay-line
    pass for an averaging decoder, else the colour matrix."""
    from color_modem_tpu_torch.frame.pipeline import AVERAGING
    from color_modem_tpu_torch.kernels.comb import FORMS

    fam = "secam" if name == "secam" else "qam"
    want = {f"{fam}_encode": n_enc, f"{fam}_decode": n_dec, "colour_matrix": n_enc_matrices}
    if decoder in FORMS:
        want["comb_stencil"] = n_dec
    if decoder in AVERAGING:
        want["delayline_matrix"] = 1
    else:
        want["colour_matrix"] += 1
    return want


#: phase 3d: values taken from ``jax.random`` on the CPU (JAX 0.9.0, its
#: default threefry2x32 in the partitionable form; the card's machine has no
#: JAX), each under the call that made it, with PRNGKey, split and fold_in
#: from ``jax.random`` too; tests/test_torch_prng.py holds them to JAX
JAX_PINNED = {
    "jax.random.bits(PRNGKey(0), (8,))":
        [4070199207, 4202968722, 1427181096, 2012915765, 2447653815, 710830403, 1332275837,
         2961296638],
    "jax.random.key_data(jax.random.split(PRNGKey(7)))":
        [[3625411723, 1954958720], [195045567, 4062205631]],
    "jax.random.key_data(jax.random.fold_in(PRNGKey(0x5A7), 3))": [690700835, 2294474183],
    "jax.random.normal(PRNGKey(0), (8,))":
        [1.622642159461975, 2.0252647399902344, -0.4335944354534149, -0.07861734926700592,
         0.17609089612960815, -0.9720892310142517, -0.49529874324798584, 0.49437859654426575],
    "jax.random.normal(fold_in(PRNGKey(0x5A7), 37), (6,))":
        [-0.9780805706977844, -0.3810826241970062, 1.5621904134750366, -1.4857182502746582,
         -0.671713650226593, -0.24853402376174927],
    "jax.random.uniform(PRNGKey(1), (4,))":
        [0.4386324882507324, 0.5337529182434082, 0.44591832160949707, 0.4383963346481323],
    "jax.random.bernoulli(split(PRNGKey(7))[0], 0.1, (1, 24))":
        [[0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
    "jax.random.randint(split(PRNGKey(7))[1], (1, 8), 0, 1649)":
        [[354, 1045, 2, 1123, 398, 1275, 1628, 587]],
}
#: the threefry kernel's normals against the plain version, the CPU and JAX:
#: the log1p of each library, an ulp or two of the draw (tests/test_torch_prng.py)
NORMAL_ATOL = 1e-6
#: phase 3d's shapes: the runner's satellite noise per chunk of 16 NTSC
#: frames (480 lines of 720 samples at r = 4: 2880 RF samples), keyed per
#: frame from index 37; rf_dropout's draws on the CLI's NTSC RF hop (1 x
#: 480 lines, 2880 RF samples, a 10 us span of 1231); the card against the
#: CPU on 2 of the 16 frames
THREEFRY_SHAPE, THREEFRY_G0 = (16, 480, 2880), 37
DROPOUT_SHAPE, DROPOUT_SPAN = (1, 480), 2880 - 1231
THREEFRY_CPU_FRAMES = 2
#: phase 3e's shapes: phase 4's batch, the NTSC batch cell's 64 frames and
#: the SECAM batch cell's 16 frames of 576 lines; the kernel's float32
#: multiply-adds against the product and two addcmul_ of the plain version
COLOUR_SHAPES = ((BATCH, 3, 480, N), (64, 3, 480, N), (BATCH, 3, 576, N))
COLOUR_ATOL = 1e-6
#: phase 3e's delay-line pass: PAL's 16 frames and the PAL batch cell's 64
#: (the kernel is bit for bit its plain composition, so no tolerance)
DELAYLINE_SHAPES = ((BATCH, 3, 576, N), (64, 3, 576, N))
#: phase 3e's comb stencil: (shape, spacing) at phase 4's batch, the NTSC batch
#: cell's 64 frames and PAL's 64 (bit for bit its plain composition)
COMB_SHAPES = (((BATCH, 480, N), 1), ((64, 480, N), 1), ((64, 576, N), 2))
#: phase 4i: the data services' stimuli (scripts/jax_transmission_reference.py
#: uses the same) and the JAX xla values on the CPU at the card's shapes
#: (its rows caption, teletext-wss-vitc, scramble, vir, measure, palplus,
#: fullstack-nicam, fullstack-a2); each PSNR held to PSNR_TOL, each SNR to
#: SNR_TOL.  Every composite comes from the comb3 pipeline of
#: smooth_scene(L, N, seed=0) x 16 at frame 0.
CAPTION_TEXT = "CLOSED CAPTIONS RIDE LINE 21 OK!"
TELETEXT_ROWS = ("HELLO WORLD", "ROW TWO")
WSS_ASPECT = "16:9 full (anamorphic)"
SCRAMBLE_KEY = 0x5EC4E7
SERVICE_PSNR = {
    "caption": 46.3650,               # NTSC 480x720, rows 1: (row 0 carries the cell)
    "teletext-wss-vitc": 41.6525,     # PAL 576x1440, rows 5: (page, WSS, VITC above)
    "scramble subscriber": 46.6200,   # NTSC 480x720 cutrotate, descrambled
    "scramble pirate": 17.8558,       # the same, decoded without the key
    "vir corrected": 44.9837,         # 25 deg / gain 0.7 channel, rows 2:
    "vir uncorrected": 27.4759,
}
#: the VIR readout under that channel: (JAX value, bound)
VIR_READOUT = {"phase_err_deg": (-24.7764, 0.01), "chroma_gain_corr": (1.42487, 1e-4)}
#: the measurement suite at NTSC 16x480x720 (JAX value, bound); the JAX tests
#: hold these to their physical expectation (tests/test_measure.py: DP and DG
#: within 30%, K > 4% under the ghost), the port is held to JAX's reading
MEASURE_VALUES = {"dg": (0.179469, 1e-4), "dp_deg": (14.99395, 0.01),
                  "k2t_pct": (5.000001, 1e-3), "pulse_bar_ratio": (0.800000, 1e-4),
                  "cl_gain": (0.831402, 1e-4), "cl_delay_ns": (-161.4674, 0.5)}
FREQ_RESPONSE = {0.5: 1.001016, 1.0: 1.002714, 2.0: 0.989163, 3.0: 0.031927,
                 3.58: 0.978424, 4.2: 0.019176}
FREQ_TOL = 1e-4
#: PALplus at PAL 16x576x720 (the scene plus helper-band detail): (helper,
#: zoom) PSNR, the same with and without the raster
PALPLUS_PSNR = {"progressive": (31.9992, 15.1147), "interlaced": (27.0514, 14.9294)}
#: the full-stack broadcast at 576x1440 (the JAX CLI's two-decimal report)
FULLSTACK = {
    "nicam": {"psnr_db": 32.07, "pirate_psnr_db": 17.99, "audio_snr_db": 64.65,
              "nicam left_snr_db": 59.65, "nicam right_snr_db": 58.79},
    "a2": {"psnr_db": 32.24, "pirate_psnr_db": 17.99, "a2 left_snr_db": 65.94,
           "a2 right_snr_db": 65.81},
}
#: the service chains on the card against the CPU (2 frames of 64 lines):
#: decoded RGB to the decode bound, every bit exactly
SERVICE_CPU_ATOL = DEC_ATOL
#: phase 6 with the data services: the JAX xla runner's min_psnr_db on the
#: device source, 48 frames in chunks of 16 (video-caption, video-scramble,
#: video-caption-scramble-rf, video-caption-scramble-interlaced), and the
#: chunk-16-vs-12 bound of each (through the RF hop, its FFTs' last bits)
VIDEO_CAPTION = ("THE RUNNER CARRIES ONE CAPTION CELL PER FRAME ON ROW 0. " * 2)[:96]
VIDEO_SERVICES = {
    "caption": ({"caption": True}, 47.15, CHUNK_ATOL),
    "scramble": ({"scramble": ("cutrotate", SCRAMBLE_KEY)}, 47.37, CHUNK_ATOL),
    "caption scramble rf": ({"caption": True, "scramble": ("cutrotate", SCRAMBLE_KEY),
                             "rf": True}, 47.06, 1e-5),
    "caption scramble interlaced": ({"caption": True, "scramble": ("cutrotate", SCRAMBLE_KEY),
                                     "interlaced": True}, 42.89, CHUNK_ATOL),
}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def _which_side_moved(label: str, what: str, where: str, first: tuple, again) -> None:
    """After a failed kernel-vs-plain comparison: run both sides once more on
    the same inputs (``again()`` gives the new (kernel, plain) pair, on the
    host) and print kernel-vs-kernel and plain-vs-plain, so that a failure
    that does not repeat still says which side moved, and where."""
    import torch

    k1, p1 = first
    k2, p2 = again()
    worst = tuple(int(i) for i in torch.unravel_index((k1 - p1).abs().argmax(), k1.shape))
    print(f"{label}: {what} on {where} failed; repeated on the same inputs: kernel run 1 vs "
          f"run 2 {_max_err(k1, k2):.3e}, plain run 1 vs run 2 {_max_err(p1, p2):.3e}, kernel "
          f"vs plain on run 2 {_max_err(k2, p2):.3e}; run 1's worst sample at {worst}: kernel "
          f"{float(k1[worst]):.9g}, plain {float(p1[worst]):.9g}")


def reset_counts() -> None:
    """Zero the launch counters of every CUDA kernel's entry points."""
    from color_modem_tpu_torch.kernels import reset_launches

    reset_launches()


def read_counts(label: str, want: dict) -> dict:
    """Synchronise, read every launch counter and require ``want`` (a
    kernel it leaves out must not have launched)."""
    import torch

    from color_modem_tpu_torch.kernels import launch_counts

    torch.cuda.synchronize()
    got = launch_counts()
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

    from color_modem_tpu_torch.dsp.colorimetry import clamp01
    from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
    from color_modem_tpu_torch.modem import secam

    dr, db = secam.pair(v, gline, pairing)
    return clamp01(colour_matrix(plan.ycc_to_rgb, torch.stack([luma, dr, db], dim=-3)))


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
    multiples of 8, lines cut into spans, 17, 63 and 65 lines (ragged last
    tiles of 16) and 7681 lines at the main path's width."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.kernels import fir as fk

    rng = np.random.default_rng(2)
    worst = 0.0
    shapes = [(t, n, 17) for t in (31, 129, 259) for n in (61, 97, 720, 722, 1440)]
    extra = [(129, 720, 63), (129, 720, 65), (129, 720, 7681)]
    for ntaps, n, lines in shapes + extra:
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
    print(f"band_fir.cuh vs np.convolve, {len(shapes) + len(extra)} shapes (taps 31/129/259, "
          f"widths 61-1440, 17, 63, 65 and 7681 lines): max|err| {worst:.3e} "
          f"(<= {BAND_FIR_ATOL})")
    return worst


def secam_schedules(plan) -> dict:
    """Which kernel each SECAM launch at the plan's width runs, as the C
    sources choose it: the pipelined one where its layout
    (``secam_*_pipe_layout``) fits a block, else the serial one."""
    import ctypes

    from color_modem_tpu_torch.kernels.build import load_library

    lib, n = load_library(), plan.n_samples
    taps = {"secam_encode": [plan.comp_lpf, plan.preemph, plan.anticloche],
            "secam_decode": [plan.bell_takeoff, plan.mix_lpf, plan.diff, plan.deemph,
                             plan.demod_lpf]}
    lead = {"secam_encode": [n], "secam_decode": [n, plan.fm_margin]}
    out = {}
    for name, size in (("secam_encode", 5), ("secam_decode", 15)):
        lay = (ctypes.c_int * size)()
        _check(getattr(lib, name + "_pipe_layout")(
            *lead[name], *(t.numel() for t in taps[name]), lay) == 0, f"{name}_pipe_layout")
        pipelined = 4 * lay[size - 1] <= 227 * 1024
        out[name] = ("the pipelined kernel (one block)" if pipelined else
                     "the serial kernel" + (" (spans where its planes do not hold the line)"
                                            if name == "secam_decode" else ""))
    return out


def check_secam_kernels(dev, frames: int, n: int) -> tuple[float, float]:
    """Both SECAM kernels against their plain versions at frames x 576 x n,
    first frame odd.  Returns (encode, decoded RGB) max abs errors."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import SECAM
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    plan = make_plan(SECAM(), n).to(dev)
    lines = SECAM_LINES
    kinds = secam_schedules(plan)
    print(f"secam {frames}x{lines}x{n}: encode runs {kinds['secam_encode']}, decode runs "
          f"{kinds['secam_decode']}")
    gline = frame_line_index(plan, 3, frames, lines, dev)
    isr = sk.isr_col(gline)
    scenes = np.stack([smooth_scene(lines, n, seed=s) for s in range(4)])
    rgb = torch.tensor(scenes[np.arange(frames) % 4], dtype=torch.float32, device=dev)
    ycc = colour_matrix(plan.rgb_to_ycc, rgb).contiguous()
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
    e_luma = _max_err(luma_k, luma_p)
    e_v = _max_err(v_k, v_p)
    comp_rand = sk.encode_lines(plan, ycc_rand, isr)
    e_v_rand = _max_err(sk.demodulate_lines(plan, comp_rand, isr)[1],
                        sk.demodulate_lines_plain(plan, comp_rand, isr)[1])
    torch.cuda.synchronize()
    print(f"kernel vs plain secam {frames}x{lines}x{n}: encode max|err| {e_enc:.3e} "
          f"(<= {SECAM_ENC_ATOL}), decode RGB max|err| {e_rgb:.3e}, luma {e_luma:.3e} "
          f"(<= {DEC_ATOL}); "
          f"raw v max|err| {e_v:.3e} on the scene, {e_v_rand:.3e} on random chroma "
          f"(reported, not bounded)")
    _check(e_enc <= SECAM_ENC_ATOL, f"secam encode kernel disagrees: {e_enc}")
    _check(e_rgb <= DEC_ATOL, f"secam decode kernel disagrees: {e_rgb}")
    _check(e_luma <= DEC_ATOL, f"secam decode kernel's luma disagrees: {e_luma}")
    return e_enc, e_rgb


def full_scene(lines: int, dev, frames: int = BATCH, n: int = N):
    """smooth_scene(lines, n, seed=0) broadcast to ``frames`` frames on ``dev``."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.utils.testimages import smooth_scene

    return torch.tensor(np.broadcast_to(smooth_scene(lines, n, seed=0), (frames, 3, lines, n)),
                        dtype=torch.float32, device=dev)


def check_path(dev, name: str, decoder: str, expected: float, want: dict, n: int = N):
    """One round trip at BATCH x 3 x L x n through the kernel backend (PSNR,
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
    rgb = full_scene(lines, dev, n=n)
    label = f"{name} {decoder} {BATCH}x3x{lines}x{n}"
    enc_k, dec_k, rt_k = make_pipeline(make_plan(cfg, n), decoder, "kernel", dev)
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
        enc_p, dec_p, rt_p = make_pipeline(make_plan(cfg, n), decoder, "plain", ref_dev)
        comp = enc_k(x, frame0)
        first = comp.cpu(), enc_p(x.to(ref_dev), frame0).cpu()
        e_enc = _max_err(*first)
        if e_enc > enc_atol:
            _which_side_moved(label, "encode", where, first, lambda: (
                enc_k(x, frame0).cpu(), enc_p(x.to(ref_dev), frame0).cpu()))
        first = dec_k(comp, frame0).cpu(), dec_p(comp.to(ref_dev), frame0).cpu()
        e_dec = _max_err(*first)
        if e_dec > DEC_ATOL:
            _which_side_moved(label, "decode", where, first, lambda: (
                dec_k(comp, frame0).cpu(), dec_p(comp.to(ref_dev), frame0).cpu()))
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


def check_jax_pinned(dev) -> float:
    """Phase 3d: the threefry generator on ``dev`` against :data:`JAX_PINNED`:
    keys, bits, uniforms, bernoulli and randint exactly, normals within
    :data:`NORMAL_ATOL`.  Returns the normals' largest error."""
    import numpy as np
    import torch

    from color_modem_tpu_torch.utils import prng

    k7 = prng.split(prng.PRNGKey(7))
    exact = {
        "jax.random.bits(PRNGKey(0), (8,))":
            prng.random_bits(prng.PRNGKey(0), (8,), dev).cpu().numpy().view(np.uint32).tolist(),
        "jax.random.key_data(jax.random.split(PRNGKey(7)))": [list(k) for k in k7],
        "jax.random.key_data(jax.random.fold_in(PRNGKey(0x5A7), 3))":
            list(prng.fold_in(prng.PRNGKey(0x5A7), 3)),
        "jax.random.uniform(PRNGKey(1), (4,))": prng.uniform(prng.PRNGKey(1), (4,), dev).tolist(),
        "jax.random.bernoulli(split(PRNGKey(7))[0], 0.1, (1, 24))":
            prng.bernoulli(k7[0], 0.1, (1, 24), dev).to(torch.int32).tolist(),
        "jax.random.randint(split(PRNGKey(7))[1], (1, 8), 0, 1649)":
            prng.randint(k7[1], (1, 8), 0, 1649, dev).tolist(),
    }
    for call, got in exact.items():
        _check(got == JAX_PINNED[call], f"3d {call} on {dev}: {got}, JAX {JAX_PINNED[call]}")
    normals = {
        "jax.random.normal(PRNGKey(0), (8,))": prng.normal(prng.PRNGKey(0), (8,), dev),
        "jax.random.normal(fold_in(PRNGKey(0x5A7), 37), (6,))":
            prng.normal(prng.fold_in(prng.PRNGKey(0x5A7), 37), (6,), dev),
    }
    err = max(float(np.abs(np.asarray(v.tolist()) - np.asarray(JAX_PINNED[k])).max())
              for k, v in normals.items())
    _check(err <= NORMAL_ATOL, f"3d normals on {dev} against JAX: {err}")
    print(f"3d against jax.random (pinned, {len(JAX_PINNED)} calls) on {dev}: keys, bits, "
          f"uniform, bernoulli, randint equal; normals max|diff| {err:.3e} (<= {NORMAL_ATOL})")
    return err


def check_threefry(dev, card: str) -> dict:
    """Phase 3d: the threefry generator's two entry points against their
    plain versions on the card, the CPU and JAX, then timed.  Returns each
    entry point's error and times."""
    import math

    import numpy as np
    import torch

    from color_modem_tpu_torch.kernels import prng as pk
    from color_modem_tpu_torch.kernels.measure import threefry_bound, time_ms
    from color_modem_tpu_torch.utils import prng

    # the bits: 2^20 words, and rf_dropout's draws, exact on the card and the CPU
    key = prng.PRNGKey(0)
    bits = pk.threefry_bits(key, (1 << 20,), dev)
    _check(torch.equal(bits, prng.random_bits_plain(key, (1 << 20,), dev)),
           "3d threefry_bits: kernel != plain")
    _check(torch.equal(bits.cpu(), prng.random_bits_plain(key, (1 << 20,), "cpu")),
           "3d threefry_bits: card != CPU")
    k_hit, k_start = prng.split(prng.PRNGKey(7))
    hit = prng.bernoulli(k_hit, 0.05, DROPOUT_SHAPE, dev).cpu()
    for device in (dev, torch.device("cpu")):
        plain_hit = prng.unit_float(prng.random_bits_plain(k_hit, DROPOUT_SHAPE, device))
        _check(torch.equal(hit, plain_hit.cpu() < float(np.float32(0.05))),
               f"3d bernoulli: kernel != plain on {device}")
    _check(torch.equal(prng.randint(k_start, DROPOUT_SHAPE, 0, DROPOUT_SPAN, dev).cpu(),
                       prng.randint(k_start, DROPOUT_SHAPE, 0, DROPOUT_SPAN, "cpu")),
           "3d randint: card != CPU")
    print(f"3d threefry_bits {1 << 20} words and rf_dropout's bernoulli / randint at "
          f"{DROPOUT_SHAPE}: equal to the plain version on the card and on the CPU")

    # the runner's noise: x + sigma * normal(fold_in(key, 37 + i)) per frame
    x = torch.tensor(np.random.default_rng(0).uniform(-1.0, 1.0, THREEFRY_SHAPE)
                     .astype(np.float32), device=dev)
    sat, sigma = prng.PRNGKey(0x5A7), 0.2

    def kernel():
        return prng.add_normal(x, sigma, sat, THREEFRY_G0)

    def plain():
        return prng.add_normal_plain(x, sigma, sat, THREEFRY_SHAPE, dev, THREEFRY_G0)

    got = kernel()
    e_add = _max_err(got, plain())
    alone = pk.threefry_add_normal(None, 1.0, sat, THREEFRY_SHAPE, dev, THREEFRY_G0)
    e_alone = _max_err(alone, prng.add_normal_plain(None, 1.0, sat, THREEFRY_SHAPE, dev,
                                                    THREEFRY_G0))
    f = THREEFRY_CPU_FRAMES
    e_cpu = _max_err(got[:f].cpu(), prng.add_normal_plain(
        x[:f].cpu(), sigma, sat, (f, *THREEFRY_SHAPE[1:]), "cpu", THREEFRY_G0))
    std = float(alone.double().std())
    print(f"3d threefry_add_normal {THREEFRY_SHAPE} keyed per item from {THREEFRY_G0}: kernel vs "
          f"plain max|diff| {e_add:.3e}, the normal alone {e_alone:.3e}, card vs CPU on {f} items "
          f"{e_cpu:.3e} (<= {NORMAL_ATOL}); the normal's std {std:.6f}")
    _check(max(e_add, e_alone, e_cpu) <= NORMAL_ATOL, "3d threefry_add_normal disagrees")
    _check(abs(std - 1.0) < 1e-3, f"3d threefry normal std {std}")
    e_jax = check_jax_pinned(dev)

    # times: each entry point at its path's shape, against its plain version
    words = math.prod(THREEFRY_SHAPE)
    times = {"threefry_add_normal": time_pair(plain, kernel),
             "threefry_bits": time_pair(
                 lambda: prng.random_bits_plain(k_hit, DROPOUT_SHAPE, dev),
                 lambda: pk.threefry_bits(k_hit, DROPOUT_SHAPE, dev))}
    bounds = {"threefry_add_normal": threefry_bound("threefry_add_normal", words, 8),
              "threefry_bits": threefry_bound("threefry_bits", math.prod(DROPOUT_SHAPE), 4)}
    randn = _stats(time_ms(lambda: torch.randn(THREEFRY_SHAPE, device=dev)))
    big = _stats(time_ms(lambda: pk.threefry_bits(key, THREEFRY_SHAPE, dev)))
    big_bound = threefry_bound("threefry_bits", words, 4)
    for name, shape in (("threefry_add_normal", THREEFRY_SHAPE),
                        ("threefry_bits", DROPOUT_SHAPE)):
        t, (b, by) = times[name], bounds[name]
        print(f"time {name} {shape} on {card}: kernel {_fmt(t['kernel'])}, plain "
              f"{_fmt(t['plain'])} (median [min, max] of 10 windows); bound {b:.4g} ms by {by}, "
              f"{b / t['kernel'][0]:.3f} of it")
    print(f"time threefry_bits {THREEFRY_SHAPE} on {card}: {_fmt(big)} (5 windows); bound "
          f"{big_bound[0]:.4f} ms by {big_bound[1]}, {big_bound[0] / big[0]:.3f} of it")
    print(f"time torch.randn {THREEFRY_SHAPE} (Philox, not the same function: a yardstick) on "
          f"{card}: {_fmt(randn)} (5 windows)")
    return {"err": {"threefry_bits": 0.0, "threefry_add_normal": max(e_add, e_alone, e_cpu)},
            "err_jax": e_jax, "times": times, "bounds": bounds, "randn": randn}


def check_colour_matrix(dev, card: str) -> dict:
    """Phase 3e: the colour matrix against its plain version on the card,
    then timed.  Returns the largest error, and each matrix's times and
    bound at each of :data:`COLOUR_SHAPES`."""
    import math

    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
    from color_modem_tpu_torch.kernels import colorimetry as ck
    from color_modem_tpu_torch.kernels.measure import colour_matrix_bound
    from color_modem_tpu_torch.modem.plan import make_plan

    def compare(mat, x, clamp) -> float:
        got, want = ck.colour_matrix(mat, x, clamp), apply_mat3(mat, x, clamp)
        nan = torch.isnan(want)
        _check(torch.equal(torch.isnan(got), nan), "3e colour_matrix: NaNs differ")
        return float((got - want).masked_fill(nan, 0.0).abs().max())

    gen = torch.Generator(device=dev).manual_seed(21)
    err, times = 0.0, {}
    for shape in COLOUR_SHAPES:
        x = torch.rand(shape, generator=gen, device=dev)
        e_shape = 0.0
        for name in sorted(ALL_STANDARDS):
            plan = make_plan(ALL_STANDARDS[name](), N).to(dev)
            for mat in (plan.rgb_to_ycc, plan.ycc_to_rgb):
                for clamp in (False, True):
                    e_shape = max(e_shape, compare(mat, x, clamp))
        # a NaN in one input sample stays a NaN in each of its three outputs
        nan_at = (0, 1, 5, 17)
        x[nan_at] = float("nan")
        mat = make_plan(ALL_STANDARDS["ntsc"](), N).to(dev).ycc_to_rgb
        for clamp in (False, True):
            e_shape = max(e_shape, compare(mat, x, clamp))
            out = ck.colour_matrix(mat, x, clamp)
            _check(bool(torch.isnan(out[0, :, 5, 17]).all()) and int(torch.isnan(out).sum()) == 3,
                   f"3e colour_matrix {shape} clamp {clamp}: the NaN was not kept")
        x[nan_at] = 0.5
        print(f"3e colour_matrix {shape}: kernel vs plain max|diff| {e_shape:.3e} (<= "
              f"{COLOUR_ATOL}) over {len(ALL_STANDARDS)} standards x 2 matrices x clamp on/off; "
              f"a NaN kept in its 3 outputs, clamped or not")
        _check(e_shape <= COLOUR_ATOL, f"3e colour_matrix {shape}: {e_shape}")
        err = max(err, e_shape)
        plan = make_plan(ALL_STANDARDS["secam" if shape[-2] == 576 else "ntsc"](), N).to(dev)
        bound = colour_matrix_bound(math.prod(shape))
        for entry, mat, clamp in (("encode", plan.rgb_to_ycc, False),
                                  ("decode", plan.ycc_to_rgb, True)):
            t = time_pair(partial(apply_mat3, mat, x, clamp),
                          partial(ck.colour_matrix, mat, x, clamp))
            times[shape, entry] = {**t, "bound": bound}
            print(f"time colour_matrix {entry} {shape} on {card}: kernel {_fmt(t['kernel'])}, "
                  f"plain {_fmt(t['plain'])} (median [min, max] of 10 windows); bound "
                  f"{bound[0]:.4g} ms by {bound[1]}, {bound[0] / t['kernel'][0]:.3f} of it")
        del x
    return {"err": err, "times": times}


def check_delayline_matrix(dev, card: str) -> dict:
    """Phase 3e, the delay-line pass: bit for bit its plain composition at
    :data:`DELAYLINE_SHAPES` on the matrix of every standard (each has an
    averaging decoder), a NaN in a chroma sample kept in its line and the next, then
    timed against the composition.  Returns the largest difference (0) and
    the times and bound at each shape."""
    import math

    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.dsp.colorimetry import delayline_mat3
    from color_modem_tpu_torch.kernels import colorimetry as ck
    from color_modem_tpu_torch.kernels.measure import colour_matrix_bound
    from color_modem_tpu_torch.modem.plan import make_plan

    def exact(mat, x) -> bool:
        got, want = ck.delayline_matrix(mat, x), delayline_mat3(mat, x)
        return torch.equal(got.view(torch.int32), want.view(torch.int32))

    gen = torch.Generator(device=dev).manual_seed(23)
    names = sorted(ALL_STANDARDS)
    times = {}
    for shape in DELAYLINE_SHAPES:
        x = torch.rand(shape, generator=gen, device=dev)
        x[:, 1:] = 1.2 * x[:, 1:] - 0.6
        mats = {n: make_plan(ALL_STANDARDS[n](), N).to(dev).ycc_to_rgb for n in names}
        same = all(exact(m, x) for m in mats.values())
        x[0, 1, 5, 17] = float("nan")
        same &= exact(mats["pal"], x)
        out = ck.delayline_matrix(mats["pal"], x)
        kept = bool(torch.isnan(out[0, :, 5:7, 17]).all()) and int(torch.isnan(out).sum()) == 6
        x[0, 1, 5, 17] = 0.5
        print(f"3e delayline_matrix {shape}: kernel vs plain composition bit for bit {same} "
              f"(max|diff| 0) over {len(names)} standards' matrices; a NaN kept in its line "
              f"and the next: {kept}")
        _check(same, f"3e delayline_matrix {shape}: not bit for bit the plain composition")
        _check(kept, f"3e delayline_matrix {shape}: the NaN was not kept")
        bound = colour_matrix_bound(math.prod(shape))
        t = time_pair(partial(delayline_mat3, mats["pal"], x),
                      partial(ck.delayline_matrix, mats["pal"], x))
        times[shape] = {**t, "bound": bound}
        print(f"time delayline_matrix {shape} on {card}: kernel {_fmt(t['kernel'])}, plain "
              f"composition {_fmt(t['plain'])} (median [min, max] of 10 windows); bound "
              f"{bound[0]:.4g} ms by {bound[1]}, {bound[0] / t['kernel'][0]:.3f} of it")
        del x, out
    return {"err": 0.0, "times": times}


def check_comb_stencil(dev, card: str) -> dict:
    """Phase 3e, the comb stencil's pass: bit for bit its plain composition
    at :data:`COMB_SHAPES`, 'comb2' and 'comb3', a NaN on one line reaching
    exactly the lines that read it, then timed against the composition.
    Returns the largest difference (0) and the times and bound of each form
    at each shape."""
    import math

    import torch

    from color_modem_tpu_torch.kernels import comb
    from color_modem_tpu_torch.kernels.measure import comb_stencil_bound
    from color_modem_tpu_torch.separate.comb import line_stencil

    gen = torch.Generator(device=dev).manual_seed(24)
    times = {}
    for shape, p in COMB_SHAPES:
        x = 1.9 * torch.rand(shape, generator=gen, device=dev) - 0.45
        bound = comb_stencil_bound(math.prod(shape))
        for decoder in comb.FORMS:
            got, want = comb.comb_stencil(x, p, decoder), line_stencil(x, p, decoder)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            x[1, 9, 17] = float("nan")
            out = comb.comb_stencil(x, p, decoder)
            readers = [9, 9 + p] + ([9 - p] if decoder == "comb3" else [])
            kept = (bool(torch.isnan(out[1, readers, 17]).all())
                    and int(torch.isnan(out).sum()) == len(readers))
            same &= torch.equal(out.view(torch.int32),
                                line_stencil(x, p, decoder).view(torch.int32))
            x[1, 9, 17] = 0.5
            print(f"3e comb_stencil {decoder} p={p} {shape}: kernel vs plain composition bit for "
                  f"bit {same} (max|diff| 0); a NaN reaches exactly lines {sorted(readers)}: "
                  f"{kept}")
            _check(same, f"3e comb_stencil {decoder} {shape}: not bit for bit the composition")
            _check(kept, f"3e comb_stencil {decoder} {shape}: the NaN reached other lines")
            t = time_pair(partial(line_stencil, x, p, decoder),
                          partial(comb.comb_stencil, x, p, decoder))
            times[shape, decoder] = {**t, "bound": bound}
            print(f"time comb_stencil {decoder} p={p} {shape} on {card}: kernel "
                  f"{_fmt(t['kernel'])}, plain composition {_fmt(t['plain'])} (median [min, max] "
                  f"of 10 windows); bound {bound[0]:.4g} ms by {bound[1]}, "
                  f"{bound[0] / t['kernel'][0]:.3f} of it")
            del got, want, out
        del x
    return {"err": 0.0, "times": times}


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
        read_counts("a burst-locked decode",
                    roundtrip_launches(plan.cfg.name, decoder, 0, n_enc_matrices=0))
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
        got = read_counts(key, roundtrip_launches(name, decoder))
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
    got = read_counts("interlaced rastered decode", {"qam_decode": 1, "colour_matrix": 1,
                                                     "comb_stencil": 1})
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
        # the encoder's matrix, the luma's own, the decoder's
        got = read_counts(key, {"secam_encode" if cfg.is_fm else "qam_encode": 1,
                                "colour_matrix": 3})
        frame_row(key, out, rgb, got, _max_err(out, rt_p(rgb, 0)))
        if name == "ntsc":
            timed[key] = (partial(rt_p, rgb, 0), partial(rt_k, rgb, 0))

    # standards conversion: one source decode (its best decoder) and one destination encode
    for src, dst in (("ntsc", "pal"), ("pal", "ntsc")):
        key = f"transcode {src}->{dst}"
        rgb = full_scene(ALL_STANDARDS[src]().active_lines, dev)
        l_dst = ALL_STANDARDS[dst]().active_lines
        comp = make_pipeline(plan(src), "notch", "kernel", dev)[0](rgb, 0)
        conv_k, conv_p = both(make_transcoder, plan(src), plan(dst))
        reset_counts()
        comp_d = conv_k(comp, 0)
        got = read_counts(key, roundtrip_launches(src, best_decoder(plan(src))))
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
    got = read_counts(key, roundtrip_launches("ntsc", "comb3"))
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


def time_path(dev, card: str, name: str, decoder: str, roundtrip: tuple, n: int = N) -> dict:
    """Phases 5/5c: the path's two kernels at its full shape (n samples)
    against their plain versions (held to the bounds here too), and its
    round trip ``(kernel, plain)``."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
    from color_modem_tpu_torch.kernels.measure import kernel_bound, time_ms
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal

    plan = make_plan(ALL_STANDARDS[name](), n).to(dev)
    lines = plan.cfg.active_lines
    rgb = full_scene(lines, dev, n=n)
    with torch.inference_mode():
        ycc = colour_matrix(plan.rgb_to_ycc, rgb).contiguous()
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
        print(f"kernel vs plain {name} {BATCH}x{lines}x{n} on the scene: encode max|err| "
              f"{e_enc:.3e} (<= {enc_atol}), decode {e_dec:.3e} (<= {DEC_ATOL})")
        _check(e_enc <= enc_atol and e_dec <= DEC_ATOL, f"{name} kernels disagree")
        library = (secam_library_calls(plan, ycc, comp, isr) if plan.cfg.is_fm
                   else qam_library_calls(plan, ycc, sep, comp, cols))
        rt_k, rt_p = roundtrip
        kernels[f"{decoder} roundtrip"] = (lambda: rt_p(rgb, 0), lambda: rt_k(rgb, 0))
        times = {key: time_pair(plain, kernel) for key, (plain, kernel) in kernels.items()}
        for kernel in [k for k in kernels if "roundtrip" not in k]:
            times[kernel]["bound"] = kernel_bound(plan, kernel, BATCH * lines)
            times[kernel]["library"] = (_stats(time_ms(library[kernel], windows=10))
                                        if kernel in library else None)
    print_times(card, f"{name} {BATCH}x{lines}x{n}", BATCH * lines * n / 1e6, times)
    for kernel in [k for k in kernels if "roundtrip" not in k]:
        t, (b, by), lib = times[kernel]["kernel"], times[kernel]["bound"], times[kernel]["library"]
        print(f"bound {kernel} {name} {BATCH}x{lines}x{n} on {card}: {_fmt(t)}, bound {b:.4f} ms "
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
    from color_modem_tpu_torch.utils import prng
    from color_modem_tpu_torch.utils.metrics import psnr

    def hold(key: str, q: float) -> None:
        print(f"4g {key}: {q:.4f} dB (expected {HOP_PSNR[key]} +- {PSNR_TOL}) on {card}")
        _check(abs(q - HOP_PSNR[key]) <= PSNR_TOL, f"4g {key}: {q} dB")

    plan = make_plan(NTSC(), N).to(dev)
    enc, _, _ = make_pipeline(plan, "notch", "kernel", dev)
    rgb = full_scene(480, dev)
    reset_counts()
    comp = enc(rgb, 0)
    read_counts("4g ntsc notch composite", {"qam_encode": 1, "colour_matrix": 1})
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
    read_counts("4g tbc", {"qam_encode": 1, "qam_decode": 3, "colour_matrix": 4,
                           "comb_stencil": 3})

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
    noisy = partial(sat_mod.sat_roundtrip, sp, comp, None, prng.PRNGKey(11), 12.0)
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
        read_counts("4h composites (NTSC notch, PAL delayline)",
                    {"qam_encode": 2, "colour_matrix": 2})
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
        got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks,
                                  "colour_matrix": 2 * chunks, "comb_stencil": chunks})
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

        # the transmission hops and the noisy channel between encode and
        # decode; each noise is one threefry launch per chunk
        for hop, (kw, expected) in VIDEO_HOP.items():
            label = f"video ntsc comb3 {hop} hop {VIDEO_FRAMES}x3x480x{N} chunk {VIDEO_CHUNK}"
            noisy = "sat_cnr" in kw or "channel" in kw
            reset_counts()
            s_hop = run(f"hop_{hop}".replace(" ", "_"), src, VIDEO_FRAMES, **kw)
            got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks,
                                      "colour_matrix": 2 * chunks, "comb_stencil": chunks,
                                      **({"threefry_add_normal": chunks} if noisy else {})})
            print(f"{label}: min_psnr_db {s_hop['min_psnr_db']} (expected {expected} +- "
                  f"{PSNR_TOL}), launches {got}, {s_hop['mpix_per_s']} Mpix/s on {card}")
            _check(abs(s_hop["min_psnr_db"] - expected) <= PSNR_TOL, f"{label}: {s_hop}")
            summaries[hop] = {**s_hop, "launches": got}
        # the noise keying: the card's noisy runs against the CPU's on the
        # same frames (one launch per card chunk), over a chunk edge
        for case, (kw, atol, draws) in KEYING_CASES.items():
            outs = {}
            for where, chunk in ((dev, VIDEO_CHUNK), (torch.device("cpu"), KEYING_CPU_CHUNK)):
                d = os.path.join(tmp, f"keying {case} {where.type}".replace(" ", "_"))
                reset_counts()
                process_video(make_plan(NTSC(), N), synthetic_device_source(
                    KEYING_LINES, N, seed=0, device=where), KEYING_FRAMES, d,
                    decoder="comb3", chunk=chunk, backend="kernel", save_outputs=True,
                    device=where, **kw)
                if where.type == "cuda":
                    n_chunks = -(-KEYING_FRAMES // VIDEO_CHUNK)
                    got = read_counts(f"keying {case}", {
                        "qam_encode": n_chunks, "qam_decode": n_chunks,
                        "colour_matrix": 2 * n_chunks, "comb_stencil": n_chunks,
                        "threefry_add_normal": draws * n_chunks})
                outs[where.type] = np.concatenate(
                    [np.load(f) for f in sorted(glob.glob(os.path.join(d, "rgb_*.npy")))])
            _check(outs["cuda"].shape == (KEYING_FRAMES, 3, KEYING_LINES, N),
                   f"keying {case}: {outs['cuda'].shape}")
            e = float(np.abs(outs["cuda"] - outs["cpu"]).max())
            print(f"video ntsc comb3 {case} {KEYING_FRAMES}x3x{KEYING_LINES}x{N}: card (chunk "
                  f"{VIDEO_CHUNK}, launches {got}) vs CPU (chunk {KEYING_CPU_CHUNK}) max|diff| "
                  f"{e:.3e} (<= {atol})")
            _check(e <= atol, f"keying {case}: the card's noisy frames differ from the CPU's: {e}")
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
            got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks,
                                      "colour_matrix": 2 * chunks, "comb_stencil": chunks})
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


def palplus_scene(lines: int, n: int):
    """``smooth_scene(lines, n, seed=0)`` plus helper-band vertical detail,
    clipped to [0, 1] (the reference script's ``palplus_scene``)."""
    import numpy as np

    from color_modem_tpu_torch.utils.testimages import smooth_scene

    vert = 0.25 * np.cos(2 * np.pi * 0.42 * np.arange(lines)[:, None])
    return np.clip(smooth_scene(lines, n, seed=0) + vert[None], 0.0, 1.0).astype(np.float32)


def service_chains(dev, frames: int = BATCH, ntsc_lines: int = 480,
                   pal_lines: int = 576) -> tuple[dict, dict]:
    """Phase 4i's chains on ``dev``: ``(chains, inputs)``, each chain ``name
    -> (call, launches)``, where ``call()`` returns a dict of output tensors
    and ``launches`` is what one call launches.  The stimuli are the
    reference script's, made on the host and copied once; every step is a
    library call of the port, in the reference rows' order."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC, PAL
    from color_modem_tpu_torch.frame import palplus, teletext, vbi, vir, vitc, wss
    from color_modem_tpu_torch.frame import scramble as scr
    from color_modem_tpu_torch.frame.channel import impair
    from color_modem_tpu_torch.frame.pipeline import decode_block, frame_line_index, make_pipeline
    from color_modem_tpu_torch.frame.raster import add_raster, make_raster
    from color_modem_tpu_torch.modem.plan import make_plan, plan_on
    from color_modem_tpu_torch.utils.testimages import smooth_scene
    from color_modem_tpu_torch.utils.upload import upload

    def scene(lines, n, img=None):
        img = smooth_scene(lines, n, seed=0) if img is None else img
        return torch.tensor(np.broadcast_to(img, (frames, 3, lines, n)), dtype=torch.float32,
                            device=dev)

    ntsc = plan_on(make_plan(NTSC(), N), dev)
    pal = plan_on(make_plan(PAL(), N), dev)
    wide = plan_on(make_plan(PAL(), 2 * N), dev)
    rgb_n, rgb_w = scene(ntsc_lines, N), scene(pal_lines, 2 * N)
    rgb_p = scene(pal_lines, N, palplus_scene(pal_lines, N))
    g_n = frame_line_index(ntsc, 0, frames, ntsc_lines, dev)
    enc_n, dec_n, _ = make_pipeline(ntsc, "comb3", "kernel", dev)
    enc_w, dec_w, _ = make_pipeline(wide, "comb3", "kernel", dev)
    cap, wst = vbi.cc_spec(ntsc), teletext.wst_spec(wide)
    n_cells = len(CAPTION_TEXT) // 2
    cells = upload(np.stack([vbi.cc_pack(CAPTION_TEXT[2 * (f % n_cells) : 2 * (f % n_cells) + 2])
                             .numpy() for f in range(frames)]), dev)
    tcs = upload(np.stack([vitc.vitc_pack(*vitc.timecode_for_frame(f)) for f in range(frames)]),
                 dev)
    word = upload(wss.wss_word(WSS_ASPECT).numpy(), dev)
    comp_n = enc_n(rgb_n, 0)
    comp_r = add_raster(ntsc, make_raster(ntsc), comp_n, g_n)
    one_each = {"qam_encode": 1, "qam_decode": 1, "colour_matrix": 2, "comb_stencil": 1}
    chains = {}

    @torch.inference_mode()
    def caption():
        comp = enc_n(rgb_n, 0)
        comp[:, 0, :] = vbi.encode_data_line(ntsc, cap, cells)
        bits, margin = vbi.decode_data_line(ntsc, cap, comp[:, 0, :])
        return {"rgb": dec_n(comp, 0), "bits": bits, "margin": margin}

    @torch.inference_mode()
    def teletext_wss_vitc():
        comp = enc_w(rgb_w, 0)
        comp[:, :3, :] = teletext.encode_page(wide, 1, 0x00, list(TELETEXT_ROWS),
                                              header="P100 PAL", device=dev)
        comp[:, 3, :] = wss.encode_wss(wide, word)
        comp[:, 4, :] = vitc.encode_vitc_line(wide, tcs)
        ttx, ttx_margin = vbi.decode_data_line(wide, wst, comp[:, :3, :])
        wss_bits, wss_margin = wss.decode_wss(wide, comp[:, 3, :])
        vitc_bits, score = vitc.decode_vitc_line(wide, comp[:, 4, :])
        return {"rgb": dec_w(comp, 0), "comp": comp, "ttx": ttx, "ttx_margin": ttx_margin,
                "wss": wss_bits, "wss_margin": wss_margin, "vitc": vitc_bits, "score": score}

    chains["caption"] = (caption, one_each)
    chains["teletext-wss-vitc"] = (teletext_wss_vitc, one_each)
    for mode in scr.MODES:
        for active, comp in ((0, comp_n), (make_raster(ntsc).n_blank, comp_r)):
            @torch.inference_mode()
            def scramble_pair(mode=mode, active=active, comp=comp):
                s = scr.scramble(ntsc, comp, g_n, mode, SCRAMBLE_KEY, active)
                return {"scrambled": s,
                        "back": scr.descramble(ntsc, s, g_n, mode, SCRAMBLE_KEY, active)}

            chains[f"scramble {mode}{' active' if active else ''}"] = (scramble_pair, {})

    @torch.inference_mode()
    def scramble_roundtrip():
        s = scr.scramble(ntsc, enc_n(rgb_n, 0), g_n, "cutrotate", SCRAMBLE_KEY)
        return {"subscriber": dec_n(scr.descramble(ntsc, s, g_n, "cutrotate", SCRAMBLE_KEY), 0),
                "pirate": dec_n(s, 0)}

    @torch.inference_mode()
    def vir_chain():
        comp = enc_n(rgb_n, 0)
        comp[:, :2, :] = vir.vir_lines(ntsc, g_n[:, :2])
        bad = impair(ntsc, comp, chroma_phase_deg=25.0, chroma_gain=0.7)
        rep = vir.measure_vir(ntsc, bad[:, :2], g_n[:, :2])
        return {"phase_err": rep["phase_err"], "chroma_gain_corr": rep["chroma_gain_corr"],
                "corrected": vir.decode_vir_corrected(ntsc, bad, g_n, 2, "comb3"),
                "uncorrected": decode_block(ntsc, bad[:, 2:], g_n[:, 2:], "comb3")}

    chains["scramble roundtrip"] = (scramble_roundtrip, {"qam_encode": 1, "qam_decode": 2,
                                                         "colour_matrix": 3, "comb_stencil": 2})
    chains["vir"] = (vir_chain, {"qam_encode": 1, "qam_decode": 2, "colour_matrix": 3,
                                 "comb_stencil": 2})
    pipes = {}
    for form in ("progressive", "interlaced"):
        mk = (palplus.make_interlaced_palplus_pipeline if form == "interlaced"
              else palplus.make_palplus_pipeline)
        for raster in (False, True):
            key = f"palplus {form}{' raster' if raster else ''}"
            pipes[key] = {b: mk(pal, "comb3", b, 1.0, raster, dev) for b in ("kernel", "plain")}

            @torch.inference_mode()
            def palplus_roundtrip(enc_dec=pipes[key]["kernel"]):
                comp = enc_dec[0](rgb_p, 0)
                return {"comp": comp, "helper": enc_dec[1](comp, 0)}

            # the helper's two matrices before the encoder's, two after the decoder's
            chains[key] = (palplus_roundtrip, {**one_each, "colour_matrix": 5})
    inputs = {"rgb_n": rgb_n, "rgb_w": rgb_w, "rgb_p": rgb_p, "cells": cells, "tcs": tcs,
              "ntsc": ntsc, "pal": pal, "wide": wide, "cap": cap, "wst": wst,
              "palplus": pipes, "comp_n": comp_n, "comp_r": comp_r, "g_n": g_n}
    return chains, inputs


def _same(a, b) -> float:
    """max |a - b|, or inf when integer outputs (bits, scores) differ at all."""
    if a.dtype.is_floating_point:
        return _max_err(a.cpu().double(), b.cpu().double())
    return 0.0 if bool((a.cpu() == b.cpu()).all()) else float("inf")


def measure_values(dev) -> dict:
    """Phase 4i's measurement suite at NTSC 16x480x720 on ``dev``: DG/DP of
    the staircase through a differential channel, the multiburst's
    per-packet gains through VHS playback and a comb3 decode, and the
    pulse-and-bar readout through a ghost."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame import measure
    from color_modem_tpu_torch.frame.channel import impair, vhs_playback
    from color_modem_tpu_torch.frame.pipeline import decode_block, encode_block, frame_line_index
    from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
    from color_modem_tpu_torch.modem.plan import make_plan, plan_on

    plan = plan_on(make_plan(NTSC(), N), dev)
    g = frame_line_index(plan, 0, BATCH, 480, dev)

    def enc(stim):
        x = torch.tensor(np.broadcast_to(stim, (BATCH,) + stim.shape), device=dev)
        return encode_block(plan, x, g, "kernel")

    with torch.inference_mode():
        dif = measure.measure_differential(plan, impair(
            plan, enc(measure.modulated_staircase(plan, 480, N)), diff_gain=0.3,
            diff_phase_deg=20.0), g)
        rgb = decode_block(plan, vhs_playback(plan, enc(measure.multiburst(plan, 480))), g,
                           "comb3")
        fr = measure.measure_frequency_response(plan, colour_matrix(plan.rgb_to_ycc, rgb)[:, 0])
        pb = measure.measure_pulse_bar(plan, impair(
            plan, enc(measure.pulse_and_bar(plan, 480)), ghost_delay_us=1.0, ghost_gain=0.25), g)
    return {"dg": dif["dg"], "dp_deg": dif["dp_deg"], "frequency_response": fr, **pb}


def check_data_services(dev, card: str) -> dict:
    """Phase 4i: the data services and instruments at full width against the
    JAX package's values, with their kernel launches; PALplus's kernels
    against the plain backend on the card; each chain on the card against
    the CPU on a small input; TF32 on bit-identical; no host-blocking
    operation in any chain (the host-side parses aside).  Returns the
    callables phase 5i times."""
    import sys

    import torch

    from color_modem_tpu_torch.frame import teletext, vbi, vitc, wss
    from color_modem_tpu_torch.utils.metrics import psnr
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    chains, inp = service_chains(dev, BATCH)
    outs, counts = {}, {}
    for name, (call, want) in chains.items():
        reset_counts()
        outs[name] = call()
        counts[name] = read_counts(f"4i {name}", want)
        if want:
            print(f"4i {name}: launches {counts[name]}")

    def hold(key, q):
        print(f"4i {key}: {q:.4f} dB (expected {SERVICE_PSNR[key]} +- {PSNR_TOL}) on {card}")
        _check(abs(q - SERVICE_PSNR[key]) <= PSNR_TOL, f"4i {key}: {q} dB")

    # captions: every cell exact and parity OK, the picture below them
    o = outs["caption"]
    hold("caption", psnr(o["rgb"][:, :, 1:], inp["rgb_n"][:, :, 1:]))
    cells = [vbi.cc_unpack(b) for b in o["bits"].cpu()]
    _check(torch.equal(o["bits"].cpu(), inp["cells"].cpu().to(torch.int32))
           and all(ok for _, ok in cells), "4i caption bits")
    print(f"4i caption: {BATCH} cells exact, parity OK ({''.join(c for c, _ in cells)!r}), "
          f"worst margin {float(o['margin'].min()):.4f}")
    # teletext, WSS and VITC on their rows
    o = outs["teletext-wss-vitc"]
    hold("teletext-wss-vitc", psnr(o["rgb"][:, :, 5:], inp["rgb_w"][:, :, 5:]))
    pkts = teletext.decode_packets(inp["wide"], o["comp"][:, :3, :].reshape(3 * BATCH, -1))
    texts = [p.text.rstrip() for p in pkts]
    _check(texts == ["P100 PAL", *TELETEXT_ROWS] * BATCH
           and all(p.address_ok and bool(p.parity_ok.all()) for p in pkts)
           and all(p.page == 0 and p.magazine == 1 and p.header_ok for p in pkts[::3]),
           f"4i teletext packets: {texts[:3]}")
    aspects = [wss.parse_wss(b)["aspect"] for b in o["wss"].cpu()]
    tcs = [vitc.vitc_unpack(b) for b in o["vitc"].cpu()]
    _check(aspects == [WSS_ASPECT] * BATCH, f"4i wss: {aspects[:2]}")
    _check(torch.equal(o["vitc"].cpu().long(), inp["tcs"].cpu().long())
           and all(t["crc_ok"] for t in tcs), "4i vitc")
    print(f"4i teletext: {len(pkts)} packets exact, address and parity OK, worst margin "
          f"{min(p.margin for p in pkts):.4f}; WSS {aspects[0]!r} x {BATCH}; VITC "
          f"{BATCH} timecodes with their CRC, sync score >= {int(o['score'].min())}")
    # scrambling: exact inverse in every mode, subscriber against pirate
    for name in chains:
        if not name.startswith("scramble ") or name == "scramble roundtrip":
            continue
        src = inp["comp_r"] if name.endswith(" active") else inp["comp_n"]
        scrambled, back = outs[name]["scrambled"], outs[name]["back"]
        _check(torch.equal(back, src) and not torch.equal(scrambled, src),
               f"4i {name}: descramble(scramble(x)) != x")
        n_blank = src.shape[-1] - N
        _check(torch.equal(scrambled[..., :n_blank], src[..., :n_blank]),
               f"4i {name}: the blanking moved")
    print("4i scramble cutrotate / linedelay / shuffle, with and without active_start: "
          "descramble(scramble(x)) == x bit for bit on the card, sync and burst in the clear")
    o = outs["scramble roundtrip"]
    hold("scramble subscriber", psnr(o["subscriber"], inp["rgb_n"]))
    hold("scramble pirate", psnr(o["pirate"], inp["rgb_n"]))
    # VIR
    o = outs["vir"]
    hold("vir corrected", psnr(o["corrected"], inp["rgb_n"][:, :, 2:]))
    hold("vir uncorrected", psnr(o["uncorrected"], inp["rgb_n"][:, :, 2:]))
    readout = {"phase_err_deg": float(torch.rad2deg(o["phase_err"]).mean()),
               "chroma_gain_corr": float(o["chroma_gain_corr"].mean())}
    for key, (want, tol) in VIR_READOUT.items():
        print(f"4i vir {key}: {readout[key]:.5f} (expected {want} +- {tol})")
        _check(abs(readout[key] - want) <= tol, f"4i vir {key}: {readout[key]}")
    # PALplus: the helper and the zoom, the kernels against the plain backend
    for name in chains:
        if not name.startswith("palplus"):
            continue
        form = name.split()[1]
        enc_k, dec_k, _ = inp["palplus"][name]["kernel"]
        enc_p, dec_p, _ = inp["palplus"][name]["plain"]
        with torch.inference_mode():
            zoom = dec_k(outs[name]["comp"], 0, use_helper=False)
            e_enc = _max_err(outs[name]["comp"], enc_p(inp["rgb_p"], 0))
            e_dec = _max_err(outs[name]["helper"], dec_p(outs[name]["comp"], 0))
        q_h, q_z = psnr(outs[name]["helper"], inp["rgb_p"]), psnr(zoom, inp["rgb_p"])
        want_h, want_z = PALPLUS_PSNR[form]
        print(f"4i {name} 16x3x576x{N}: helper {q_h:.4f} dB (expected {want_h} +- {PSNR_TOL}), "
              f"zoom {q_z:.4f} dB (expected {want_z}); kernel vs plain on the card: encode "
              f"{e_enc:.3e} (<= {ENC_ATOL}), decode {e_dec:.3e} (<= {DEC_ATOL})")
        _check(abs(q_h - want_h) <= PSNR_TOL and abs(q_z - want_z) <= PSNR_TOL,
               f"4i {name}: {q_h}, {q_z}")
        _check(e_enc <= ENC_ATOL and e_dec <= DEC_ATOL, f"4i {name}: kernel vs plain")

    # the measurement suite
    m = measure_values(dev)
    for key, (want, tol) in MEASURE_VALUES.items():
        print(f"4i measure {key}: {m[key]:.6f} (expected {want} +- {tol})")
        _check(abs(m[key] - want) <= tol, f"4i measure {key}: {m[key]}")
    for f, want in FREQ_RESPONSE.items():
        _check(abs(m["frequency_response"][f] - want) <= FREQ_TOL,
               f"4i multiburst {f} MHz: {m['frequency_response'][f]}")
    print("4i measure multiburst through VHS playback: "
          + ", ".join(f"{f} MHz {g:.5f}" for f, g in m["frequency_response"].items())
          + f" (each +- {FREQ_TOL} of JAX's)")

    # the full-stack broadcast, both sound plans
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_fullstack

    for sound, want in FULLSTACK.items():
        reset_counts()
        rep = torch_fullstack.full_stack(nicam=sound == "nicam", a2=sound == "a2", lines=576,
                                         device=dev)
        got = read_counts(f"4i full stack {sound}", {"qam_encode": 1, "qam_decode": 2,
                                                     "colour_matrix": 3, "comb_stencil": 2})
        exact = all(rep[k]["exact"] for k in ("caption", "teletext", "wss", "vitc"))
        snrs = {"audio_snr_db": rep["rf"].get("audio_snr_db")}
        for sub in ("nicam", "a2"):
            for side in ("left_snr_db", "right_snr_db"):
                snrs[f"{sub} {side}"] = rep["rf"].get(sub, {}).get(side)
        print(f"4i full stack PAL 576x1440 interlaced rastered, 4 services, cutrotate, RF + FM + "
              f"{sound}: services exact {exact}, picture {rep['psnr_db']:.4f} dB (expected "
              f"{want['psnr_db']}), pirate {rep['scramble']['pirate_psnr_db']:.4f} dB (expected "
              f"{want['pirate_psnr_db']}), sound " + ", ".join(
                  f"{k} {snrs[k]:.4f}" for k in want if k in snrs) + f"; launches {got}")
        _check(exact and rep["teletext"]["parity_ok"] and rep["caption"]["parity_ok"]
               and rep["vitc"]["crc_ok"], f"4i full stack {sound}: services {rep}")
        _check(abs(rep["psnr_db"] - want["psnr_db"]) <= PSNR_TOL
               and abs(rep["scramble"]["pirate_psnr_db"] - want["pirate_psnr_db"]) <= PSNR_TOL
               and rep["psnr_db"] - rep["scramble"]["pirate_psnr_db"] > 10.0,
               f"4i full stack {sound}: {rep['psnr_db']}, {rep['scramble']}")
        for k in want:
            if k in snrs:
                _check(abs(snrs[k] - want[k]) <= SNR_TOL, f"4i full stack {sound} {k}: {snrs[k]}")
        if sound == "nicam":
            _check(rep["rf"]["nicam"]["parity_errors"] == 0 and rep["rf"]["nicam"]["faw_ok"],
                   f"4i full stack NICAM: {rep['rf']['nicam']}")
        else:
            _check(rep["rf"]["a2"]["mode_detected"] == "stereo", f"4i full stack A2: {rep['rf']}")

    # each chain on the card against the CPU, 2 frames of 64 lines
    small = {d: service_chains(torch.device(d), 2, 64, 64)[0] for d in ("cpu", dev.type)}
    worst = 0.0
    for name in chains:
        got, want = small[dev.type][name][0](), small["cpu"][name][0]()
        e = max(_same(got[k], want[k]) for k in got)
        worst = max(worst, e)
        _check(e <= SERVICE_CPU_ATOL, f"4i {name}: card and CPU disagree: {e}")
    print(f"4i every chain on the card vs the CPU, 2x64 lines: max|diff| {worst:.3e} "
          f"(<= {SERVICE_CPU_ATOL}), bits and scores equal")

    # TF32 on for the whole process: the same outputs, bit for bit
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for name, (call, _) in chains.items():
            again = call()
            diff = max(_same(again[k], outs[name][k]) for k in again)
            _check(diff == 0.0, f"TF32 on changed 4i {name}: {diff}")
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    print(f"TF32 on: all {len(chains)} service chains bit-identical to TF32 off")

    # no host-blocking operation in any chain
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call, _ in chains.values():
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"4i no host-blocking operation in: {', '.join(chains)}")
    timed = {name: call for name, (call, _) in chains.items()}
    timed["inputs"] = inp
    # this slice's launches of the QAM kernels: the NTSC caption round trip
    # (the unshared pair and the colour matrix), the PAL PALplus round trip
    # (the _shared forms)
    timed["launches"] = {
        "qam_encode": counts["caption"]["qam_encode"],
        "qam_decode": counts["caption"]["qam_decode"],
        "colour_matrix": counts["caption"]["colour_matrix"],
        "comb_stencil": counts["caption"]["comb_stencil"],
        "qam_encode_shared": counts["palplus progressive"]["qam_encode"],
        "qam_decode_shared": counts["palplus progressive"]["qam_decode"],
    }
    rgb_fs = torch.tensor(smooth_scene(576, 2 * N), dtype=torch.float32, device=dev)

    def full_stack_chain():
        rf, sent, plans = torch_fullstack.transmit(inp["wide"], rgb_fs, nicam=True, a2=False)
        return torch_fullstack.receive(inp["wide"], rf, sent, plans, nicam=True, a2=False)

    timed["full stack"] = full_stack_chain
    return timed


def time_data_services(card: str, timed: dict) -> dict:
    """Phase 5i: CUDA-event times (median [min, max] of 10 windows of 20
    calls) of the caption line encode+decode, the teletext page, the three
    scramble modes, the PALplus round trip against the plain PAL comb3
    round trip (in turns), and the full-stack chain (10 windows of 2)."""
    import torch

    from color_modem_tpu_torch.frame import scramble as scr
    from color_modem_tpu_torch.frame import teletext, vbi
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.kernels.measure import time_ms

    inp = timed["inputs"]
    ntsc, wide, g_n, comp_n = inp["ntsc"], inp["wide"], inp["g_n"], inp["comp_n"]
    dev = comp_n.device

    @torch.inference_mode()
    def caption_line():
        return vbi.decode_data_line(ntsc, inp["cap"], vbi.encode_data_line(ntsc, inp["cap"],
                                                                           inp["cells"]))

    @torch.inference_mode()
    def teletext_page():
        page = teletext.encode_page(wide, 1, 0x00, list(TELETEXT_ROWS), header="P100 PAL",
                                    device=dev)
        return vbi.decode_data_line(wide, inp["wst"], page.expand(BATCH, *page.shape))

    fns = {f"caption line encode+decode {BATCH} cells": caption_line,
           f"teletext page encode+slice {BATCH}x3 rows": teletext_page}
    for mode in scr.MODES:
        fns[f"scramble+descramble {mode} {BATCH}x480x{N}"] = partial(
            lambda m: scr.descramble(ntsc, scr.scramble(ntsc, comp_n, g_n, m, SCRAMBLE_KEY), g_n,
                                     m, SCRAMBLE_KEY), mode)
    times = {}
    for key, fn in fns.items():
        times[key] = _stats(time_ms(fn) + time_ms(fn))
        print(f"time {key} on {card}: {_fmt(times[key])} (median [min, max] of 10 windows of "
              "20 calls)")
    pal_rt = partial(make_pipeline(inp["pal"], "comb3", "kernel", dev)[2], inp["rgb_p"], 0)
    pp = timed["palplus progressive"]
    a1, b1, b2, a2 = time_ms(pal_rt), time_ms(pp), time_ms(pp), time_ms(pal_rt)
    times["palplus"], times["pal comb3"] = _stats(b1 + b2), _stats(a1 + a2)
    mpix = BATCH * 576 * N / 1e6
    print(f"time palplus round trip {BATCH}x3x576x{N} on {card}: {_fmt(times['palplus'], mpix)}; "
          f"plain PAL comb3 round trip {_fmt(times['pal comb3'], mpix)} (in turns; median "
          "[min, max] of 10 windows of 20 calls)")
    fs = timed["full stack"]
    t = _stats(time_ms(fs, iters=2) + time_ms(fs, iters=2))
    times["full stack"] = t
    print(f"time full-stack chain PAL 576x1440 interlaced (4 services, cutrotate, RF + FM + "
          f"NICAM, receiver and parses) on {card}: {_fmt(t)} per frame (median [min, max] of "
          "10 windows of 2 calls)")
    return times


def check_video_services(dev, card: str) -> None:
    """Phase 6 with the data services: ``process_video`` NTSC comb3 at
    48x480x720 in chunks of 16 with ``caption_bits``, with
    ``scramble=("cutrotate", key)``, with both through the RF hop, and with
    both interlaced: each run's PSNR against the JAX runner's, its caption
    cells exact, its launches, one synchronising operation per wave, and
    chunk sizes 16 and 12 alike."""
    import glob
    import warnings

    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.vbi import cc_pack
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source
    from color_modem_tpu_torch.modem.plan import make_plan

    src = synthetic_device_source(480, N, seed=0, device=dev)
    plan = make_plan(NTSC(), N).to(dev)
    bits = np.stack([cc_pack(VIDEO_CAPTION[2 * i : 2 * i + 2]).numpy()
                     for i in range(VIDEO_FRAMES)])
    chunks = VIDEO_FRAMES // VIDEO_CHUNK

    with tempfile.TemporaryDirectory() as tmp:
        def run(name, n_frames, caption=False, **kw):
            kw = {"decoder": "comb3", "chunk": VIDEO_CHUNK, "backend": "kernel", **kw}
            d = os.path.join(tmp, name)
            s = process_video(plan, src, n_frames, d, device=dev,
                              caption_bits=bits[:n_frames] if caption else None, **kw)
            cells = (np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/cc_*.npy"))])
                     if caption else None)
            frames = (np.concatenate([np.load(f) for f in sorted(glob.glob(f"{d}/rgb_*.npy"))])
                      if kw.get("save_outputs") else None)
            return s, cells, frames

        for name, (kw, want, atol) in VIDEO_SERVICES.items():
            label = f"video ntsc comb3 {name} {VIDEO_FRAMES}x3x480x{N} chunk {VIDEO_CHUNK}"
            reset_counts()
            s, cells, _ = run(name.replace(" ", "_"), VIDEO_FRAMES, **kw)
            got = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks,
                                      "colour_matrix": 2 * chunks, "comb_stencil": chunks})
            exact = cells is None or np.array_equal(cells, bits)
            print(f"{label}: min_psnr_db {s['min_psnr_db']} (expected {want} +- {PSNR_TOL})"
                  + (f", {len(cells)} caption cells exact" if cells is not None else "")
                  + f", launches {got}, {s['mpix_per_s']} Mpix/s on {card}")
            _check(abs(s["min_psnr_db"] - want) <= PSNR_TOL and exact, f"{label}: {s}")
            outs = {}
            for chunk in (16, 12):
                _, c_cells, outs[chunk] = run(f"{name} {chunk}".replace(" ", "_"), INDEP_FRAMES,
                                              chunk=chunk, save_outputs=True, **kw)
                _check(c_cells is None or np.array_equal(c_cells, bits[:INDEP_FRAMES]),
                       f"{label}: chunk {chunk} caption cells")
            e = float(np.abs(outs[16] - outs[12]).max())
            # the same run again, its tables on the card: one blocking
            # operation per wave, the stacked fetch with the caption cells
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run(f"{name} sync".replace(" ", "_"), VIDEO_FRAMES, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = [str(c.message) for c in caught if "synchronizing CUDA" in str(c.message)]
            print(f"video {name}, {INDEP_FRAMES} frames: chunk 16 vs 12 max|diff| {e:.3e} "
                  f"(<= {atol}); {VIDEO_FRAMES} frames in one wave: {len(syncs)} "
                  "synchronising CUDA operation(s) (1 expected: the wave's fetch)")
            _check(e <= atol, f"video {name}: chunk-size dependent output: {e}")
            _check(len(syncs) == 1, f"video {name} syncs: {syncs}")


#: phase 4j: the full-width sharded cases, (standard, decoder, lines) ->
#: the round-trip PSNR of phase 4 / 4b / 4c on the same input
SHARDED_FULL = {("ntsc", "comb3", 480): PSNR_EXPECTED,
                ("secam", "interp", SECAM_LINES): SECAM_PSNR["interp"],
                ("pal", "delayline", 576): QAM_FAMILY["pal", "delayline"][0]}
SHARDED_MESHES = [(2, 2), (4, 1), (1, 4)]
SHARDED_RANKS = 4


def _sharded_launches(case: dict) -> dict:
    """Each rank's launches for one sharded round trip of ``case``: one
    encode and one decode of its block (none for MAC, whose modem has no
    kernel; no decode for comb3dA, whose adaptive separation runs outside
    the decode kernel, as unsharded), and the two colour matrices (five
    with PALplus's helper; the encoder's and the delay-line pass for a
    delay-line decoder; the comb stencil's pass before a 'comb2' or 'comb3'
    decode)."""
    colour = {"colour_matrix": 5 if case["kind"] == "palplus" else 2}
    if case["kind"] == "mac":
        return colour
    if case["kind"] == "palplus":
        return {**roundtrip_launches(case["standard"], case["decoder"]), **colour}
    return roundtrip_launches(case["standard"], case["decoder"], 1,
                              0 if case["decoder"] == "comb3dA" else 1)


def sharded_cases() -> list:
    """Phase 4j's case list: NTSC comb3 at full width on the (2,2), (4,1)
    and (1,4) meshes (timed and under the sync check on (2,2)), SECAM interp
    and PAL delayline at full width on (2,2), then the rest of the JAX
    multi-chip gate's case list at 4 frames x 64 lines."""
    from color_modem_tpu_torch.parallel import multihost as mh

    cases = []
    for (std, decoder, lines), _ in SHARDED_FULL.items():
        for ms in SHARDED_MESHES if std == "ntsc" else SHARDED_MESHES[:1]:
            cases.append(mh._case("pipeline", std, decoder, ms, BATCH, lines, seed=0,
                                  broadcast=True, frame0=0,
                                  time=10 if ms == (2, 2) else 0,
                                  sync_debug=std == "ntsc" and ms == (2, 2)))
    full = {(s, d) for s, d, _ in SHARDED_FULL}
    return cases + [c for c in mh.dryrun_cases(SHARDED_RANKS, 2, 2)
                    if c["kind"] != "pipeline" or (c["standard"], c["decoder"]) not in full]


def check_sharded_records(cases: list, recs: list, devices: list, card: str,
                          how: str) -> dict:
    """Hold the ranks' records of :func:`sharded_cases` (``recs[r][k]``):
    each rank on its device (``devices[r]``), its launches, rank 0's
    comparison with the unsharded pipeline and the full-width PSNRs; print
    each rank's times (``how``: how the ranks share the cards).  Returns
    each kernel's launches per rank on the (2,2) full-width cases."""
    full = {(c["standard"], c["decoder"], c["lines"]) for c in cases if c["frames"] == BATCH}
    _check(full == set(SHARDED_FULL), f"full-width cases {full}")
    launches_sharded = {}
    for k, case in enumerate(cases):
        r0 = recs[0][k]
        label = f"sharded {case['name']} {case['frames']}x3x{case['lines']}x{N}"
        got_devices = [rr[k]["device"] for rr in recs]
        counts = [rr[k]["launches"] for rr in recs]
        want = _sharded_launches(case)
        full_want = [{name: want.get(name, 0) for name in c} for c in counts]
        _check(got_devices == devices, f"{label}: rank devices {got_devices}")
        _check(counts == full_want, f"{label}: launches per rank {counts}, expected {want}")
        _check(r0["finite"], f"{label}: non-finite output")
        bound = r0["bound"]
        video_bound, audio_bound = bound if isinstance(bound, list) else (bound, None)
        errs = r0["err"]
        ok = all(v <= (audio_bound if key == "aud" else video_bound) for key, v in errs.items())
        line = (f"{label}: max|err| against unsharded on the card "
                + ", ".join(f"{key} {v:.3e}" for key, v in errs.items())
                + f" (<= {bound}), psnr {r0['psnr']:.4f} dB, launches per rank "
                f"{[{n: v for n, v in c.items() if v} for c in counts]}")
        if case["frames"] == BATCH:
            expected = SHARDED_FULL[case["standard"], case["decoder"], case["lines"]]
            line += f" (expected {expected} +- {PSNR_TOL})"
            _check(abs(r0["psnr"] - expected) <= PSNR_TOL, f"{label}: psnr {r0['psnr']}")
        print(line)
        _check(ok, f"{label}: sharded disagrees with unsharded: {errs}")
        if case.get("sync_debug"):
            _check(all(rr[k].get("sync_debug") for rr in recs), f"{label}: sync debug")
            print(f"{label}: every rank's round trip again under set_sync_debug_mode('error'):"
                  " no host-blocking operation outside the halo exchange's host staging")
        if case.get("time"):
            for rr in recs:
                ms, hm = rr[k]["ms"], rr[k]["halo_ms"]
                print(f"time {label} rank {rr[k]['rank']}: round trip "
                      f"{_fmt(_stats(ms))}, halo exchange alone {_fmt(_stats(hm))} "
                      f"(median [min, max] of {len(ms)} calls; {how}) on {card}")
        if case["frames"] == BATCH and tuple(case["mesh"]) == (2, 2):
            if case["standard"] == "pal":
                launches_sharded["qam_encode_shared"] = [c["qam_encode"] for c in counts]
                launches_sharded["qam_decode_shared"] = [c["qam_decode"] for c in counts]
            else:
                for name in want:
                    launches_sharded[name] = [c[name] for c in counts]
    return launches_sharded


class _MeshPosition:
    """A (frame, lineblk) position of a mesh without a process group: the
    mesh-position arithmetic of ``parallel/sharded.py`` in one process."""

    def __init__(self, pos: tuple, shape: tuple, device):
        self.pos, self.shape, self.device = pos, shape, device

    def index(self, axis: str) -> int:
        return self.pos[axis == "lineblk"]

    def size(self, axis: str) -> int:
        return self.shape[axis == "lineblk"]


def adaptive_witness(dev, card: str, sharded_err: dict) -> None:
    """Where comb3dA's sharded difference on the card comes from, with no
    rank and no exchange: phase 4j's comb3dA input (8 frames x 64 lines,
    frame 3 first) encoded once; each rank's halo-extended block of the
    (2,2) and (4,1) meshes cut from that composite by the mesh-position
    arithmetic (what the halo exchange delivers) and decoded in this
    process, against the full-frame decode.  Beside it, the separation's
    first plain FIR product (``fir_same``) on a block's rows and on the
    full frame's, compared on the same lines and timed.  ``sharded_err``:
    mesh -> the 4-rank run's difference.  Fails past
    ``ADAPTIVE_CUDA_BOUND``."""
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.dsp.apply import fir_same
    from color_modem_tpu_torch.dsp.nco import frame_indices
    from color_modem_tpu_torch.frame.pipeline import decode_block, encode_block
    from color_modem_tpu_torch.kernels.measure import time_ms
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.parallel import multihost as mh
    from color_modem_tpu_torch.parallel.sharded import (
        _block_rows,
        _ext_frame_offsets,
        _gline,
        required_halo,
    )
    from color_modem_tpu_torch.standards.decoders import temporal_comb_spacing

    plan = make_plan(NTSC(), N).to(dev)
    frames, lines, frame0 = 8, 64, 3
    pt, h = temporal_comb_spacing(plan.cfg), required_halo(plan, "comb3dA")
    bpf, bound = plan.chroma_bpf_mat, mh.ADAPTIVE_CUDA_BOUND
    with torch.inference_mode():
        x = torch.tensor(mh.fixture(frames, lines), device=dev)
        g = _gline(plan, frame_indices(frame0, frames, dev),
                   torch.arange(lines, dtype=torch.int32, device=dev))
        comp = encode_block(plan, x, g, "kernel")
        full = decode_block(plan, comp, g, "comb3dA", "kernel")
        t_full = _stats(time_ms(lambda: fir_same(comp, bpf)))
        for shape in ((2, 2), (4, 1)):
            b, l = frames // shape[0], lines // shape[1]
            hl = h if shape[1] > 1 else 0
            e_dec = e_mm = 0.0
            for fi in range(shape[0]):
                for li in range(shape[1]):
                    pos = _MeshPosition((fi, li), shape, dev)
                    f = _ext_frame_offsets(pos, b, pt)
                    rows = _block_rows(pos, l, hl)
                    cext = comp[f.long()][:, rows.long()]
                    gext = _gline(plan, frame_indices(frame0, 1, dev) + f, rows)
                    blk = decode_block(plan, cext, gext, "comb3dA", "kernel")[pt : pt + b]
                    own = (slice(fi * b, (fi + 1) * b), slice(li * l, (li + 1) * l))
                    e_dec = max(e_dec, _max_err(blk[..., hl : hl + l, :],
                                                full[own[0], :, own[1]]))
                    e_mm = max(e_mm, _max_err(fir_same(cext, bpf)[pt : pt + b, hl : hl + l],
                                              fir_same(comp, bpf)[own]))
            t_blk = _stats(time_ms(lambda: fir_same(cext, bpf)))
            print(f"comb3dA witness {shape[0]}x{shape[1]}, one process, no exchange: each "
                  f"rank's block decoded from the full composite against the full-frame "
                  f"decode max|err| {e_dec:.3e} (the sharded run on 4 ranks read "
                  f"{sharded_err[shape]:.3e}; <= {bound}); the separation's FIR product "
                  f"fir_same on a block's {cext.shape[0]}x{cext.shape[1]} lines against the "
                  f"full frame's {frames}x{lines}, on the same lines, {e_mm:.3e}; its time "
                  f"{_fmt(t_blk)} on the block, {_fmt(t_full)} on the full frame (median "
                  f"[min, max] of 5 windows) on {card}")
            _check(e_dec <= bound, f"comb3dA witness {shape}: {e_dec} > {bound}")


def check_sharded(dev, card: str) -> dict:
    """Phase 4j: the parallel layer on one card.  4 gloo ranks, every one
    computing on cuda:0 (NCCL refuses two ranks on one GPU), each holding its
    own (frame, lineblk) block, run :func:`sharded_cases`; rank 0 holds each
    gathered result against the unsharded pipeline on the card (QAM bit for
    bit, the other bounds of the JAX gate), each rank's launches and device
    are checked, and the main path runs once more with every host-blocking
    CUDA operation an error outside the halo exchange's host staging.  Then
    NCCL on a 1x1 mesh (and on 2x2 with 4 cards).  Returns each kernel's
    launches per rank on the (2,2) full-width cases."""
    import torch

    from color_modem_tpu_torch.parallel import multihost as mh

    cases = sharded_cases()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        recs = mh.launch(cases, SHARDED_RANKS, backend="gloo", outdir=out, timeout=600.0)
    wall = time.perf_counter() - t0
    n_cards = torch.cuda.device_count()
    devices = [f"cuda:{r % n_cards}" for r in range(SHARDED_RANKS)]
    how = f"{SHARDED_RANKS} gloo ranks on {n_cards} card(s): not a scaling figure"
    launches_sharded = check_sharded_records(cases, recs, devices, card, how)
    print(f"phase 4j: {len(cases)} sharded cases on {SHARDED_RANKS} gloo ranks on "
          f"{sorted(set(devices))} in {wall:.1f} s")
    adaptive_witness(dev, card, {tuple(c["mesh"]): recs[0][k]["err"]["rt"]
                                 for k, c in enumerate(cases)
                                 if c["kind"] == "pipeline" and c["decoder"] == "comb3dA"})

    # NCCL: one rank per card; on one card only a group of one
    for n_ranks, ms in ((1, (1, 1)), (4, (2, 2))):
        if n_cards < n_ranks:
            print(f"nccl {ms[0]}x{ms[1]}: not run ({n_cards} card(s); NCCL needs one card "
                  "per rank)")
            continue
        case = mh._case("pipeline", "ntsc", "comb3", ms, BATCH, 480, seed=0, broadcast=True,
                        frame0=0)
        with tempfile.TemporaryDirectory() as out:
            rr = mh.launch([case], n_ranks, backend="nccl", outdir=out, timeout=300.0)
        r0 = rr[0][0]
        _check(r0["err"]["rt"] == 0.0 and abs(r0["psnr"] - PSNR_EXPECTED) <= PSNR_TOL,
               f"nccl {ms}: {r0}")
        print(f"nccl {ms[0]}x{ms[1]} ran on {[r[0]['device'] for r in rr]}: NTSC comb3 "
              f"{BATCH}x3x480x{N} psnr {r0['psnr']:.4f} dB, bit-identical to unsharded, "
              f"launches per rank {[r[0]['launches'] for r in rr]}")
    return launches_sharded


def mesh_services_cases() -> tuple:
    """The mesh runner's cases with captions and cutrotate scrambling
    through the RF hop (NTSC comb3 48x480x720 in chunks of 16 on a (2,2)
    mesh, without saving): a first run that warms the ranks' collectives
    and plans, and the run that is read; its caption bits and its
    unsharded PSNR."""
    import numpy as np

    from color_modem_tpu_torch.frame.vbi import cc_pack

    bits = np.stack([cc_pack(VIDEO_CAPTION[2 * i : 2 * i + 2]).numpy()
                     for i in range(VIDEO_FRAMES)])
    kw, want, _ = VIDEO_SERVICES["caption scramble rf"]
    case = {"name": "video-mesh-services", "kind": "video", "mesh": [2, 2],
            "standard": "ntsc", "out": "services", "source": "device", "backend": "kernel",
            "save": False,
            "opts": {"decoder": "comb3", "chunk": VIDEO_CHUNK, "n_frames": VIDEO_FRAMES,
                     "lines": 480, "rf": True, "scramble": list(kw["scramble"]),
                     "caption_bits": bits.tolist()}}
    return [dict(case, name="video-mesh-services-warm", out="services-warm"), case], bits, want


def check_video_mesh(dev, card: str, unsharded: dict) -> None:
    """Phase 6 over a mesh: ``process_video(mesh=(2,2))`` NTSC comb3 at
    48x480x720 in chunks of 16 from the device source, on 4 gloo ranks on
    the card, against the same run unsharded: PSNR +- 0.02 dB of phase 6's
    (``unsharded``: its summaries), the saved frames bit-identical (the QAM
    bound), each rank's launches (one encode and one decode of its block
    per chunk), only rank 0 with a summary; then the same run without
    saving, whose Mpix/s is printed beside phase 6's unsharded runs; and
    the mesh run with captions and cutrotate scrambling through the RF hop
    (each rank transmitting its share of every chunk), without saving, its
    second run read: the PSNR of its unsharded phase 6 run
    (``VIDEO_SERVICES``) and the caption cells exact."""
    import glob

    import numpy as np

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source
    from color_modem_tpu_torch.kernels import launch_counts
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.parallel import multihost as mh

    opts = {"decoder": "comb3", "chunk": VIDEO_CHUNK}
    label = f"video mesh 2x2 ntsc comb3 {VIDEO_FRAMES}x3x480x{N} chunk {VIDEO_CHUNK}"
    case = {"name": "video-mesh", "kind": "video", "mesh": [2, 2], "standard": "ntsc",
            "out": "mesh", "source": "device", "backend": "kernel",
            "opts": dict(opts, n_frames=VIDEO_FRAMES, lines=480)}
    rate_case = dict(case, name="video-mesh-rate", out="rate", save=False)
    svc_cases, bits, svc_psnr = mesh_services_cases()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        recs = mh.launch([case, rate_case, *svc_cases], SHARDED_RANKS, backend="gloo",
                         outdir=tmp, timeout=600.0)
        wall = time.perf_counter() - t0
        cells = np.concatenate([np.load(f) for f in sorted(
            glob.glob(os.path.join(tmp, "services", "cc_*.npy")))])
        process_video(make_plan(NTSC(), N), synthetic_device_source(480, N, seed=0, device=dev),
                      VIDEO_FRAMES, os.path.join(tmp, "one"), device=dev, save_outputs=True,
                      **opts)

        def frames(d):
            return np.concatenate([np.load(f) for f in sorted(
                glob.glob(os.path.join(tmp, d, "rgb_*.npy")))])

        got, want = frames("mesh"), frames("one")
    s, rate = recs[0][0]["summary"], recs[0][1]["summary"]
    unsharded_psnr = unsharded["kernel"]["min_psnr_db"]
    chunks = VIDEO_FRAMES // VIDEO_CHUNK
    counts = [rr[0]["launches"] for rr in recs]
    e = float(np.abs(got - want).max())
    print(f"{label}: min_psnr_db {s['min_psnr_db']} (phase 6 unsharded {unsharded_psnr} +- "
          f"{PSNR_TOL}), frames max|diff| against the unsharded run {e:.3e} (== 0), "
          f"launches per rank {counts}, launch of both runs {wall:.1f} s")
    print(f"{label}: {rate['mpix_per_s']} Mpix/s without saving ({s['mpix_per_s']} saving the "
          f"frames) on {SHARDED_RANKS} ranks sharing one card through gloo (not a scaling "
          f"figure), against {_fmt_rate(unsharded['rates']['kernel'])} Mpix/s unsharded "
          f"(phase 6), on {card}")
    _check(got.shape == (VIDEO_FRAMES, 3, 480, N), f"{label}: {got.shape}")
    _check(abs(s["min_psnr_db"] - unsharded_psnr) <= PSNR_TOL, f"{label}: {s}")
    _check(rate["min_psnr_db"] == s["min_psnr_db"], f"{label}: {rate}")
    _check(e == 0.0, f"{label}: frames differ from the unsharded run by {e}")
    _check(s["mesh"] == {"frame": 2, "lineblk": 2}, f"{label}: {s}")
    _check(all(rr[0]["summary"] is None for rr in recs[1:]), f"{label}: ranks 1-3 reported")
    want = {"qam_encode": chunks, "qam_decode": chunks, "colour_matrix": 2 * chunks,
            "comb_stencil": chunks}
    want = {k: want.get(k, 0) for k in launch_counts()}
    _check(all(c == want for c in counts),
           f"{label}: launches {counts}")
    svc = recs[0][3]["summary"]
    svc_counts = [rr[3]["launches"] for rr in recs]
    label = f"video mesh 2x2 ntsc comb3 caption scramble rf {VIDEO_FRAMES}x3x480x{N}"
    print(f"{label}: min_psnr_db {svc['min_psnr_db']} (unsharded {svc_psnr} +- {PSNR_TOL}), "
          f"{len(cells)} caption cells exact: {np.array_equal(cells, bits)}, launches per "
          f"rank {svc_counts}, {svc['mpix_per_s']} Mpix/s without saving on "
          f"{SHARDED_RANKS} ranks sharing one card through gloo (not a scaling figure), "
          f"on {card}")
    _check(abs(svc["min_psnr_db"] - svc_psnr) <= PSNR_TOL, f"{label}: {svc}")
    _check(np.array_equal(cells, bits), f"{label}: caption cells")
    _check(all(c == want for c in svc_counts),
           f"{label}: launches {svc_counts}")


# --- phase 7: the surfaces (native codec, Y4M, CLI verbs, per-line API) -------------------

#: phase 7c: the CLI's flagship round trips at full height on the scene
#: pattern, as the JAX CLI prints them on the CPU (two decimals):
#:   JAX_PLATFORMS=cpu python -m color_modem_tpu.cli roundtrip --demo \
#:       --pattern scene --standard S --decoder D
#: with the kernels each launches once
CLI_ROUNDTRIP = {
    ("ntsc", "comb3"): (46.62, roundtrip_launches("ntsc", "comb3")),
    ("pal", "delayline"): (38.0, roundtrip_launches("pal", "delayline")),
    ("secam", "interp"): (38.87, roundtrip_launches("secam", "interp")),
    ("niir", "avg"): (33.18, roundtrip_launches("niir", "avg")),
}
#: phase 7c's noisy round trip (scripts/jax_transmission_reference.py
#: cli-noisy-rf): NTSC comb3 with composite noise (PRNGKey(0)), RF noise
#: (PRNGKey(2)) and tape dropouts (PRNGKey(7): one bernoulli, two randint
#: halves) repaired by DOC, the JAX CLI's PSNR and the launches
CLI_NOISY_ARGS = ("--noise", "0.02", "--rf", "--rf-noise", "0.01", "--rf-dropouts", "0.05",
                  "--rf-doc")
CLI_NOISY = (31.1, {**roundtrip_launches("ntsc", "comb3"), "threefry_bits": 3,
                   "threefry_add_normal": 2})
#: phase 7d: the rows of ``cli gallery`` at its defaults
GALLERY_ROWS = 58
LINE_API_LINES = 24
#: phase 7e: (standard, batch decoder, modem, first interior line, entry of
#: the kernels line its encode launches); the streaming seam covers the
#: first lines (and the last for comb3), as tests/test_torch_compat.py says
LINE_API_CASES = (
    ("ntsc", "notch", "NtscModem", 0, "qam_encode"),
    ("ntsc", "comb2", "SimpleCombModem", 1, "qam_encode"),
    ("ntsc", "comb3", "Simple3DCombModem", 1, "qam_encode"),
    ("pal", "notch", "PalModem", 0, "qam_encode_shared"),
    ("pal", "delayline", "DelayLinePalModem", 1, "qam_encode_shared"),
    ("secam", "notch", "SecamModem", 1, "secam_encode"),
    ("niir", "notch", "NiirModem", 1, "qam_encode_shared"),
)


def run_cli(argv: list[str]) -> dict:
    """The port's CLI in this process: the JSON report it prints last."""
    import contextlib
    import io

    from color_modem_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    _check(rc == 0, f"cli {' '.join(argv)}: exit code {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def check_native() -> None:
    """Phase 7a: the host codec built with g++, equal to its NumPy path on a
    576x720 frame and on a 4:2:0 Y4M decode."""
    import numpy as np

    from color_modem_tpu_torch import native

    _check(native.available(), "native codec: g++ build failed or missing")
    rng = np.random.default_rng(7)
    rgb8 = rng.integers(0, 256, (1, SECAM_LINES, N, 3), dtype=np.uint8)
    count, h, w = 4, SECAM_LINES, N
    marker = b"FRAME\n"
    plane = h * w + 2 * (h // 2) * (w // 2)
    raw = b"".join(marker + rng.integers(0, 256, plane, dtype=np.uint8).tobytes()
                   for _ in range(count))
    y4m_args = (raw, count, len(marker) + plane, len(marker), h, w, h // 2, w // 2, 2, 2)

    def codec():
        t0 = time.perf_counter()
        rgb = native.y4m_to_rgb(*y4m_args)
        ms = (time.perf_counter() - t0) * 1e3
        f = native.rgb8_to_chw_f32(rgb8)
        return (f, native.chw_f32_to_rgb8(f * 1.1 - 0.05), rgb), ms

    fast, ms_native = codec()
    saved = native._LIB, native._LIB_TRIED
    native._LIB, native._LIB_TRIED = None, True  # the NumPy path
    try:
        slow, ms_numpy = codec()
    finally:
        native._LIB, native._LIB_TRIED = saved
    for name, a, b in zip(("u8->f32", "f32->u8", "y4m 4:2:0"), fast, slow):
        _check(a.shape == b.shape and np.array_equal(a, b),
               f"native codec {name} differs from its NumPy path")
    print(f"native codec: built, equal to its NumPy path on 1x{h}x{w} (u8<->f32) and a "
          f"{count}x{h}x{w} 4:2:0 Y4M decode (native {ms_native:.1f} ms, NumPy "
          f"{ms_numpy:.1f} ms, host clock)")


def check_cli_video(dev, card: str, video: dict) -> dict:
    """Phase 7b, the main path through the CLI: ``video --standard ntsc
    --decoder comb3 --input clip.y4m --output out.y4m --chunk 16`` on a
    48-frame 480x720 clip that ``write_y4m`` made.  Its PSNR and
    fingerprints against ``process_video`` on the same decoded frames, its
    clip against ``write_y4m`` of that runner's saved frames, 3 launches of
    rows 1-2; then warm Mpix/s with and without writing the clip, beside
    phase 6's runner on synthetic device frames."""
    import glob

    import numpy as np

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.video import process_video, synthetic_source
    from color_modem_tpu_torch.frame.y4m import write_y4m, y4m_source
    from color_modem_tpu_torch.modem.plan import make_plan

    chunks = VIDEO_FRAMES // VIDEO_CHUNK
    label = f"cli video ntsc comb3 {VIDEO_FRAMES}x3x480x{N} .y4m chunk {VIDEO_CHUNK}"
    with tempfile.TemporaryDirectory() as tmp:
        clip, out_clip = os.path.join(tmp, "clip.y4m"), os.path.join(tmp, "out.y4m")
        src = synthetic_source(480, N)
        t0 = time.perf_counter()
        write_y4m(clip, (src(s, VIDEO_CHUNK) for s in range(0, VIDEO_FRAMES, VIDEO_CHUNK)))
        t_write = time.perf_counter() - t0
        argv = ["video", "--standard", "ntsc", "--decoder", "comb3", "--input", clip,
                "--chunk", str(VIDEO_CHUNK)]
        reset_counts()
        rep = run_cli(argv + ["--out", os.path.join(tmp, "cli"), "--output", out_clip])
        launches = read_counts(label, {"qam_encode": chunks, "qam_decode": chunks,
                                       "colour_matrix": 2 * chunks, "comb_stencil": chunks})
        source, n, h, w = y4m_source(clip)
        s = process_video(make_plan(NTSC(), N), source, n, os.path.join(tmp, "runner"),
                          decoder="comb3", chunk=VIDEO_CHUNK, device=dev, save_outputs=True)
        ref_clip = os.path.join(tmp, "ref.y4m")
        write_y4m(ref_clip, (np.load(f) for f in sorted(
            glob.glob(os.path.join(tmp, "runner", "rgb_*.npy")))))

        def chunks_of(d):
            with open(os.path.join(tmp, d, "manifest.json")) as f:
                return json.load(f)["chunks"]

        same_fp = chunks_of("cli") == chunks_of("runner")
        with open(out_clip, "rb") as f, open(ref_clip, "rb") as g:
            same_clip = f.read() == g.read()
        print(f"{label}: min_psnr_db {rep['min_psnr_db']} (process_video on the same frames "
              f"{s['min_psnr_db']}), chunk fingerprints equal: {same_fp}, clip equal to "
              f"write_y4m of the runner's frames: {same_clip}, launches {launches}, backend "
              f"{rep['backend']} on {dev}; writing the clip took {t_write:.2f} s")
        _check((n, h, w) == (VIDEO_FRAMES, 480, N), f"{label}: clip {n}x{h}x{w}")
        _check(rep["frames_processed_this_run"] == VIDEO_FRAMES
               and rep["output_frames"] == VIDEO_FRAMES, f"{label}: {rep}")
        _check(rep["min_psnr_db"] == s["min_psnr_db"], f"{label}: {rep} vs {s}")
        _check(same_fp, f"{label}: chunk fingerprints differ from process_video's")
        _check(same_clip, f"{label}: the clip differs from write_y4m of the runner's frames")
        rates = {"clip": [], "read only": []}
        for i in range(3):
            for key, extra in (("clip", ["--output", out_clip]), ("read only", [])):
                r = run_cli(argv + ["--out", os.path.join(tmp, f"warm{i}{len(extra)}"),
                                    "--no-resume", *extra])
                rates[key].append(r["mpix_per_s"])
    print(f"{label}: warm {_fmt_rate(rates['clip'])} Mpix/s writing the clip, "
          f"{_fmt_rate(rates['read only'])} reading only (median [min, max] of 3 runs; first "
          f"run {rep['mpix_per_s']}), against the runner's {_fmt_rate(video['rates']['kernel'])} "
          f"on synthetic device frames (phase 6), host clock, on {card}")
    return {k: launches[k] for k in ("qam_encode", "qam_decode", "colour_matrix",
                                     "comb_stencil")}


def check_cli_roundtrips(card: str) -> dict:
    """Phase 7c: ``cli roundtrip --demo --pattern scene`` at full height,
    each flagship decoder, and NTSC comb3 with the noisy RF hop
    (:data:`CLI_NOISY`), against the JAX CLI's CPU value.  Returns the
    noisy run's launches."""
    runs = {(std, dec, ()): v for (std, dec), v in CLI_ROUNDTRIP.items()}
    runs["ntsc", "comb3", CLI_NOISY_ARGS] = CLI_NOISY
    for (std, dec, extra), (want, kernels) in runs.items():
        label = f"cli roundtrip {std} {dec} scene {' '.join(extra)}".rstrip()
        reset_counts()
        rep = run_cli(["roundtrip", "--demo", "--pattern", "scene", "--standard", std,
                       "--decoder", dec, *extra])
        got = read_counts(label, kernels)
        print(f"{label} {rep['lines']}x{N}: psnr_db {rep['psnr_db']} (JAX CPU {want} +- "
              f"{PSNR_TOL}), launches {got}, {rep['seconds']} s on {rep['device']} ({card})")
        _check(abs(rep["psnr_db"] - want) <= PSNR_TOL + 1e-9, f"{label}: {rep}")
        _check(rep["device"] == "cuda" and rep["backend"] == "kernel", f"{label}: {rep}")
    return got


def check_cli_png_verbs(card: str) -> None:
    """Phase 7d: ``encode --raw`` then ``decode`` against ``roundtrip`` on
    the same input, and ``gallery``.  ``encode`` and ``gallery`` write PNGs
    through Pillow, so they run only where it imports."""
    import numpy as np

    from color_modem_tpu_torch import native
    from color_modem_tpu_torch.frame.image_io import HAVE_PIL, save_rgb
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    if not HAVE_PIL:
        print("cli encode/decode/gallery: Pillow does not import here; the PNG writers "
              "(encode, gallery) did not run")
        return
    print("cli encode/decode/gallery: Pillow imports here; running them")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.ppm")
        save_rgb(src, smooth_scene(SECAM_LINES, N).astype(np.float32))
        common = ["--standard", "pal", "--decoder", "delayline"]
        run_cli(["roundtrip", "--input", src, "--output", os.path.join(tmp, "rt.ppm"), *common])
        enc = run_cli(["encode", "--input", src, "--output", os.path.join(tmp, "c.png"),
                       "--raw", os.path.join(tmp, "c.npy"), *common])
        run_cli(["decode", "--input", os.path.join(tmp, "c.npy"),
                 "--output", os.path.join(tmp, "dec.ppm"), *common])
        a, b = (native.read_ppm(os.path.join(tmp, f)).astype(int) for f in ("rt.ppm", "dec.ppm"))
        e = int(np.abs(a - b).max())
        print(f"cli encode --raw -> decode pal delayline {enc['lines']}x{N}: decoded image "
              f"against roundtrip's max |diff| {e} code values (bytes equal: {e == 0}), on "
              f"{card}")
        _check(e <= 1, f"cli encode -> decode differs from roundtrip by {e} code values")
        t0 = time.perf_counter()
        gal = run_cli(["gallery", "--out", os.path.join(tmp, "gallery")])
        rows = gal["psnr_db"]
        pngs = [f for f in os.listdir(os.path.join(tmp, "gallery")) if f.endswith(".png")]
        print(f"cli gallery: {len(rows)} rows, {len(pngs)} PNGs in "
              f"{time.perf_counter() - t0:.1f} s; ntsc_comb3 {rows['ntsc_comb3']} dB, "
              f"pal_delayline {rows['pal_delayline']} dB, d2mac {rows['d2mac']} dB, on {card}")
        # 8 standards x their still decoders, S-Video, the RF, dropout,
        # ghost and scrambling rows, D2-MAC and the PALplus pair
        _check(len(rows) == GALLERY_ROWS and all(np.isfinite(v) for v in rows.values()),
               f"cli gallery: {len(rows)} rows (expected {GALLERY_ROWS}): {rows}")


def check_line_api(dev, card: str) -> dict:
    """Phase 7e: the per-line modems on the card over 24 lines.  Each
    line's encode launches the encode kernel on one line (24 launches per
    image), held against the batch pipeline's encode (2e-5, SECAM 2e-4);
    the decoded interior lines against the batch decode (5e-4); a 1-line
    kernel encode against the plain encode on the card.  Returns the
    launches per kernels-line entry."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import compat
    from color_modem_tpu_torch.frame.pipeline import encode_block, frame_line_index, make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan, plan_on
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    lines = LINE_API_LINES
    img = smooth_scene(lines, N, seed=3).astype(np.float32)
    launches = {}
    for std, decoder, cls, skip, entry in LINE_API_CASES:
        if cls in ("SimpleCombModem", "Simple3DCombModem"):
            modem = getattr(compat, cls)(compat.NtscModem(N, dev))
        else:
            modem = getattr(compat, cls)(N, dev)
        im = compat.ImageModem(modem)
        enc, dec, _ = make_pipeline(make_plan(ALL_STANDARDS[std](), N), decoder, device=dev)
        comp_b = enc(img[None], 0)
        rgb_b = dec(comp_b, 0)[0].cpu().numpy()
        comp_b = comp_b[0].cpu().numpy()
        label = f"line api {cls} ({std} {decoder}) {lines}x{N}"
        kernel = "secam_encode" if std == "secam" else "qam_encode"
        reset_counts()
        t0 = time.perf_counter()
        comp = im.modulate_image(img)
        rgb = im.demodulate_image(comp_b)
        dt = time.perf_counter() - t0
        # a matrix per line each way, and the 3-D comb's one more for the
        # line it holds back
        got = read_counts(label, {kernel: lines,
                                  "colour_matrix": 2 * lines + (decoder == "comb3")})
        launches[entry] = launches.get(entry, 0) + got[kernel]
        launches["colour_matrix"] = launches.get("colour_matrix", 0) + got["colour_matrix"]
        e_enc = float(np.abs(comp - comp_b).max())
        hi = lines - 1 if decoder == "comb3" else lines
        e_dec = float(np.abs(rgb[:, skip:hi] - rgb_b[:, skip:hi]).max())
        atol = SECAM_ENC_ATOL if std == "secam" else ENC_ATOL
        print(f"{label}: encode vs batch {e_enc:.3e} (<= {atol}), decode vs batch on lines "
              f"{skip}:{hi} {e_dec:.3e} (<= {DEC_ATOL}), {kernel} launches {got[kernel]}, "
              f"{2 * lines / dt:.1f} lines/s (modulate + demodulate, host clock) on {card}")
        _check(e_enc <= atol, f"{label}: encode {e_enc}")
        _check(e_dec <= DEC_ATOL, f"{label}: decode {e_dec}")
    # one line through each encode kernel against the plain encode, on the card
    rgb1 = torch.tensor(img[None, :, 7:8], device=dev)
    for std in ("ntsc", "pal", "secam"):
        plan = plan_on(make_plan(ALL_STANDARDS[std](), N), dev)
        g = frame_line_index(plan, 5, 1, 1, dev)
        k, p = encode_block(plan, rgb1, g, "kernel"), encode_block(plan, rgb1, g, "plain")
        torch.cuda.synchronize()
        e = _max_err(k, p)
        atol = SECAM_ENC_ATOL if std == "secam" else ENC_ATOL
        print(f"line api {std}: a 1-line kernel encode against the plain encode on the card, "
              f"max|err| {e:.3e} (<= {atol})")
        _check(e <= atol, f"line api {std}: 1-line kernel encode {e}")
    return launches


def check_sanitizer(dev) -> None:
    """Phase 7f: ``utils/debug.py::checked`` passes a clean decode on the
    card and raises on a NaN put into one composite sample; it names the
    operation and the port's line that made a NaN which the decode then
    removes (``nan_to_num`` after it: the plain backend's comb stencil),
    and names the CUDA kernel whose output holds a NaN (its wrapper's hook:
    the kernel backend's comb stencil pass, and the QAM encoder), the NaN
    again removed after it."""
    import re

    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.debug import checked
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    def raises(fn, *args, kind=FloatingPointError) -> str:
        try:
            fn(*args)
        except kind as e:
            return str(e)
        raise AssertionError(f"sanitizer: checked() let a NaN through on the card ({fn})")

    plan = make_plan(NTSC(), N)
    enc, dec, _ = make_pipeline(plan, "comb3", device=dev)
    comp = enc(smooth_scene(480, N).astype(np.float32)[None], 0).clone()
    checked(dec)(comp, 0)
    comp[0, 5, 100] = float("nan")
    msg = raises(checked(dec), comp, 0)
    print(f"sanitizer: checked() passed the clean decode and raised on a NaN in the "
          f"composite on {dev}: {msg}")

    dec_p = make_pipeline(plan, "comb3", "plain", device=dev)[1]

    def decode_then_clean(c, frame0):
        return torch.nan_to_num(dec_p(c, frame0))

    msg = raises(checked(decode_then_clean), comp, 0)
    print(f"sanitizer: a NaN made and removed inside a plain decode on {dev}: {msg}")
    _check(re.search(r"aten\.\S+ made a NaN at color_modem_tpu_torch/\S+\.py:\d+", msg)
           is not None, f"sanitizer: the op and its line are not named: {msg}")

    def kernel_decode_then_clean(c, frame0):
        return torch.nan_to_num(dec(c, frame0))

    msg = raises(checked(kernel_decode_then_clean), comp, 0)
    print(f"sanitizer: a NaN made and removed inside a kernel decode on {dev}: {msg}")
    _check("the CUDA kernel comb_stencil made a NaN" in msg,
           f"sanitizer: the comb stencil's pass is not named: {msg}")

    pd = plan.to(dev)
    ycc = torch.zeros((1, 3, 16, N), device=dev)
    ycc[0, 1, 3, 100] = float("nan")
    cols = qk.phase_cols(pd, frame_line_index(pd, 0, 1, 16, dev))

    def encode_then_clean(x):
        return torch.nan_to_num(qk.encode_lines(pd, x, cols))

    msg = raises(checked(encode_then_clean), ycc)
    print(f"sanitizer: a NaN in a kernel's output, through the wrappers' hook, on {dev}: {msg}")
    _check("the CUDA kernel qam_encode made a NaN" in msg,
           f"sanitizer: the kernel is not named: {msg}")


def check_cli_mesh(card: str) -> None:
    """Phase 7g: ``cli video --mesh`` under ``python -m
    torch.distributed.run`` over NCCL (1x1 on one card, 2x2 with four),
    rank 0 alone reporting, its frames and clip equal to the unsharded
    verb's."""
    import glob

    import numpy as np
    import torch

    ranks, mesh = (4, "2x2") if torch.cuda.device_count() >= 4 else (1, "1x1")
    frames = 16
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["video", "--standard", "ntsc", "--decoder", "comb3", "--frames", str(frames),
                "--chunk", str(frames)]
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(ranks), "-m", "color_modem_tpu_torch.cli", *argv, "--mesh", mesh, "--out",
             os.path.join(tmp, "mesh"), "--output", os.path.join(tmp, "mesh.y4m")],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        _check(res.returncode == 0, f"cli video --mesh {mesh}: rc {res.returncode}\n"
               f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        reports = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
        one = run_cli(argv + ["--out", os.path.join(tmp, "one"),
                              "--output", os.path.join(tmp, "one.y4m")])

        def saved(d):
            return np.concatenate([np.load(f) for f in sorted(
                glob.glob(os.path.join(tmp, d, "rgb_*.npy")))])

        e = float(np.abs(saved("mesh") - saved("one")).max())
        with open(os.path.join(tmp, "mesh.y4m"), "rb") as f, \
                open(os.path.join(tmp, "one.y4m"), "rb") as g:
            same_clip = f.read() == g.read()
    label = f"cli video --mesh {mesh} over NCCL ({ranks} rank(s), torch.distributed.run)"
    _check(len(reports) == 1, f"{label}: {len(reports)} reports (rank 0 alone reports)")
    rep = reports[0]
    print(f"{label}: min_psnr_db {rep['min_psnr_db']} (unsharded {one['min_psnr_db']}), frames "
          f"max|diff| {e:.3e} (== 0), clip equal: {same_clip}, {rep['mpix_per_s']} Mpix/s "
          f"(a first run), launch to exit {wall:.1f} s, on {card}")
    _check(rep["mesh"] == dict(zip(("frame", "lineblk"), map(int, mesh.split("x")))),
           f"{label}: {rep}")
    _check(rep["min_psnr_db"] == one["min_psnr_db"] and e == 0.0 and same_clip,
           f"{label}: differs from the unsharded verb")


# --- phase 8: the benchmark and the entry point ----------------------------------------------

#: phase 8: the benchmark's flagship paths, (standard, decoder) -> the JAX
#: CPU round-trip PSNR that phases 4, 4b and 4c hold at the same shape
BENCH_PATHS = {
    ("ntsc", "comb3"): (PSNR_EXPECTED, roundtrip_launches("ntsc", "comb3")),
    ("secam", "interp"): (SECAM_PSNR["interp"], roundtrip_launches("secam", "interp")),
    ("pal", "delayline"): (QAM_FAMILY["pal", "delayline"][0], roundtrip_launches("pal", "delayline")),
    ("niir", "avg"): (QAM_FAMILY["niir", "avg"][0], roundtrip_launches("niir", "avg")),
}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
ROOFLINE_SHARES = ("tflops_fraction_of_f32_peak", "hbm_fraction_of_peak")
#: a roofline share above this is a counting fault
SHARE_MAX = 1.05


def check_bench_output(label: str, stdout: str, results: str, std: str, dec: str,
                       want: tuple, power_limit: float) -> dict:
    """A bench run's last line (the four keys, a finite positive value),
    its roofline line and its record under ``results``: the PSNR +-
    PSNR_TOL of the JAX CPU value, one launch of each path kernel per call,
    every roofline share in (0, SHARE_MAX], the power limit
    ``power_limit``.  Returns the record."""
    import math

    psnr_want, kernels = want
    out = stdout.strip().splitlines()
    line = json.loads(out[-1])
    _check(set(line) == BENCH_KEYS, f"{label}: last line {out[-1]}")
    _check(math.isfinite(line["value"]) and line["value"] > 0, f"{label}: {line}")
    roof = json.loads(out[-2])["roofline"]
    with open(os.path.join(results, f"bench_{std}_{dec}_kernel.json")) as f:
        rec = json.load(f)
    _check(rec["roofline"] == roof, f"{label}: roofline line differs from the record")
    _check(rec["power_limit_w"] == power_limit, f"{label}: power limit {rec['power_limit_w']} "
           f"W, nvidia-smi {power_limit} W")
    launches = {k: kernels.get(k, 0) for k in rec["kernel_launches"]}
    _check(rec["kernel_launches"] == launches,
           f"{label}: launches per call {rec['kernel_launches']}, expected {launches}")
    q = rec["roundtrip_psnr_db"]
    _check(abs(q - psnr_want) <= PSNR_TOL + 1e-9, f"{label}: psnr {q}, expected {psnr_want}")
    shares = [roof[k] for k in ROOFLINE_SHARES]
    _check(all(v is not None and 0.0 < v <= SHARE_MAX for v in shares),
           f"{label}: roofline shares {shares} outside (0, {SHARE_MAX}]")
    return rec


def check_bench(card: str, times: dict) -> dict:
    """Phase 8: ``python -m color_modem_tpu_torch.benchmark --roofline`` at
    the four flagship shapes, each in its own process, and ``cli bench``
    once in this one, from a temporary directory; each beside the Mpix/s
    that phase 5's kernel round trip implies at the same shape.  Returns
    the records by standard."""
    import contextlib
    import io

    from color_modem_tpu_torch import ALL_STANDARDS, cli

    # "NVIDIA H100 80GB HBM3, 700.00 W" -> 700.0
    power_limit = float(card.rsplit(",", 1)[1].split()[0])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        for (std, dec), want in BENCH_PATHS.items():
            lines = ALL_STANDARDS[std]().active_lines
            label = f"bench {std} {dec} {BATCH}x{lines}x{N}"
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "color_modem_tpu_torch.benchmark", "--standard", std,
                 "--decoder", dec, "--roofline"],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            _check(res.returncode == 0, f"{label}: rc {res.returncode}\n{res.stderr[-3000:]}")
            rec = check_bench_output(label, res.stdout, os.path.join(tmp, "results"), std, dec,
                                     want, power_limit)
            roof = rec["roofline"]
            rt_ms = times[std][f"{dec} roundtrip"]["kernel"]
            lo, hi = rec["spread_mpix_per_s"]
            print(f"{label}: {rec['mpix_per_s']} Mpix/s [{lo:.1f}, {hi:.1f}] (median [min, max] "
                  f"of 10 windows of {rec['iters']} calls), psnr {rec['roundtrip_psnr_db']} dB "
                  f"(JAX CPU {want[0]} +- {PSNR_TOL}), launches per call "
                  f"{ {k: v for k, v in rec['kernel_launches'].items() if v} }, roofline "
                  f"{roof['logical_tflops']} TFLOP/s ({roof['tflops_fraction_of_f32_peak']} of "
                  f"f32 peak), {roof['hbm_gbps']} GB/s ({roof['hbm_fraction_of_peak']} of HBM), "
                  f"bound {roof['bound_ms']:.4f} ms by {roof['binding_constraint']}; phase 5's "
                  f"kernel round trip {rt_ms[0]:.4f} ms implies "
                  f"{BATCH * lines * N / 1e3 / rt_ms[0]:.1f} Mpix/s; {rec['device_name']} "
                  f"{rec['power_limit_w']} W ({card}); process {wall:.1f} s")
            records[std] = rec
        # the CLI verb once, in this process, on the main path
        std, dec = "ntsc", "comb3"
        out, here = io.StringIO(), os.getcwd()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["bench", "--standard", std, "--decoder", dec, "--roofline"])
        finally:
            os.chdir(here)
        _check(rc == 0, f"cli bench: exit code {rc}")
        rec = check_bench_output("cli bench ntsc comb3", out.getvalue(),
                                 os.path.join(tmp, "results"), std, dec, BENCH_PATHS[std, dec],
                                 power_limit)
        print(f"cli bench {std} {dec}: {rec['mpix_per_s']} Mpix/s, psnr "
              f"{rec['roundtrip_psnr_db']} dB (module: {records[std]['roundtrip_psnr_db']}), "
              f"on {card}")
        _check(rec["roundtrip_psnr_db"] == records[std]["roundtrip_psnr_db"],
               "cli bench: PSNR differs from the module's")
    return records


def check_entry(dev) -> None:
    """Phase 8b: ``entry()``'s step once on the card: its output's shape,
    finite values, one launch of each main-path kernel; then
    ``dryrun_multichip(4)`` at its default device, 4 gloo ranks on the
    card(s), which raises on a wrong shape, a garbage PSNR or a case
    outside its bound."""
    import torch

    from color_modem_tpu_torch.entry import dryrun_multichip, entry

    step, (rgb,) = entry()
    _check(rgb.device.type == "cuda", f"entry: example input on {rgb.device}")
    reset_counts()
    out = step(rgb)
    got = read_counts("entry step", roundtrip_launches("ntsc", "comb3"))
    _check(tuple(out.shape) == (2, 3, 480, 720) and bool(torch.isfinite(out).all()),
           f"entry: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    print(f"entry(): step{tuple(rgb.shape)} -> {tuple(out.shape)} on {out.device}, finite, "
          f"launches {got}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        recs = dryrun_multichip(4, outdir=out_dir)
    on = {rec["device"] for rec in recs}
    _check(on == {"cuda:0"}, f"dryrun_multichip: rank 0 ran on {on}, not cuda:0")
    print(f"dryrun_multichip(4): {len(recs)} cases, rank 0 on cuda:0, in "
          f"{time.perf_counter() - t0:.1f} s")


# --- phase 3c: the kernels' memory sanitizer; phase 4k: the port's oracle -----------------

#: phase 4k: least parity with the port's oracle (``color_modem_tpu_torch/golden/``), dB.
#: Every frame path: PSNR >= tests/test_roundtrip.py's PARITY_BOUND.  The
#: transmission, sound, MAC and PALplus rows: the bound of the port's CPU test of each
#: against golden (variance-relative parity as those tests read it; MAC and PALplus
#: as tests/test_torch_mac.py and tests/test_torch_palplus.py read them).  The hops
#: and the sound chains run on 2 frames of phases 4g and 4h's 480 lines x 720
ORACLE_DB = 60.0
ORACLE_BOUNDS = {
    "rf_modulate": 54.0, "rf_demodulate": 42.0,                  # tests/test_torch_rf.py
    "fm_modulate": 60.0, "fm_demodulate": 95.0,                  # tests/test_torch_satellite.py
    "sat_fm_modulate_audio": 60.0, "sat_fm_demodulate_audio": 100.0,
    "sound_on_rf": 100.0, "sound_from_rf": 65.0,                 # tests/test_torch_sound_rf.py
    "mts_encode": 120.0, "mts_decode": 120.0,                    # tests/test_torch_mts.py
    "a2_on_rf": 105.0, "a2_takeoff2": 85.0,                      # tests/test_torch_a2.py
    "mac_encode": 60.0, "mac_decode": 60.0,                      # tests/test_torch_mac.py
    "palplus_encode": 120.0, "palplus_decode": 115.0,            # tests/test_torch_palplus.py
}
#: phase 4k: the frame paths of phases 4, 4b and 4c
ORACLE_PATHS = ([("ntsc", "comb3")] + [("secam", d) for d in SECAM_PSNR] + list(QAM_FAMILY))
#: phase 4k: lines per frame of the hop and sound rows (phases 4g and 4h's)
ORACLE_STREAM_LINES = 480


def check_kernel_sanitizer(dev, card: str) -> dict:
    """Phase 3c: ``kernels/sanitize.py`` on every kernel row (the unshared
    pair on NTSC, the shared pair on PAL and NIIR, the SECAM pair) at every
    (frames, lines, samples) of its grid: the poisoned build (shared memory
    filled with a NaN first) against the normal one, NaNs, guard sentinels,
    inputs, unwritten samples (the sentinel under two different fills) and
    20 repeated launches.  Launches the C
    entry points directly: the wrappers' counts stay 0.  Returns the
    poisoned build's seconds and the phase's."""
    from color_modem_tpu_torch.kernels import sanitize
    from color_modem_tpu_torch.kernels.build import load_library

    t0 = time.perf_counter()
    load_library(poison=True)
    t_build = time.perf_counter() - t0
    print(f"3c poisoned build (-DCMT_POISON): {t_build:.2f} s")

    def report(r):
        f, l, n = r["shape"]
        p = r["poison"]
        print(f"3c {r['row']} {r['standard']} {f}x{l}x{n}: poisoned vs normal max|diff| "
              f"{r['max_poison_diff']:.3e} (bit-equal {r['poison_equal']}), NaNs {r['nan']} / "
              f"{p['nan']}, sentinels intact {r['sentinels_intact'] and p['sentinels_intact']}, "
              f"unwritten {r['unwritten']}, inputs intact "
              f"{r['inputs_intact'] and p['inputs_intact']}, {sanitize.REPEATS} launches "
              f"identical {r['repeats_equal']}: {'ok' if r['ok'] else 'FAULT'}")

    reset_counts()
    t0 = time.perf_counter()
    results = sanitize.run_all(dev, report=report)
    read_counts("3c sanitizer", {})
    t_run = time.perf_counter() - t0
    bad = [(r["row"], r["standard"], r["shape"]) for r in results if not r["ok"]]
    print(f"3c sanitizer: {len(results)} launches sanitized ({len(sanitize.ROWS)} kernel rows, "
          f"{len(sanitize.PRNG_ROWS)} threefry rows, {len(sanitize.COLOUR_ROWS)} colour-matrix "
          f"rows and {len(sanitize.COMB_ROWS)} comb-stencil rows x "
          f"lines {sanitize.LINES} x samples {sanitize.SAMPLES} x frames {sanitize.FRAMES}, "
          f"samples {sanitize.SECAM_ONLY_SAMPLES} on the SECAM rows only), "
          f"{len(bad)} faults, {t_run:.1f} s on {card}")
    _check(not bad, f"3c sanitizer faults: {bad}")
    return {"build_s": t_build, "run_s": t_run}


def _psnr_np(a, b) -> float:
    import numpy as np

    err = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if err == 0.0 else 10.0 * np.log10(1.0 / err)


def _parity_db(a, b) -> float:
    """Variance-relative parity, dB, as the port's CPU tests against golden read it."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return 10.0 * np.log10(float(np.var(b)) / max(float(np.mean((a - b) ** 2)), 1e-300))


def oracle_streams(dev, hold, frames: int = 2, lines: int = ORACLE_STREAM_LINES) -> None:
    """Phase 4k's hop and sound rows: the RF and satellite hops and the
    sound chains (intercarrier, MTS, satellite subcarriers, A2) on
    ``frames`` x ``lines`` x 720 of phase 4g's NTSC notch composite, each
    against its oracle in ``color_modem_tpu_torch/golden/``;
    ``hold(key, parity_db, bound)`` judges each row."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame import a2, mts
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat_mod
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.golden import sound as g_sound
    from color_modem_tpu_torch.golden import transmission as g_tx
    from color_modem_tpu_torch.modem.plan import make_plan

    def host(x):
        return x.detach().double().cpu().numpy()

    def up(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    # the hops (phase 4g's NTSC notch composite)
    plan = make_plan(NTSC(), N).to(dev)
    comp = make_pipeline(plan, "notch", "kernel", dev)[0](full_scene(lines, dev, frames), 0)
    comp_h = host(comp)
    shape = f"{frames}x{lines}x{N}"
    rfp, sp = rf_mod.make_rf_plan(plan), sat_mod.make_sat_plan(plan.fs, N)
    g_rf = g_tx.rf_modulate(rfp, comp_h, 0)
    hold(f"rf_modulate {shape}", _parity_db(host(rf_mod.rf_modulate(rfp, comp, 0)), g_rf),
         ORACLE_BOUNDS["rf_modulate"])
    g32 = g_rf.astype(np.float32)
    hold(f"rf_demodulate {shape}", _parity_db(host(rf_mod.rf_demodulate(rfp, up(g32), 0)),
                                                g_tx.rf_demodulate(rfp, g32, 0)),
         ORACLE_BOUNDS["rf_demodulate"])
    g_fm = g_tx.fm_modulate(sp, comp_h)
    hold(f"fm_modulate {shape}", _parity_db(host(sat_mod.fm_modulate(sp, comp)), g_fm),
         ORACLE_BOUNDS["fm_modulate"])
    g32 = g_fm.astype(np.float32)
    hold(f"fm_demodulate {shape}", _parity_db(host(sat_mod.fm_demodulate(sp, up(g32))),
                                                g_tx.fm_demodulate(sp, g32)),
         ORACLE_BOUNDS["fm_demodulate"])

    # the sound chains (phase 4h's; A2 on NTSC, as there)
    item = lines * N
    tt = np.arange(frames * item, dtype=np.float64) / plan.fs
    audio = np.stack([0.6 * np.sin(2 * np.pi * f * tt[:item]) + 0.2 * np.sin(5.4 * np.pi * f * tt[:item])
                      for f in (700.0, 1700.0)]).astype(np.float32)
    rf0 = np.zeros((frames, lines, rfp.n_rf), np.float32)
    g_rf = g_sound.sound_on_rf(rfp, rf0, 0, audio, 1.234)
    hold(f"sound_on_rf {shape}", _parity_db(host(rf_mod.sound_on_rf(
        rfp, up(rf0), 0, up(audio), 1.234)), g_rf), ORACLE_BOUNDS["sound_on_rf"])
    g32 = g_rf.astype(np.float32)
    hold(f"sound_from_rf {shape}", _parity_db(host(rf_mod.sound_from_rf(rfp, up(g32), 0)),
                                                g_sound.sound_from_rf(rfp, g32, 0)),
         ORACLE_BOUNDS["sound_from_rf"])
    left = (0.5 * np.sin(2 * np.pi * 900.0 * tt)).astype(np.float32)[None]
    right = (0.5 * np.sin(2 * np.pi * 2400.0 * tt)).astype(np.float32)[None]
    g_a = g_sound.mts_encode(N, left, right)
    hold(f"mts_encode {shape}", _parity_db(host(mts.mts_encode(plan, up(left), up(right))), g_a),
         ORACLE_BOUNDS["mts_encode"])
    a32 = g_a.astype(np.float32)
    got = mts.mts_decode(plan, up(a32))
    want = g_sound.mts_decode(N, mts._channel_lpf(plan.fs), a32)
    hold(f"mts_decode {shape} (left, right)", min(_parity_db(host(got[k]), want[k])
                                                   for k in range(2)), ORACLE_BOUNDS["mts_decode"])
    # tests/test_torch_satellite.py's stimulus: one subcarrier, a tone of 9
    # cycles per frame stream (the stream is one period)
    sp2 = sat_mod.make_sat_plan(plan.fs, N, audio_subs=1)
    n_tot = comp_h.shape[1] * N
    k = np.arange(n_tot, dtype=np.float64)
    sub_audio = np.broadcast_to((0.7 * np.sin(2 * np.pi * 9 * k / n_tot))[None, None],
                                (frames, 1, n_tot)).astype(np.float32)
    g_fm = g_sound.sat_fm_modulate_audio(sp2, comp_h, sub_audio)
    hold(f"sat_fm_modulate_audio {shape}", _parity_db(host(sat_mod.fm_modulate(
        sp2, comp, audio=up(sub_audio))), g_fm), ORACLE_BOUNDS["sat_fm_modulate_audio"])
    g32 = g_fm.astype(np.float32)
    hold(f"sat_fm_demodulate_audio {shape}", _parity_db(host(sat_mod.fm_demodulate_audio(
        sp2, up(g32))), g_sound.sat_fm_demodulate_audio(sp2, g32)),
        ORACLE_BOUNDS["sat_fm_demodulate_audio"])
    a2p = a2.make_a2_plan(rfp)
    audio2 = (0.6 * np.sin(2 * np.pi * 1300.0 * tt[:item])).astype(np.float32)[None]
    audio2 = audio2.repeat(frames, 0)
    rf0 = np.zeros((frames, lines, rfp.n_rf), np.float32)
    g_rf = g_sound.a2_on_rf(a2p, rf0, 0, audio2, "stereo")
    hold(f"a2_on_rf {shape}", _parity_db(host(a2.a2_on_rf(a2p, up(rf0), 0, up(audio2),
                                                         "stereo")), g_rf),
         ORACLE_BOUNDS["a2_on_rf"])
    g32 = g_rf.astype(np.float32)
    raw, _ = a2._takeoff(a2p, up(g32), a2p.bpf2, a2p.snd2_ramp, 0,
                         sign=a2._carrier2_sign(a2p, 0, frames, lines, dev))
    hold(f"a2_takeoff2 {shape}", _parity_db(host(raw), g_sound.a2_takeoff2(a2p, g32, 0)),
         ORACLE_BOUNDS["a2_takeoff2"])


def check_oracle(dev, card: str) -> float:
    """Phase 4k: the card against the port's own oracle
    (``color_modem_tpu_torch/golden/``, NumPy float64 per line), at full
    width.  Every frame path of phases 4, 4b and 4c on frames 0-1 of the
    16-frame ``full_scene`` through the kernel backend, every line and
    sample: the composite against ``golden.encode_frame`` and the decoded
    RGB against ``golden.decode_frame`` on the composite the card decoded
    (the temporal combs: ``golden.decode_sequence`` over frames 0..1+pt, in
    which frames 0-1 see the neighbours they see in the batch), each >= 60
    dB.  Then the RF and satellite hops and the sound chains on 2 frames of
    phases 4g and 4h's 480 lines x 720 (:func:`oracle_streams`), and
    D2-MAC and PALplus at phases 4g and 4i's 576 x 720 on two frames, each
    against its oracle with its CPU test's bound.  Returns the seconds."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS, PAL, golden
    from color_modem_tpu_torch.frame import palplus
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.golden import mac as g_mac
    from color_modem_tpu_torch.golden import palplus as g_pp
    from color_modem_tpu_torch.modem import mac
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import temporal_comb_spacing

    t_start = time.perf_counter()

    def host(x):
        return x.detach().double().cpu().numpy()

    def up(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    def hold(key: str, q: float, bound: float) -> None:
        print(f"4k {key}: {q:.4f} dB against the oracle (>= {bound}) on {card}")
        _check(q >= bound, f"4k {key}: {q} dB < {bound}")

    # the frame paths
    encoded = set()
    for name, decoder in ORACLE_PATHS:
        cfg = ALL_STANDARDS[name]()
        lines, plan = cfg.active_lines, make_plan(cfg, N)
        t0 = time.perf_counter()
        rgb = full_scene(lines, dev)
        enc, dec, _ = make_pipeline(plan, decoder, "kernel", dev)
        comp = enc(rgb, 0)
        out = dec(comp, 0)
        if decoder in ("comb3d", "comb3dA"):
            pt = temporal_comb_spacing(cfg)
            comp_h = host(comp[: max(2 * pt, 2 + pt)])
            ref = golden.decode_sequence(plan, comp_h, frame0=0, decoder=decoder)[:2]
        else:
            comp_h = host(comp[:2])
            ref = np.stack([golden.decode_frame(plan, comp_h[f], frame=f, decoder=decoder)
                            for f in range(2)])
        if name not in encoded:
            encoded.add(name)
            rgb_h = host(rgb[:2])
            q = min(_psnr_np(comp_h[f], golden.encode_frame(plan, rgb_h[f], frame=f))
                    for f in range(2))
            hold(f"{name} encode, frames 0-1 of {BATCH}x3x{lines}x{N}", q, ORACLE_DB)
        hold(f"{name} {decoder} decode, frames 0-1 of {BATCH}x3x{lines}x{N} "
             f"({time.perf_counter() - t0:.2f} s)", _psnr_np(host(out[:2]), ref), ORACLE_DB)

    oracle_streams(dev, hold)
    pal = make_plan(PAL(), N).to(dev)
    frames, plines = 2, 576

    # D2-MAC (phase 4g: 576 lines of 720 into 1296-sample lines), picture and data
    mplan = mac.make_mac_plan(N)
    mrgb = full_scene(plines, dev, frames)
    mlines = mrgb.shape[-2]
    g = (torch.arange(frames, dtype=torch.int32, device=dev)[:, None] * mplan.cfg.total_lines
         + torch.arange(mlines, dtype=torch.int32, device=dev))
    cap = mplan.cfg.data_symbols - len(mplan.cfg.line_sync_word)
    payload = np.random.default_rng(4).integers(0, 2, (frames, mlines, cap))
    sig = mac.encode(mplan, mrgb, g, torch.tensor(payload, dtype=torch.int32, device=dev))
    mrgb_h = host(mrgb)
    g_sig = [g_mac.encode_frame(mplan, mrgb_h[f], f * mplan.cfg.total_lines,
                                payload=payload[f].tolist()) for f in range(frames)]
    hold("mac_encode 2x576x720", min(_psnr_np(host(sig[f]), g_sig[f]) for f in range(frames)),
         ORACLE_BOUNDS["mac_encode"])
    out = mac.decode(mplan, up(np.stack(g_sig)), g)
    hold("mac_decode 2x576x720", min(_psnr_np(host(out[f]), g_mac.decode_frame(
        mplan, g_sig[f], f * mplan.cfg.total_lines)) for f in range(frames)),
        ORACLE_BOUNDS["mac_decode"])
    sig_h = host(sig)
    for f, l in ((0, 3), (1, mlines - 5)):
        ok, bits = g_mac.decode_data_line(mplan, sig_h[f, l])
        _check(ok and list(bits) == payload[f, l].tolist(),
               f"4k mac data line {f}/{l}: the oracle reads other bits")
    print(f"4k mac data burst: the oracle reads the card's lines 0/3 and 1/{mlines - 5} bit "
          "for bit")

    # PALplus (phase 4i: PAL 576 x 720, the helper-band scene)
    taps = palplus._helper_taps(pal)
    prgb_h = np.broadcast_to(palplus_scene(plines, N), (frames, 3, plines, N))
    pg = frame_line_index(pal, 0, frames, plines, dev)
    comp = palplus.encode_palplus(pal, up(prgb_h), pg, "kernel")
    g_comp = np.stack([g_pp.encode_palplus(pal, prgb_h[f], taps, frame=f) for f in range(frames)])
    hold("palplus_encode 2x576x720", _parity_db(host(comp), g_comp),
         ORACLE_BOUNDS["palplus_encode"])
    for use_helper in (True, False):
        out = palplus.decode_palplus(pal, up(g_comp), pg, "comb3", "kernel",
                                     use_helper=use_helper)
        want = np.stack([g_pp.decode_palplus(pal, g_comp[f], taps, frame=f, decoder="comb3",
                                             use_helper=use_helper) for f in range(frames)])
        hold(f"palplus_decode comb3 {'helper' if use_helper else 'zoom'} 2x576x720",
             _parity_db(host(out), want), ORACLE_BOUNDS["palplus_decode"])
    took = time.perf_counter() - t_start
    print(f"4k oracle: {len(ORACLE_PATHS)} frame paths, {len(ORACLE_BOUNDS)} transmission, "
          f"sound, MAC and PALplus rows, {took:.1f} s on {card}")
    return took


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
    for frames, n in ((BATCH, N), (4, 2 * N), (1, 3 * N)):
        e_enc, e_rgb = check_secam_kernels(dev, frames, n)
        max_err["secam_encode"] = max(max_err["secam_encode"], e_enc)
        max_err["secam_decode"] = max(max_err["secam_decode"], e_rgb)

    # --- 3c. the kernels' memory sanitizer: poisoned build, guard bands, repeats --
    sanitized = check_kernel_sanitizer(dev, card)

    # --- 3d. the threefry generator against its plain version, the CPU and JAX --
    threefry = check_threefry(dev, card)

    # --- 3e. the colour matrix against its plain version ------------------------
    colour = check_colour_matrix(dev, card)
    delayline = check_delayline_matrix(dev, card)
    stencil = check_comb_stencil(dev, card)

    # --- 4. main path; 4b. the SECAM path -------------------------------------
    paths = {}
    rt_k, rt_p, launches = check_path(dev, "ntsc", "comb3", PSNR_EXPECTED,
                                      roundtrip_launches("ntsc", "comb3"))
    paths["ntsc", "comb3"] = (rt_k, rt_p)
    for decoder, expected in SECAM_PSNR.items():
        rt_k, rt_p, got = check_path(dev, "secam", decoder, expected,
                                     roundtrip_launches("secam", decoder))
        if decoder == "interp":
            launches.update({k: got[k] for k in ("secam_encode", "secam_decode")})
            paths["secam", decoder] = (rt_k, rt_p)
    # the chip matrix's SECAM row, 1440 samples
    wide = check_path(dev, "secam", "interp", SECAM_PSNR_1440, roundtrip_launches("secam", "interp"),
                      n=2 * N)[:2]

    # --- 4c. the rest of the QAM family ---------------------------------------
    for (name, decoder), (expected, (n_enc, n_dec)) in QAM_FAMILY.items():
        rt_k, rt_p, got = check_path(dev, name, decoder, expected,
                                     roundtrip_launches(name, decoder, n_enc, n_dec))
        paths[name, decoder] = (rt_k, rt_p)
        if (name, decoder) == ("pal", "delayline"):
            # the _shared forms: the same CUDA kernels with equal tile arrays
            launches["qam_encode_shared"] = got["qam_encode"]
            launches["qam_decode_shared"] = got["qam_decode"]
            launches["delayline_matrix"] = got["delayline_matrix"]

    # --- 4k. the card against the port's oracle (golden/) at full width ----------
    t_oracle = check_oracle(dev, card)
    print(f"3c + 4k: {sanitized['run_s'] + t_oracle:.1f} s (poisoned build "
          f"{sanitized['build_s']:.2f} s more) on {card}")

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

    # --- 4i. the data services and instruments ------------------------------------
    services = check_data_services(dev, card)

    # --- 4j. the parallel layer: ranks sharing the card -----------------------------
    launches_sharded = check_sharded(dev, card)

    # --- 5. timing: main path and SECAM; 5c. PAL/NIIR; 5e. frame layer ---------
    times = {}
    for name, decoder in (("ntsc", "comb3"), ("secam", "interp"), ("pal", "delayline"),
                          ("niir", "avg")):
        times[name] = time_path(dev, card, name, decoder, paths[name, decoder])
    times["secam1440"] = time_path(dev, card, "secam", "interp", wide, n=2 * N)
    time_frame_layer(card, timed)
    time_transmission(card, hops)
    time_sound(card, sound)
    time_data_services(card, services)

    # --- 6. the video runner ----------------------------------------------------
    video = check_video(dev, card)
    check_video_services(dev, card)
    check_video_mesh(dev, card, video)

    # --- 7. the surfaces: native codec, Y4M, the CLI verbs, per-line API -------
    check_native()
    launches_cli = check_cli_video(dev, card, video)
    launches_cli_noisy = check_cli_roundtrips(card)
    check_cli_png_verbs(card)
    launches_line_api = check_line_api(dev, card)
    check_sanitizer(dev)
    check_cli_mesh(card)

    # --- 8. the benchmark, the CLI's bench verb and the entry point -------------
    bench = check_bench(card, times)
    check_entry(dev)

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
         "launches_data_services": services["launches"].get(name),
         "launches_sharded": launches_sharded[name],
         "launches_cli_video": launches_cli.get(name, 0),
         "launches_line_api": launches_line_api.get(name, 0),
         "launches_bench": bench[path]["kernel_launches"][kernel],
         "ms_spread": list(times[path][kernel]["kernel"][1:]),
         "plain_ms_spread": list(times[path][kernel]["plain"][1:])}
        for name, (kernel, path, where) in replaces.items()
    ] + [
        # the threefry generator: launches on the runner's noisy channel
        # (one per chunk) and on the CLI's noisy RF round trip
        {"name": name, "route": "cuda", "source": "color_modem_tpu_torch/csrc/threefry.cu",
         "replaces": "jax.random (XLA threefry2x32, no Pallas kernel)",
         "launches": launches, "max_abs_err": threefry["err"][name],
         "ms": threefry["times"][name]["kernel"][0],
         "plain_ms": threefry["times"][name]["plain"][0],
         "bound_ms": threefry["bounds"][name][0], "bound_by": threefry["bounds"][name][1],
         "library_ms": None, "path": path,
         "ms_spread": list(threefry["times"][name]["kernel"][1:]),
         "plain_ms_spread": list(threefry["times"][name]["plain"][1:])}
        for name, launches, path in (
            ("threefry_add_normal", video["channel noise"]["launches"]["threefry_add_normal"],
             f"process_video channel noise, {VIDEO_FRAMES} frames in chunks of {VIDEO_CHUNK}"),
            ("threefry_bits", launches_cli_noisy["threefry_bits"],
             "cli roundtrip ntsc comb3 " + " ".join(CLI_NOISY_ARGS)))
    ] + [
        # the colour matrix: both matrices of a round trip, timed as the
        # decoder's (with its clamp) at phase 4's shape
        {"name": "colour_matrix", "route": "cuda",
         "source": "color_modem_tpu_torch/csrc/colour_matrix.cu",
         "replaces": "color_modem_tpu/dsp/colorimetry.py apply_mat3 (XLA einsum, no Pallas "
                     "kernel)",
         "launches": launches["colour_matrix"], "max_abs_err": colour["err"],
         "ms": t_colour["kernel"][0], "plain_ms": t_colour["plain"][0],
         "bound_ms": t_colour["bound"][0], "bound_by": t_colour["bound"][1],
         "library_ms": None,
         "launches_data_services": services["launches"].get("colour_matrix"),
         "launches_sharded": launches_sharded["colour_matrix"],
         "launches_cli_video": launches_cli.get("colour_matrix", 0),
         "launches_line_api": launches_line_api.get("colour_matrix", 0),
         "launches_bench": bench["ntsc"]["kernel_launches"]["colour_matrix"],
         "ms_spread": list(t_colour["kernel"][1:]),
         "plain_ms_spread": list(t_colour["plain"][1:])}
        for t_colour in (colour["times"][COLOUR_SHAPES[0], "decode"],)
    ] + [
        # the delay-line pass: PAL delayline's decoder matrix, at phase 4c's shape
        {"name": "delayline_matrix", "route": "cuda",
         "source": "color_modem_tpu_torch/csrc/colour_matrix.cu",
         "replaces": "color_modem_tpu/separate/delayline.py average_with_neighbor and "
                     "dsp/colorimetry.py apply_mat3 (XLA, no Pallas kernel)",
         "launches": launches["delayline_matrix"], "max_abs_err": delayline["err"],
         "ms": t_delay["kernel"][0], "plain_ms": t_delay["plain"][0],
         "bound_ms": t_delay["bound"][0], "bound_by": t_delay["bound"][1],
         "library_ms": None, "launches_bench": bench["pal"]["kernel_launches"]["delayline_matrix"],
         "ms_spread": list(t_delay["kernel"][1:]),
         "plain_ms_spread": list(t_delay["plain"][1:])}
        for t_delay in (delayline["times"][DELAYLINE_SHAPES[0]],)
    ] + [
        # the comb stencil: NTSC comb3's, at the NTSC batch cell's shape
        {"name": "comb_stencil", "route": "cuda",
         "source": "color_modem_tpu_torch/csrc/comb_stencil.cu",
         "replaces": "color_modem_tpu/separate/comb.py stencil_signal on separate/stencil.py "
                     "prev_reflect, next_reflect (XLA, no Pallas kernel)",
         "launches": launches["comb_stencil"], "max_abs_err": stencil["err"],
         "ms": t_comb["kernel"][0], "plain_ms": t_comb["plain"][0],
         "bound_ms": t_comb["bound"][0], "bound_by": t_comb["bound"][1],
         "library_ms": None,
         "launches_data_services": services["launches"].get("comb_stencil"),
         "launches_sharded": launches_sharded["comb_stencil"],
         "launches_cli_video": launches_cli.get("comb_stencil", 0),
         "launches_bench": bench["ntsc"]["kernel_launches"]["comb_stencil"],
         "ms_spread": list(t_comb["kernel"][1:]),
         "plain_ms_spread": list(t_comb["plain"][1:])}
        for t_comb in (stencil["times"][COMB_SHAPES[1][0], "comb3"],)
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
