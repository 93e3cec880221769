"""Chunked, resumable video processing.

Port of ``color_modem_tpu/frame/video.py``.  A video run pushes frame
chunks through the round-trip pipeline (progressive or interlaced, with an
optional channel and temporal noise reduction).  Each finished chunk is
recorded in the output directory's manifest with a fingerprint and PSNR
computed on the device; a re-run after an interruption skips the chunks
already done.  A JSON summary goes to ``<out_dir>/results/``.

The host syncs once per wave of chunks: PSNR and fingerprint of every
chunk in the wave come back in one stacked fetch (plus the saved frames,
when asked for).

Between encode and decode a run can take a transmission hop (``rf``: the
VSB picture hop of ``frame/rf.py``, with a soundtrack on its intercarrier
FM sound carrier when ``rf_audio`` is given; ``satellite``: the FM hop of
``frame/satellite.py``, with channel noise at ``sat_cnr``), then the
composite channel (``frame/channel.py``) and the GCR equalizer
(``frame/equalize.py``), in the JAX runner's order.  The received audio
comes back in the wave's one stacked fetch and goes to ``aud_<start>.npy``
per chunk.

Two data services ride the transmission: ``caption_bits`` puts one
EIA-608-style caption cell (``frame/vbi.py``) on row 0 of each frame, or of
each frame's first field when interlaced, keyed by the absolute frame
index; the receiver slices the cells off the received row 0, and they come
back in the same fetch, to ``cc_<start>.npy`` (the frame PSNR then leaves
row 0 out).  ``scramble=(mode, key)`` scrambles the finished composite
(``frame/scramble.py``) after the data services and before the hop, keyed
by the absolute line index of each transmitted row (field-sequential when
interlaced); the receiver descrambles it before the decoder and the data
slicer, so the hop and the channel act on the scrambled signal.

Noise is the JAX runner's, on every device (``utils/prng.py``): keyed on
the absolute leading-axis index ``g`` (frames, or fields when
interlaced), so chunk size and resume points cannot change the
realisation.  The channel noise of item ``g`` is ``normal(fold_in(
PRNGKey(0), g))``, the satellite noise ``normal(fold_in(PRNGKey(0x5A7),
g))``, the noisy GCR record's ``normal(PRNGKey(1))``; each chunk's noise is
one kernel launch on the card.  A noisy run's manifest records JAX's
keying, :data:`NOISE_KEYING`, so a run resumes across devices and across
the two packages.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from color_modem_tpu_torch.standards.decoders import temporal_comb_spacing
from color_modem_tpu_torch.frame import rf as rf_mod
from color_modem_tpu_torch.frame import satellite as sat_mod
from color_modem_tpu_torch.frame.channel import impair, vhs_playback
from color_modem_tpu_torch.frame.equalize import (
    apply_equalizer,
    design_equalizer,
    gcr_record,
    ntaps_for_delay,
)
from color_modem_tpu_torch.dsp.nco import frame_indices
from color_modem_tpu_torch.frame.interlace import field_line_index, make_interlaced_pipeline
from color_modem_tpu_torch.frame.nr import temporal_nr
from color_modem_tpu_torch.frame.pipeline import (
    Plan,
    frame_line_index,
    make_pipeline,
    resolve_device,
)
from color_modem_tpu_torch.frame.scramble import MODES as SCRAMBLE_MODES
from color_modem_tpu_torch.frame.scramble import descramble as descramble_block
from color_modem_tpu_torch.frame.scramble import scramble as scramble_block
from color_modem_tpu_torch.frame.vbi import cc_spec, decode_data_line, encode_data_line
from color_modem_tpu_torch.parallel.mesh import (
    FRAME_AXIS,
    gather_blocks,
    line_block,
    local_block,
)
from color_modem_tpu_torch.parallel.sharded import (
    hop_stage,
    make_sharded_interlaced_pipeline,
    make_sharded_pipeline,
    sound_from_rf_ring,
)
from color_modem_tpu_torch.utils.manifest import ChunkManifest
from color_modem_tpu_torch.utils import prng
from color_modem_tpu_torch.utils.metrics import fingerprint, fingerprint_hex
from color_modem_tpu_torch.utils.tracing import span
from color_modem_tpu_torch.utils.upload import upload

#: (start, count) -> (count, 3, L, N) frames, a NumPy array or a tensor
FrameSource = Callable[[int, int], object]

#: the keying of the runner's noise that a noisy run's manifest records,
#: the JAX runner's: per absolute frame (field) index, by ``fold_in``
NOISE_KEYING = "abs-frame"
#: the runner's base keys, the JAX runner's: channel noise, satellite noise,
#: the noisy GCR record
CHANNEL_NOISE_KEY = prng.PRNGKey(0)
SAT_NOISE_KEY = prng.PRNGKey(0x5A7)
GCR_NOISE_KEY = prng.PRNGKey(1)


def synthetic_source(lines: int, samples: int) -> FrameSource:
    """Deterministic per-frame synthetic scenes, made on the host."""
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    def src(start: int, count: int) -> np.ndarray:
        return np.stack(
            [smooth_scene(lines, samples, seed=start + i) for i in range(count)],
            dtype=np.float32,
        )

    return src


def synthetic_device_source(lines: int, samples: int, seed: int = 0,
                            device: torch.device | str = "cuda") -> FrameSource:
    """Synthetic frames made on ``device``: one base scene uploads once, and
    frame ``g`` is the scene rolled by ``(g*37) % samples`` samples, times
    ``0.85 + 0.1*cos(0.37 g)`` (float32), plus 0.05, clipped to [0, 1];
    keyed on the absolute frame index, so a resume reproduces it."""
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    device = resolve_device(device)
    state = {}

    def src(start: int, count: int) -> torch.Tensor:
        if "base" not in state:
            state["base"] = torch.tensor(smooth_scene(lines, samples, seed=seed),
                                         dtype=torch.float32, device=device)
        base = state["base"]
        rolled = torch.stack([torch.roll(base, (g * 37) % samples, dims=-1)
                              for g in range(start, start + count)])
        g = torch.arange(start, start + count, dtype=torch.float32, device=device)
        gain = 0.85 + 0.1 * torch.cos(0.37 * g)
        return torch.clamp(rolled * gain[:, None, None, None] + 0.05, 0.0, 1.0)

    return src


def _sound_track(rf_audio, n_frames: int, snd_dev: float, fs: float):
    """The soundtrack as ``(n_frames, item)`` float32 blocks and each
    frame's starting deviation phase: the float64 prefix sum of the whole
    track, reduced mod 2 pi, so any chunking continues one phase law."""
    aud = np.asarray(rf_audio, np.float64).reshape(-1)
    if aud.size % n_frames:
        raise ValueError(f"rf_audio length {aud.size} is not a whole number of "
                         f"per-frame blocks for {n_frames} frames")
    blocks = aud.reshape(n_frames, aud.size // n_frames)
    pref = np.concatenate([[0.0], np.cumsum((2.0 * np.pi * snd_dev / fs) * blocks.sum(axis=1))])
    return blocks.astype(np.float32), np.mod(pref, 2.0 * np.pi)


def process_video(
    plan: Plan,
    source: FrameSource,
    n_frames: int,
    out_dir: str,
    *,
    decoder: str = "notch",
    chunk: int = 8,
    mesh=None,
    backend: str = "kernel",
    device: torch.device | str = "cuda",
    save_outputs: bool = False,
    resume: bool = True,
    lines: int | None = None,
    channel: dict | None = None,
    interlaced: bool = False,
    nr: bool = False,
    nr_sigma: float | None = None,
    rf: bool = False,
    rf_audio: np.ndarray | None = None,
    rf_audio_bw: float = 15e3,
    satellite: bool = False,
    sat_cnr: float | None = None,
    caption_bits: np.ndarray | None = None,
    scramble: tuple[str, int] | None = None,
) -> dict:
    """Round-trip ``n_frames`` frames in chunks on ``device``; returns the
    run summary.

    ``lines`` (frame height) goes into the manifest config, so a re-run at
    another height refuses to mix with old chunks; by default it is read
    off the source's first frame.  ``channel``: the keyword arguments of
    ``frame/channel.py::impair`` (noise_sigma, chroma_gain, ...) applied
    between encode and decode, plus ``"vhs": True`` for the VHS playback
    signature.  ``interlaced``: each frame goes as two 2:1 fields
    (``frame/interlace.py``); 'comb3d' combs same-parity fields.  ``nr``:
    temporal noise reduction on the decoded frames, gated by ``nr_sigma``,
    else the channel's ``noise_sigma``, else the lower-quartile estimator.
    ``save_outputs`` writes each chunk's frames to ``rgb_<start>.npy``.
    ``rf``: the composite rides the VSB picture hop, keyed on the absolute
    leading-axis index.  ``rf_audio``: a soundtrack (n_frames * item
    samples at the composite rate, in [-1, 1]) on the RF hop's FM sound
    carrier, needs ``rf``; each chunk's frames are one joined broadcast
    stream, the deviation phase continued across chunks from the track's
    float64 prefix, and the received audio of the chunk's own frames goes
    to ``aud_<start>.npy``.  ``rf_audio_bw`` widens the sound channel (50e3
    for an MTS multiplex).  ``satellite``: the FM hop instead,
    with channel noise at ``sat_cnr`` dB when given (both together raise
    ``ValueError``).  ``channel={"equalize": True, ...}``: a GCR record
    goes through the same channel (noisy with its own fixed realisation)
    and the equalizer designed from it is applied after the composite
    impairments.

    The temporal comb and NR fetch true neighbour frames across chunk
    boundaries (``pt`` frames per side for the comb, one more for NR), and
    a short tail chunk is padded with repeats of its last frame (with
    silence on the sound carrier); PSNR and fingerprint cover only the
    chunk's own frames, and a soundtrack takes one frame of overlap per
    side, which hides the sound filters' warm-up at chunk edges.
    ``caption_bits``: an (n_frames, 16) 0/1 array, frame i's caption cell
    (``cc_pack``); ``scramble``: ``(mode, key)``, one of ``cutrotate``,
    ``linedelay`` and ``shuffle`` (which needs the transmitted line count
    divisible by 32), refused together with ``channel={"equalize": True}``
    (the equalizer needs the stream continuity the scrambler destroys).
    ``mesh``: a rank mesh (``parallel/mesh.py::make_mesh``); every rank of
    it makes the same call and computes on the mesh's device, which
    ``device`` must name (``"cuda"`` stands for any card; another device
    raises ``ValueError``).  Each rank reads its
    own frames of every chunk (rank 0 the whole chunk: the reference of
    the metrics it computes) and encodes and decodes its (frame, lineblk)
    block (``parallel/sharded.py``).  The data services, the hop and the
    channel act on whole frames: the line ring gathers its blocks and
    spreads the frames over its members (``sharded.py::hop_stage``), so
    each rank transmits its share of the chunk, and a soundtrack's
    receiver takes one item of RF from each neighbour around the rank ring
    (``sharded.py::sound_from_rf_ring``).  A chunk takes in true neighbour
    frames up to a multiple of the frame axis (of the rank count when
    frames are transmitted), with ``2 * temporal_comb_spacing`` frames per
    frame block for the temporal combs.  Rank 0 gathers the decoded frames,
    the received audio and the caption cells, applies NR, writes the
    outputs, the manifest and the summary and returns the summary; the
    other ranks write nothing and return None.  The manifest records the
    mesh, so a run resumed with another mesh is refused.
    """
    with span("cm.video.setup"):
        want_sound = rf_audio is not None
        if want_sound and not rf:
            raise ValueError("rf_audio rides the RF sound carrier — pass rf=True")
        if satellite and rf:
            raise ValueError(
                "satellite (FM) and rf (VSB-AM) are different transmission "
                "layers; pick one"
            )
        if scramble is not None:
            if scramble[0] not in SCRAMBLE_MODES:
                raise ValueError(f"scramble mode must be one of {SCRAMBLE_MODES}, "
                                 f"got {scramble[0]!r}")
            if channel and channel.get("equalize"):
                raise ValueError("scramble breaks the stream continuity the GCR equalizer "
                                 "needs; descramble before equalizing instead")
        if mesh is None:
            device = resolve_device(device)
        else:
            want = torch.device(device)
            if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
                raise ValueError(f"device {want} is not the mesh's device {mesh.device}: "
                                 "every rank computes on its mesh's device")
            device = mesh.device
        # with a mesh, rank 0 alone writes; every rank reads the manifest here,
        # before rank 0 can mark a chunk (its first mark follows a gather)
        rank0 = mesh is None or dist.get_rank() == 0
        if rank0:
            os.makedirs(out_dir, exist_ok=True)
        manifest = ChunkManifest(out_dir) if resume else None
        if lines is None:
            lines = int(source(0, 1).shape[2])
        noisy = bool(channel) and float(channel.get("noise_sigma", 0.0) or 0.0) > 0.0
        config = {
            "standard": plan.cfg.name,
            "decoder": decoder,
            "samples": plan.n_samples,
            "lines": lines,
            "chunk": chunk,
            "backend": backend,
            "channel": channel,
            "interlaced": interlaced,
            # sparse keys: an always-present new key would refuse every older
            # manifest; the sigma is part of the config, since resuming with
            # another gate threshold would mix denoise levels
            **({"nr": True, "nr_sigma": nr_sigma} if nr else {}),
            # as the JAX runner: where channel noise is drawn
            **({"noise_keying": NOISE_KEYING} if noisy else {}),
            **({"scramble": scramble[0], "scramble_key": scramble[1]} if scramble else {}),
            **({"rf": True} if rf else {}),
            **({"rf_audio": True} if want_sound else {}),
            **({"rf_audio_bw": rf_audio_bw} if rf_audio_bw != 15e3 else {}),
            **({"satellite": True, "sat_cnr": sat_cnr} if satellite else {}),
            **({"caption": True} if caption_bits is not None else {}),
            "mesh": mesh.shape if mesh is not None else None,
        }
        if manifest:
            manifest.check_config(config)

        if mesh is None:
            make = make_interlaced_pipeline if interlaced else make_pipeline
            enc_f, dec_f, rt_f = make(plan, decoder, backend, device)
        else:
            make = make_sharded_interlaced_pipeline if interlaced else make_sharded_pipeline
            enc_f, dec_f, rt_f = make(plan, mesh, decoder, backend)

        # interlaced encode puts fields (2 per frame) on the leading axis
        units = 2 if interlaced else 1

        def _lines(comp: torch.Tensor, frame0: int) -> torch.Tensor:
            """The transmitted blocks' absolute line indices (field-sequential
            when interlaced): the keying of the scrambler."""
            if interlaced:
                return field_line_index(plan, frame0, comp.shape[0] // 2, comp.shape[-2], device)
            return frame_line_index(plan, frame0, comp.shape[0], comp.shape[-2], device)

        cap_spec = None
        if caption_bits is not None:
            cap_spec = cc_spec(plan)
            cap_bits = upload(caption_bits, device, np.int64)

        hop = None
        if rf:
            rfp = rf_mod.make_rf_plan(plan, audio_bw=rf_audio_bw)

            def hop(comp, frame0, aud=None):
                # the carrier's row law keys on the absolute leading-axis index
                g0 = frame0 * units
                rf_sig = rf_mod.rf_modulate(rfp, comp, g0)
                aud_rx = None
                if aud is not None:
                    # the chunk's frames (fields when interlaced: consecutive
                    # halves of each frame's block) are one broadcast stream,
                    # over the rank ring's order with a mesh
                    aud = aud.reshape(rf_sig.shape[0], -1)
                    phi0 = float(phi0_all[min(frame0, n_frames)])
                    rf_sig = rf_mod.sound_on_rf(rfp, rf_sig, g0, aud, phi0)
                    aud_rx = (rf_mod.sound_from_rf(rfp, rf_sig, g0) if mesh is None
                              else sound_from_rf_ring(mesh, rfp, rf_sig, g0))
                return rf_mod.rf_demodulate(rfp, rf_sig, g0), aud_rx

        elif satellite:
            sp = sat_mod.make_sat_plan(plan.fs, plan.n_samples)
            sat_sigma = sat_mod.noise_sigma(sp, sat_cnr) if sat_cnr is not None else 0.0

            def hop(comp, frame0, aud=None):
                # frame-local by design (per-frame circular FM); the noise keys
                # on each item's absolute leading-axis index
                rf_sig = sat_mod.fm_modulate(sp, comp)
                if sat_sigma:
                    rf_sig = prng.add_normal(rf_sig, sat_sigma, SAT_NOISE_KEY, frame0 * units)
                return sat_mod.fm_demodulate(sp, rf_sig), None

        chan_noise_sigma = 0.0
        _channel = None
        if channel:
            channel = dict(channel)
            equalize = bool(channel.pop("equalize", False))
            vhs = bool(channel.pop("vhs", False))
            chan_noise_sigma = float(channel.pop("noise_sigma", 0.0) or 0.0)
            if equalize:
                gcr = torch.tensor(gcr_record(plan)[None], device=device)
                eq_ntaps = ntaps_for_delay(plan, float(channel.get("ghost_delay_us", 0.0)))

            def _channel(comp: torch.Tensor, frame0: int) -> torch.Tensor:  # noqa: F811
                comp = impair(plan, comp, **channel)
                if chan_noise_sigma > 0.0:
                    comp = prng.add_normal(comp, chan_noise_sigma, CHANNEL_NOISE_KEY,
                                           frame0 * units)
                if vhs:
                    comp = vhs_playback(plan, comp)
                if equalize:
                    rx = impair(plan, gcr, **channel)[0]
                    if chan_noise_sigma > 0.0:
                        # the record's own fixed realisation: the designed taps
                        # do not depend on the chunk
                        rx = prng.add_normal(rx, chan_noise_sigma, GCR_NOISE_KEY)
                    comp = apply_equalizer(comp, design_equalizer(plan, rx, ntaps=eq_ntaps))
                return comp

        direct = hop is None and _channel is None and cap_spec is None and scramble is None

        def link(comp: torch.Tensor, frame0: int, aud=None) -> tuple:
            """The transmission between encoder and decoder, on whole frames
            (fields when interlaced) from ``frame0`` on: the caption cell on
            row 0 of each frame (of each frame's first field), keyed by the
            absolute frame index, the scrambler over the finished composite,
            the hop, the composite channel (the receiver side), then the
            subscriber's keyed descrambler (the services descramble
            bit-exactly) and the data slicer.  Returns the received composite as
            the decoder sees it, the received audio and the caption cells
            (float32), each None where there is none."""
            if cap_spec is not None:
                idx = torch.clamp(frame_indices(frame0, comp.shape[0] // units, device), 0,
                                  cap_bits.shape[0] - 1).to(torch.int64)
                comp[::units, 0, :] = encode_data_line(plan, cap_spec, cap_bits[idx])
            if scramble is not None:
                comp = scramble_block(plan, comp, _lines(comp, frame0), *scramble)
            aud_rx = None
            if hop is not None:
                with span("cm.hop"):
                    comp, aud_rx = hop(comp, frame0, aud)
            if _channel is not None:
                comp = _channel(comp, frame0)
            if scramble is not None:
                comp = descramble_block(plan, comp, _lines(comp, frame0), *scramble)
            cells = None
            if cap_spec is not None:
                cells = decode_data_line(plan, cap_spec, comp[::units, 0, :])[0].to(torch.float32)
            return comp, aud_rx, cells

        def _link_stage(comp, *args):
            """:func:`link` as ``sharded.hop_stage`` calls a hop."""
            return link(comp, args[-1], *args[:-1])

        def _to_rank0(t):
            return None if t is None else gather_blocks(mesh, t, "frames")

        def roundtrip(rgb, frame0, aud=None) -> tuple:
            """(decoded frames, received audio, caption cells).  With a mesh,
            ``rgb`` and ``aud`` are this rank's blocks and the results arrive
            on rank 0 (None on the others)."""
            if mesh is None:
                if direct:
                    return rt_f(rgb, frame0), None, None
                comp, aud_rx, cells = link(enc_f(rgb, frame0), frame0, aud)
                return dec_f(comp, frame0), aud_rx, cells
            if direct:
                return gather_blocks(mesh, rt_f(rgb, frame0)), None, None
            streams = () if aud is None else (aud,)
            comp, aud_rx, cells = hop_stage(mesh, enc_f(rgb, frame0), frame0, _link_stage,
                                            *streams, units=units)
            out = gather_blocks(mesh, dec_f(line_block(mesh, comp), frame0))
            return out, _to_rank0(aud_rx), _to_rank0(cells)

        if nr and nr_sigma is None and chan_noise_sigma > 0.0:
            nr_sigma = chan_noise_sigma

        min_frames, overlap, per_rank = 1, 0, 1
        frame_axis = mesh.size(FRAME_AXIS) if mesh is not None else 1
        # the link spreads whole frames over every rank, one share each
        multiple = mesh.n_ranks if mesh is not None and not direct else frame_axis
        if decoder in ("comb3d", "comb3dA"):
            # true temporal neighbours at chunk edges: `pt` extra frames per side
            pt = temporal_comb_spacing(plan.cfg) or 1
            min_frames, overlap, per_rank = 2 * pt, pt, 2 * pt
        if nr:
            # the 3-frame stencil needs >= 2 frames and its true neighbours,
            # decoded from THEIR true neighbours: one frame per side on top of
            # the temporal comb's (the JAX runner takes max(pt, 1) here, which
            # leaves comb3d + NR output chunk-size dependent)
            min_frames, overlap = max(min_frames, 2), overlap + 1
        if want_sound:
            # the sound filters (the 8193-tap audio low-pass) warm up over ~6
            # lines: one frame of overlap hides the chunk-edge transients
            overlap = max(overlap, 1)
            aud_frames, phi0_all = _sound_track(rf_audio, n_frames, rfp.snd_dev, plan.fs)
            aud_item = aud_frames.shape[1]

            def _chunk_sound(lo: int, b: int) -> torch.Tensor:
                """The soundtrack of frames lo .. lo + b on the device (silence
                past the end), copied to the card without synchronising it."""
                idx = np.arange(lo, lo + b)
                blk = aud_frames[np.clip(idx, 0, n_frames - 1)]
                blk[idx >= n_frames] = 0.0
                return upload(blk, device)

        def _input(x) -> torch.Tensor:
            if isinstance(x, torch.Tensor):
                return x.to(device=device, dtype=torch.float32)
            # a copy of its own: the source may hand out read-only or shared memory
            return upload(x, device, np.float32)

        def _target(b: int) -> int:
            """Frames a chunk of ``b`` frames goes through the pipeline as: at
            least ``min_frames``, ``per_rank`` frames on each rank of the frame
            axis, and a multiple of ``multiple``."""
            t = max(b, min_frames, frame_axis * per_rank)
            return t + -t % multiple

        def _widen(lo: int, hi: int) -> tuple[int, int]:
            """With a mesh, the frames the mesh needs beyond the chunk and its
            overlap are true frames, earlier ones first: they lie beyond the
            stencils' reach from the chunk's own frames, so the output matches
            the unsharded run's (repeats only for a video shorter than that)."""
            need = _target(hi - lo) - (hi - lo)
            k = min(need, lo)
            return lo - k, min(n_frames, hi + need - k)

        def _read(first: int, count: int, end: int) -> torch.Tensor:
            """Frames ``first .. first + count`` of a chunk that ends at ``end``,
            on the device; those past ``end`` repeat its last frame (a short
            tail chunk's padding)."""
            have = max(0, min(count, end - first))
            x = _input(source(min(first, end - 1), max(have, 1)))
            if have == count:
                return x
            return torch.cat([x[:have], x[-1:].expand(count - have, *x.shape[1:])])

        @torch.inference_mode()
        def step(blk: torch.Tensor, rgb, frame0: int, off: int, n_real: int, skip: int,
                 aud=None):
            """Round trip (+ NR) of ``blk`` (with a mesh, this rank's block of
            the chunk ``rgb``), then PSNR and fingerprint over the chunk's own
            frames, on the device: no host sync.  The fingerprint leaves out the
            first ``skip`` frames (those a mesh run took in before the unsharded
            run's first), so the own frames sit where the unsharded run has
            them.  Returns the frames, the metrics, the received audio (an empty
            tensor without sound) and the decoded caption bits (None without
            captions); None on a rank other than 0 of a mesh."""
            out, aud_rx, cc = roundtrip(blk, frame0, aud)
            if out is None:
                return None
            if nr:
                out = temporal_nr(out, nr_sigma)
            e = torch.arange(out.shape[0], device=device)
            mask = ((e >= off) & (e < off + n_real)).to(torch.float32)
            pic, ref = out, rgb
            if cap_spec is not None:
                # row 0 carries data, not picture
                pic, ref = out[:, :, 1:, :], rgb[:, :, 1:, :]
            err = ((pic - ref) ** 2).mean(dim=(1, 2, 3))
            mse = (err * mask).sum() / float(max(n_real, 1))
            q = 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-20))
            metrics = torch.cat([q.reshape(1),
                                 fingerprint((pic * mask[:, None, None, None])[skip:])])
            if aud_rx is None:
                aud_rx = metrics.new_zeros(0)
            if cc is not None:
                cc = cc.reshape(-1)
            return out, metrics, aud_rx.reshape(-1), cc

        t_start = time.perf_counter()
        pixels = 0
        frames_done = 0
        psnrs = []

        def _resolve(pending) -> None:
            """One stacked device->host fetch of the wave's metrics, received
            audio and caption bits, then the saved frames, the audio and caption
            files and the manifest."""
            nonlocal frames_done
            with span("cm.video.fetch"):
                metrics = torch.stack([p[4] for p in pending])
                flat = torch.cat([metrics.reshape(-1)] + [p[5] for p in pending]
                                 + [p[6] for p in pending if p[6] is not None]).cpu().numpy()
            with span("cm.video.record"):
                vals = flat[: metrics.numel()].reshape(metrics.shape)
                aud_at = metrics.numel()
                cc_at = aud_at + sum(p[5].numel() for p in pending)
                for (start, end, off, out, _, aud_rx, cc), v in zip(pending, vals):
                    q = float(v[0])
                    psnrs.append(q)
                    frames_done += end - start
                    if out is not None:
                        np.save(os.path.join(out_dir, f"rgb_{start:06d}.npy"),
                                out[off : off + (end - start)].cpu().numpy())
                    if want_sound:
                        a0 = aud_at + off * aud_item
                        np.save(os.path.join(out_dir, f"aud_{start:06d}.npy"),
                                flat[a0 : a0 + (end - start) * aud_item])
                        aud_at += aud_rx.numel()
                    if cap_spec is not None:
                        cells = flat[cc_at : cc_at + cc.numel()].reshape(-1, cap_spec.n_bits)
                        np.save(os.path.join(out_dir, f"cc_{start:06d}.npy"),
                                cells[off : off + (end - start)].astype(np.int32))
                        cc_at += cc.numel()
                    if manifest:
                        manifest.mark_done(start, end, fp=fingerprint_hex(v[1:]), psnr=round(q, 2))

        # saving keeps each wave's decoded frames alive: keep those waves short
        wave = 2 if save_outputs else 16
        pending = []
    for start in range(0, n_frames, chunk):
        end = min(start + chunk, n_frames)
        if manifest and manifest.is_done(start, end):
            continue
        lo_u = lo = max(0, start - overlap)
        hi = min(n_frames, end + overlap)
        if mesh is not None:
            lo, hi = _widen(lo, hi)
        first, count = lo, _target(hi - lo)
        with span("cm.video.read"):
            rgb = _read(lo, count, hi) if rank0 else None
            blk = rgb
            if mesh is not None:
                count //= frame_axis
                first += mesh.index(FRAME_AXIS) * count
                blk = local_block(mesh, rgb, "rgb") if rank0 else \
                    line_block(mesh, _read(first, count, hi))
            sound = (_chunk_sound(first, count),) if want_sound else ()
        with span("cm.video.step"):
            res = step(blk, rgb, lo, start - lo, end - start, lo_u - lo, *sound)
        if res is None:
            continue
        pixels += (end - start) * rgb.shape[2] * rgb.shape[3]
        out, metrics, aud_rx, cc = res
        pending.append((start, end, start - lo, out if save_outputs else None, metrics,
                        aud_rx, cc))
        if len(pending) >= wave:
            _resolve(pending)
            pending = []
    if pending:
        _resolve(pending)
    with span("cm.video.summary"):
        wall = time.perf_counter() - t_start
        if not rank0:
            # return once rank 0 has written the run: a next call on this
            # directory reads its manifest
            dist.barrier()
            return None

        summary = {
            **config,
            "n_frames": n_frames,
            "frames_processed_this_run": frames_done,
            "mpix_per_s": round(pixels / wall / 1e6, 3) if pixels else 0.0,
            "min_psnr_db": round(min(psnrs), 2) if psnrs else None,
            "seconds": round(wall, 2),
        }
        results_dir = os.path.join(out_dir, "results")
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, f"run_{time.time_ns()}.json"), "w") as f:
            json.dump(summary, f, indent=1)
        if mesh is not None:
            dist.barrier()
        return summary
