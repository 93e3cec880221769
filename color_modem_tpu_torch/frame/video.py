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

Noise is keyed on the absolute leading-axis index (frames, or fields when
interlaced): each index draws from its own ``torch.Generator``, so chunk
size and resume points cannot change the realisation.  Three seed
families never meet: the channel noise seeds with the index itself, the
satellite noise with :data:`SAT_NOISE_SEED` plus the index, and the noisy
GCR record with the fixed :data:`GCR_NOISE_SEED`.  The realisation differs
from the JAX package's PRNG, and between devices (a CUDA generator is
Philox, a CPU one mt19937), and the manifest says so (``noise_keying``
names the device type), so no noisy run resumes on another package or
device type.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

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
from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline
from color_modem_tpu_torch.frame.nr import temporal_nr
from color_modem_tpu_torch.frame.pipeline import Plan, make_pipeline, resolve_device
from color_modem_tpu_torch.utils.manifest import ChunkManifest
from color_modem_tpu_torch.utils.metrics import fingerprint, fingerprint_hex

#: (start, count) -> (count, 3, L, N) frames, a NumPy array or a tensor
FrameSource = Callable[[int, int], object]

#: Seed families of the runner's noise, disjoint in the low 32 bits (all a
#: CPU generator keeps): the channel noise seeds with the absolute index
#: itself, the satellite noise with SAT_NOISE_SEED plus it, the noisy GCR
#: record with GCR_NOISE_SEED; indices stay below 2^30.
SAT_NOISE_SEED = 1 << 30
GCR_NOISE_SEED = 1 << 31
_INDEX_LIMIT = 1 << 30


def _index(first: int, count: int) -> int:
    """``first``, after checking that ``first .. first + count`` stays in
    its seed family."""
    if first + count > _INDEX_LIMIT:
        raise ValueError(f"noise index {first + count} beyond 2^30: the seed families "
                         "would meet")
    return first


def _unit_noise(shape, seeds, device: torch.device) -> torch.Tensor:
    """(len(seeds), *shape) float32 unit normal noise, one generator per
    seed."""
    return torch.stack([
        torch.randn(shape, dtype=torch.float32, device=device,
                    generator=torch.Generator(device=device).manual_seed(s))
        for s in seeds
    ])


def noise_keying(device: torch.device) -> str:
    """The channel-noise keying recorded in the manifest of a noisy run on
    ``device``: ``"abs-frame-torch-cuda"`` or ``"abs-frame-torch-cpu"`` (the
    same seed draws other numbers on each device type; the JAX package
    records "abs-frame" for its own PRNG)."""
    return f"abs-frame-torch-{torch.device(device).type}"


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


def _refuse_unported(mesh, caption_bits, scramble) -> None:
    """The JAX runner's options whose modules the port lacks yet, each with
    the ROADMAP queue 1 item that ports it."""
    asked = {
        "mesh": (mesh is not None, "10 (parallel layer)"),
        "caption_bits": (caption_bits is not None, "9 (data services)"),
        "scramble": (scramble is not None, "9 (data services)"),
    }
    for name, (on, item) in asked.items():
        if on:
            raise NotImplementedError(
                f"process_video {name} is not ported yet: ROADMAP queue 1 item {item}"
            )


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
    side, which hides the sound filters' warm-up at chunk edges.  ``mesh``,
    ``caption_bits`` and ``scramble`` raise ``NotImplementedError``: their
    modules are not ported yet.
    """
    _refuse_unported(mesh, caption_bits, scramble)
    want_sound = rf_audio is not None
    if want_sound and not rf:
        raise ValueError("rf_audio rides the RF sound carrier — pass rf=True")
    if satellite and rf:
        raise ValueError(
            "satellite (FM) and rf (VSB-AM) are different transmission "
            "layers; pick one"
        )
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    manifest = ChunkManifest(out_dir) if resume else None
    if lines is None:
        lines = int(source(0, 1).shape[2])
    noisy = ((bool(channel) and float(channel.get("noise_sigma", 0.0) or 0.0) > 0.0)
             or (satellite and sat_cnr is not None))
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
        **({"noise_keying": noise_keying(device)} if noisy else {}),
        **({"rf": True} if rf else {}),
        **({"rf_audio": True} if want_sound else {}),
        **({"rf_audio_bw": rf_audio_bw} if rf_audio_bw != 15e3 else {}),
        **({"satellite": True, "sat_cnr": sat_cnr} if satellite else {}),
        "mesh": None,
    }
    if manifest:
        manifest.check_config(config)

    make = make_interlaced_pipeline if interlaced else make_pipeline
    enc_f, dec_f, roundtrip = make(plan, decoder, backend, device)

    # interlaced encode puts fields (2 per frame) on the leading axis
    units = 2 if interlaced else 1
    hop = None
    if rf:
        rfp = rf_mod.make_rf_plan(plan, audio_bw=rf_audio_bw)

        def hop(comp, frame0, aud=None, phi0=0.0):
            # the carrier's row law keys on the absolute leading-axis index
            g0 = frame0 * units
            rf_sig = rf_mod.rf_modulate(rfp, comp, g0)
            aud_rx = None
            if aud is not None:
                # the chunk's frames (fields when interlaced: consecutive
                # halves of each frame's block) are one broadcast stream
                aud = aud.reshape(rf_sig.shape[0], -1)
                rf_sig = rf_mod.sound_on_rf(rfp, rf_sig, g0, aud, phi0)
                aud_rx = rf_mod.sound_from_rf(rfp, rf_sig, g0)
            return rf_mod.rf_demodulate(rfp, rf_sig, g0), aud_rx

    elif satellite:
        sp = sat_mod.make_sat_plan(plan.fs, plan.n_samples)
        sat_sigma = sat_mod.noise_sigma(sp, sat_cnr) if sat_cnr is not None else 0.0

        def hop(comp, frame0, aud=None, phi0=0.0):
            # frame-local by design (per-frame circular FM); the noise keys
            # on each item's absolute leading-axis index
            rf_sig = sat_mod.fm_modulate(sp, comp)
            if sat_sigma:
                g0 = SAT_NOISE_SEED + _index(frame0 * units, comp.shape[0])
                seeds = range(g0, g0 + comp.shape[0])
                rf_sig = rf_sig + sat_sigma * _unit_noise(rf_sig.shape[1:], seeds, device)
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
                first = _index(frame0 * units, comp.shape[0])
                comp = comp + chan_noise_sigma * _unit_noise(
                    comp.shape[1:], range(first, first + comp.shape[0]), device)
            if vhs:
                comp = vhs_playback(plan, comp)
            if equalize:
                rx = impair(plan, gcr, **channel)[0]
                if chan_noise_sigma > 0.0:
                    # the record's own fixed realisation: the designed taps
                    # do not depend on the chunk
                    rx = rx + chan_noise_sigma * _unit_noise(rx.shape, [GCR_NOISE_SEED],
                                                             device)[0]
                comp = apply_equalizer(comp, design_equalizer(plan, rx, ntaps=eq_ntaps))
            return comp

    lib_roundtrip = roundtrip

    def roundtrip(rgb, frame0, aud=None, phi0=0.0):  # noqa: F811 — the hop and channel
        if hop is None and _channel is None:
            return lib_roundtrip(rgb, frame0), None
        comp = enc_f(rgb, frame0)
        aud_rx = None
        if hop is not None:
            # the transmission hop first; the composite impairments model the
            # receiver side
            comp, aud_rx = hop(comp, frame0, aud, phi0)
        if _channel is not None:
            comp = _channel(comp, frame0)
        return dec_f(comp, frame0), aud_rx

    if nr and nr_sigma is None and chan_noise_sigma > 0.0:
        nr_sigma = chan_noise_sigma

    min_frames, overlap = 1, 0
    if decoder in ("comb3d", "comb3dA"):
        # true temporal neighbours at chunk edges: `pt` extra frames per side
        pt = temporal_comb_spacing(plan.cfg) or 1
        min_frames, overlap = 2 * pt, pt
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

        def _chunk_sound(lo: int, b: int) -> tuple:
            """The soundtrack of frames lo .. lo + b on the device (silence
            past the end), staged through pinned memory so the copy does not
            block the host, and the deviation phase before frame lo."""
            idx = np.arange(lo, lo + b)
            blk = aud_frames[np.clip(idx, 0, n_frames - 1)]
            blk[idx >= n_frames] = 0.0
            host = torch.from_numpy(blk)
            if device.type == "cuda":
                host = host.pin_memory()
            return host.to(device, non_blocking=True), float(phi0_all[lo])

    def _input(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    def _pad_frames(rgb: torch.Tensor) -> torch.Tensor:
        b = rgb.shape[0]
        if b >= min_frames:
            return rgb
        return torch.cat([rgb, rgb[-1:].expand(min_frames - b, *rgb.shape[1:])])

    @torch.inference_mode()
    def step(rgb: torch.Tensor, frame0: int, off: int, n_real: int, aud=None, phi0=0.0):
        """Round trip (+ NR), then PSNR and fingerprint over the chunk's own
        frames, on the device: no host sync.  Returns the frames, the
        metrics and the received audio (an empty tensor without sound)."""
        out, aud_rx = roundtrip(rgb, frame0, aud, phi0)
        if nr:
            out = temporal_nr(out, nr_sigma)
        e = torch.arange(out.shape[0], device=device)
        mask = ((e >= off) & (e < off + n_real)).to(torch.float32)
        err = ((out - rgb) ** 2).mean(dim=(1, 2, 3))
        mse = (err * mask).sum() / float(max(n_real, 1))
        q = 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-20))
        metrics = torch.cat([q.reshape(1), fingerprint(out * mask[:, None, None, None])])
        if aud_rx is None:
            aud_rx = metrics.new_zeros(0)
        return out, metrics, aud_rx.reshape(-1)

    t_start = time.perf_counter()
    pixels = 0
    frames_done = 0
    psnrs = []

    def _resolve(pending) -> None:
        """One stacked device->host fetch of the wave's metrics and received
        audio, then the saved frames, the audio files and the manifest."""
        nonlocal frames_done
        metrics = torch.stack([p[4] for p in pending])
        flat = torch.cat([metrics.reshape(-1)] + [p[5] for p in pending]).cpu().numpy()
        vals = flat[: metrics.numel()].reshape(metrics.shape)
        aud_at = metrics.numel()
        for (start, end, off, out, _, aud_rx), v in zip(pending, vals):
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
            if manifest:
                manifest.mark_done(start, end, fp=fingerprint_hex(v[1:]), psnr=round(q, 2))

    # saving keeps each wave's decoded frames alive: keep those waves short
    wave = 2 if save_outputs else 16
    pending = []
    for start in range(0, n_frames, chunk):
        end = min(start + chunk, n_frames)
        if manifest and manifest.is_done(start, end):
            continue
        lo, hi = max(0, start - overlap), min(n_frames, end + overlap)
        rgb = _pad_frames(_input(source(lo, hi - lo)))
        pixels += (end - start) * rgb.shape[2] * rgb.shape[3]
        sound = _chunk_sound(lo, rgb.shape[0]) if want_sound else ()
        out, metrics, aud_rx = step(rgb, lo, start - lo, end - start, *sound)
        pending.append((start, end, start - lo, out if save_outputs else None, metrics,
                        aud_rx))
        if len(pending) >= wave:
            _resolve(pending)
            pending = []
    if pending:
        _resolve(pending)
    wall = time.perf_counter() - t_start

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
    return summary
