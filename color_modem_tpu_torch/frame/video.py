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

Channel noise is keyed on the absolute leading-axis index (frames, or
fields when interlaced): each index draws from its own
``torch.Generator`` seeded with that index, so chunk size and resume
points cannot change the realisation.  The realisation differs from the
JAX package's PRNG, and between devices (a CUDA generator is Philox, a CPU
one mt19937), and the manifest says so (``noise_keying`` names the device
type), so no noisy run resumes on another package or device type.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

import numpy as np
import torch

from color_modem_tpu_torch.standards.decoders import temporal_comb_spacing
from color_modem_tpu_torch.frame.channel import impair, vhs_playback
from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline
from color_modem_tpu_torch.frame.nr import temporal_nr
from color_modem_tpu_torch.frame.pipeline import Plan, make_pipeline, resolve_device
from color_modem_tpu_torch.utils.manifest import ChunkManifest
from color_modem_tpu_torch.utils.metrics import fingerprint, fingerprint_hex

#: (start, count) -> (count, 3, L, N) frames, a NumPy array or a tensor
FrameSource = Callable[[int, int], object]


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


def _refuse_unported(mesh, channel, rf, rf_audio, rf_audio_bw, satellite, sat_cnr,
                     caption_bits, scramble) -> None:
    """The JAX runner's options whose modules the port lacks yet, each with
    the ROADMAP queue 1 item that ports it."""
    asked = {
        "mesh": (mesh is not None, "10 (parallel layer)"),
        "rf": (rf, "7 (transmission hops; its sound is item 8)"),
        "rf_audio": (rf_audio is not None, "8 (sound)"),
        "rf_audio_bw": (rf_audio_bw != 15e3, "8 (sound)"),
        "satellite": (satellite, "7 (transmission hops)"),
        "sat_cnr": (sat_cnr is not None, "7 (transmission hops)"),
        "caption_bits": (caption_bits is not None, "9 (data services)"),
        "scramble": (scramble is not None, "9 (data services)"),
        'channel={"equalize": True}': (bool(channel and channel.get("equalize")),
                                       "7 (GCR equalizer)"),
    }
    for name, (on, item) in asked.items():
        if on:
            raise NotImplementedError(
                f"process_video {name} is not ported yet: ROADMAP queue 1 item {item}"
            )


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

    The temporal comb and NR fetch true neighbour frames across chunk
    boundaries (``pt`` frames per side for the comb, one more for NR), and
    a short tail chunk is padded with repeats of its last frame; PSNR and fingerprint cover only
    the chunk's own frames.  ``mesh``, ``rf``, ``rf_audio``,
    ``rf_audio_bw``, ``satellite``, ``sat_cnr``, ``caption_bits``,
    ``scramble`` and ``channel={"equalize": True}`` raise
    ``NotImplementedError``: their modules are not ported yet.
    """
    _refuse_unported(mesh, channel, rf, rf_audio, rf_audio_bw, satellite, sat_cnr,
                     caption_bits, scramble)
    device = resolve_device(device)
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
        **({"noise_keying": noise_keying(device)} if noisy else {}),
        "mesh": None,
    }
    if manifest:
        manifest.check_config(config)

    make = make_interlaced_pipeline if interlaced else make_pipeline
    enc_f, dec_f, roundtrip = make(plan, decoder, backend, device)

    chan_noise_sigma = 0.0
    if channel:
        channel = dict(channel)
        vhs = bool(channel.pop("vhs", False))
        chan_noise_sigma = float(channel.pop("noise_sigma", 0.0) or 0.0)
        # interlaced encode puts fields (2 per frame) on the leading axis
        units = 2 if interlaced else 1

        def _noise(comp: torch.Tensor, first: int) -> torch.Tensor:
            """Unit noise, one generator per absolute leading-axis index."""
            return torch.stack([
                torch.randn(comp.shape[1:], dtype=torch.float32, device=device,
                            generator=torch.Generator(device=device).manual_seed(first + i))
                for i in range(comp.shape[0])
            ])

        def roundtrip(rgb, frame0):  # noqa: F811 — the channel between
            comp = impair(plan, enc_f(rgb, frame0), **channel)
            if chan_noise_sigma > 0.0:
                comp = comp + chan_noise_sigma * _noise(comp, frame0 * units)
            if vhs:
                comp = vhs_playback(plan, comp)
            return dec_f(comp, frame0)

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
    def step(rgb: torch.Tensor, frame0: int, off: int, n_real: int):
        """Round trip (+ NR), then PSNR and fingerprint over the chunk's own
        frames, on the device: no host sync."""
        out = roundtrip(rgb, frame0)
        if nr:
            out = temporal_nr(out, nr_sigma)
        e = torch.arange(out.shape[0], device=device)
        mask = ((e >= off) & (e < off + n_real)).to(torch.float32)
        err = ((out - rgb) ** 2).mean(dim=(1, 2, 3))
        mse = (err * mask).sum() / float(max(n_real, 1))
        q = 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-20))
        return out, torch.cat([q.reshape(1), fingerprint(out * mask[:, None, None, None])])

    t_start = time.perf_counter()
    pixels = 0
    frames_done = 0
    psnrs = []

    def _resolve(pending) -> None:
        """One stacked device->host fetch of the wave's metrics, then the
        saved frames and the manifest."""
        nonlocal frames_done
        vals = torch.stack([p[4] for p in pending]).cpu().numpy()
        for (start, end, off, out, _), v in zip(pending, vals):
            q = float(v[0])
            psnrs.append(q)
            frames_done += end - start
            if out is not None:
                np.save(os.path.join(out_dir, f"rgb_{start:06d}.npy"),
                        out[off : off + (end - start)].cpu().numpy())
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
        out, metrics = step(rgb, lo, start - lo, end - start)
        pending.append((start, end, start - lo, out if save_outputs else None, metrics))
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
