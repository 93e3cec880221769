"""Where the time of the PyTorch port's round trips goes on a CUDA GPU.

Traces a path with ``torch.profiler`` over a short steady window and
prints, per backend: the card, the host-clock time per call, the host time
the profiler attributes to operators, the device busy share (kernel time
over the window) and the device time by kernel.  Paths, 16 frames x 720
samples at the standard's active lines:

* ``ntsc-comb3`` (the main path), ``secam-interp`` and ``pal-delayline``:
  ``make_pipeline``;
* ``ntsc-comb3-interlaced``: ``make_interlaced_pipeline`` (32 fields);
* ``ntsc-svideo``: ``make_svideo_pipeline``;
* ``ntsc-pal-transcode``: ``make_transcoder`` on an NTSC composite;
* ``ntsc-comb3-video``: one ``process_video`` run of 48 frames in chunks of
  16 from ``synthetic_device_source``, into a fresh directory each call;
* ``rf`` and ``satellite``: the RF/VSB and satellite FM hops
  (``rf_roundtrip``, ``sat_roundtrip``) on the NTSC notch composite of the
  16 frames; ``d2mac``: the MAC round trip at 16x3x576x720; ``rf-sound``:
  the RF hop with the FM sound carrier over the joined 16 frames and a
  NICAM carrier beside it (``rf_modulate`` -> ``sound_on_rf`` ->
  ``nicam_on_rf`` -> ``rf_demodulate``, ``sound_from_rf``,
  ``nicam_from_rf``); ``sat-sound``: the satellite hop with two audio
  subcarriers (``fm_modulate(audio=)`` -> ``fm_demodulate``,
  ``fm_demodulate_audio``); ``ntsc-scramble``: cut-and-rotate scrambling
  and descrambling of the NTSC composite.  These have no kernel of their
  own, so they run once, whatever ``--backend`` says;
* ``pal-palplus``: the PALplus round trip (``make_palplus_pipeline``);
* ``ntsc-comb3-video-services``: ``ntsc-comb3-video`` with a caption cell
  per frame and cut-and-rotate scrambling.

Besides the kernels, each path's device time is split by kind: cuFFT,
elementwise, reductions, scans, sorts, matrix products (GEMM) and the
port's own kernels; the host idle share is the rest of the window.

    python3 scripts/torch_profile_roundtrip.py [--iters 20] [--backend kernel plain]
        [--path ntsc-comb3 secam-interp ...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: path -> (layer, standard, decoder or destination standard)
PATHS = {
    "ntsc-comb3": ("pipeline", "NTSC", "comb3"),
    "secam-interp": ("pipeline", "SECAM", "interp"),
    "pal-delayline": ("pipeline", "PAL", "delayline"),
    "ntsc-comb3-interlaced": ("interlaced", "NTSC", "comb3"),
    "ntsc-svideo": ("svideo", "NTSC", None),
    "ntsc-pal-transcode": ("transcode", "NTSC", "PAL"),
    "ntsc-comb3-video": ("video", "NTSC", "comb3"),
    "rf": ("hop", "NTSC", "rf"),
    "satellite": ("hop", "NTSC", "satellite"),
    "d2mac": ("hop", "NTSC", "d2mac"),
    "rf-sound": ("hop", "NTSC", "rf-sound"),
    "sat-sound": ("hop", "NTSC", "sat-sound"),
    "ntsc-scramble": ("hop", "NTSC", "scramble"),
    "pal-palplus": ("palplus", "PAL", "comb3"),
    "ntsc-comb3-video-services": ("video-services", "NTSC", "comb3"),
}

#: device-time kinds, matched in order on the lower-cased kernel name
KINDS = (
    ("sort", ("radixsort", "sort")),
    ("cufft", ("fft", "radix")),
    ("gemm", ("gemm", "cutlass", "xmma")),
    ("port kernel", ("qam_", "secam_", "fir_")),
    ("scan", ("scan",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "cat", "copy", "fill", "index", "where")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def make_call(path: str, backend: str, dev, tmp: str):
    """A zero-argument callable running ``path`` once, and its label."""
    import itertools

    import numpy as np
    import torch

    import color_modem_tpu_torch as cmt
    from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.frame.svideo import make_svideo_pipeline
    from color_modem_tpu_torch.frame.transcode import make_transcoder
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    layer, standard, arg = PATHS[path]
    plan = make_plan(getattr(cmt, standard)(), 720)
    lines = plan.cfg.active_lines
    rgb = torch.tensor(np.broadcast_to(smooth_scene(lines, 720, seed=0), (16, 3, lines, 720)),
                       dtype=torch.float32, device=dev)
    label = f"{path} 16x3x{lines}x720"
    if layer == "pipeline":
        rt = make_pipeline(plan, arg, backend, device=dev)[2]
    elif layer == "interlaced":
        rt = make_interlaced_pipeline(plan, arg, backend, device=dev)[2]
    elif layer == "svideo":
        rt = make_svideo_pipeline(plan, backend, device=dev)[2]
    elif layer == "palplus":
        from color_modem_tpu_torch.frame.palplus import make_palplus_pipeline

        rt = make_palplus_pipeline(plan, arg, backend, device=dev)[2]
    elif layer == "transcode":
        comp = make_pipeline(plan, "notch", backend, device=dev)[0](rgb, 0)
        conv = make_transcoder(plan, make_plan(getattr(cmt, arg)(), 720), backend=backend,
                               device=dev)
        return (lambda: conv(comp, 0)), label
    elif layer == "hop":
        from color_modem_tpu_torch.frame import rf as rf_mod
        from color_modem_tpu_torch.frame import satellite as sat_mod
        from color_modem_tpu_torch.modem import mac

        if arg == "d2mac":
            mplan = mac.make_mac_plan(720)
            mrgb = torch.tensor(np.broadcast_to(smooth_scene(576, 720, seed=0),
                                                (16, 3, 576, 720)), dtype=torch.float32,
                                device=dev)
            g = (torch.arange(16, dtype=torch.int32, device=dev)[:, None] * 625
                 + torch.arange(576, dtype=torch.int32, device=dev))
            return (lambda: mac.roundtrip(mplan, mrgb, g)), "d2mac 16x3x576x720"
        comp = make_pipeline(plan.to(dev), "notch", "kernel", device=dev)[0](rgb, 0)
        if arg == "scramble":
            from color_modem_tpu_torch.frame.pipeline import frame_line_index
            from color_modem_tpu_torch.frame.scramble import descramble, scramble

            g = frame_line_index(plan, 0, 16, lines, dev)
            return (lambda: descramble(plan, scramble(plan, comp, g, "cutrotate", 7), g,
                                       "cutrotate", 7)), f"ntsc-scramble 16x{lines}x720"
        if arg == "rf-sound":
            from color_modem_tpu_torch.frame import nicam

            rfp = rf_mod.make_rf_plan(plan)
            t = torch.arange(16 * lines * 720, dtype=torch.float64, device=dev) / plan.fs
            audio = (0.6 * torch.sin(2 * np.pi * 1000 * t) + 0.3 * torch.sin(
                2 * np.pi * 7000 * t)).float().reshape(16, lines * 720)
            cap = nicam.nicam_capacity(rfp, (16, lines, 720 * rfp.r))
            tn = torch.arange(32 * cap, dtype=torch.float64, device=dev) / 32000.0
            nl, nr = ((0.5 * torch.sin(2 * np.pi * f * tn)).float() for f in (800.0, 2300.0))

            def rf_sound():
                rf = rf_mod.sound_on_rf(rfp, rf_mod.rf_modulate(rfp, comp, 0), 0, audio, 0.0)
                rf = nicam.nicam_on_rf(rfp, rf, nl, nr)
                return (rf_mod.rf_demodulate(rfp, rf, 0), rf_mod.sound_from_rf(rfp, rf, 0),
                        nicam.nicam_from_rf(rfp, rf, cap))
            return rf_sound, f"rf-sound 16x{lines}x720"
        if arg == "sat-sound":
            sp = sat_mod.make_sat_plan(plan.fs, 720, audio_subs=2)
            n_tot = lines * 720
            k = torch.arange(n_tot, dtype=torch.float64, device=dev)
            sub = torch.stack([a * torch.sin(2 * np.pi * round(f * n_tot / plan.fs) * k / n_tot)
                               for f, a in ((1000.0, 0.6), (3000.0, 0.5))]).float()
            sub = sub.expand(16, 2, n_tot)

            def sat_sound():
                sig = sat_mod.fm_modulate(sp, comp, audio=sub)
                return sat_mod.fm_demodulate(sp, sig), sat_mod.fm_demodulate_audio(sp, sig)
            return sat_sound, f"sat-sound 16x{lines}x720"
        if arg == "rf":
            rfp = rf_mod.make_rf_plan(plan)
            return (lambda: rf_mod.rf_roundtrip(rfp, comp, 0)), f"rf-vsb-hop 16x{lines}x720"
        sp = sat_mod.make_sat_plan(plan.fs, 720)
        return (lambda: sat_mod.sat_roundtrip(sp, comp)), f"satellite-fm-hop 16x{lines}x720"
    else:
        src = synthetic_device_source(lines, 720, seed=0, device=dev)
        runs = itertools.count()
        services = ({"caption_bits": np.zeros((48, 16), np.int32), "scramble": ("cutrotate", 7)}
                    if layer == "video-services" else {})
        return (lambda: process_video(plan, src, 48, os.path.join(tmp, str(next(runs))),
                                      decoder=arg, chunk=16, backend=backend, device=dev,
                                      **services),
                f"{path} 48x3x{lines}x720 chunk 16")
    return (lambda: rt(rgb, 0)), label


def profile(path: str, backend: str, iters: int, card: str) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        call, label = make_call(path, backend, dev, tmp)
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    host_us = sum(e.self_cpu_time_total for e in events if e.device_type == DeviceType.CPU)
    print(f"== {label}, backend {backend} on {card}: {wall_us / iters / 1e3:.4f} ms per call "
          f"(host clock, profiler on), host operators {host_us / iters / 1e3:.4f} ms, "
          f"device busy {busy_us / iters / 1e3:.4f} ms = {100 * busy_us / wall_us:.1f}% "
          "of the window")
    by_kind = {}
    for e in kernels:
        kind = kind_of(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total
    split = ", ".join(f"{kind} {t / iters / 1e3:.4f} ms ({100 * t / busy_us:.1f}%)"
                      for kind, t in sorted(by_kind.items(), key=lambda kv: -kv[1]))
    print(f"  device time by kind: {split}; host idle share "
          f"{100 * (1 - busy_us / wall_us):.1f}% of the window")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        share = 100 * e.self_device_time_total / busy_us
        print(f"  {e.self_device_time_total / iters:9.2f} us/call {share:5.1f}%  "
              f"x{e.count // iters:<3d} {e.key[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--backend", nargs="+", default=["kernel", "plain"])
    ap.add_argument("--path", nargs="+", default=["ntsc-comb3"], choices=sorted(PATHS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_roundtrip: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    for path in args.path:
        # the hops have no kernel of their own: one run, whatever the backend
        for backend in args.backend[:1] if PATHS[path][0] == "hop" else args.backend:
            profile(path, backend, args.iters, card)


if __name__ == "__main__":
    main()
