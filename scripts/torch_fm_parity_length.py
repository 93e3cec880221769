"""Parity of the satellite FM modulator with the golden oracle against the
frame stream's length, and the precision of its video path.  Run from the
repository root:

    python3 scripts/torch_fm_parity_length.py [--device cuda|cpu] [--jax] [--time]

For 16, 48, 160 and 480 lines of 720 samples (two frames of
``smooth_scene(L, 720, seed=0)`` through the port's NTSC notch encode),
prints one JSON line per length and video path: the variance-relative
parity, dB, of the port's ``frame/satellite.py::fm_modulate`` against
``golden/transmission.py::fm_modulate`` on the same composite, as the
port's CPU tests and ``chip_smoke.py`` phase 4k read it, and the largest
absolute difference.  ``video: float64`` is the modulator as it is (its
pre-emphasis and interpolation filters in float64); ``video: float32``
rounds the pre-emphasis filter's output to float32, so that it and the
interpolation run in float32 as the JAX package's do, while the deviation
and the phase bookkeeping stay in float64.  The FM phase integrates the
filters' rounding over the whole frame, so the float32 path's difference
from the float64 oracle grows with the frame's length.  ``--jax`` adds the
JAX package's ``fm_modulate`` (all of it float32) against its own golden
oracle on the JAX encode of the same scene (needs the JAX package; run it
with ``JAX_PLATFORMS=cpu``).  ``--time`` (on a card) adds the modulator's
time on phase 5g's 16 frames of 480 x 720 for both video paths: CUDA
events, 20 windows of 20 calls per path, the two paths' windows
interleaved, the median and the range of the last 10 of each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LINES = (16, 48, 160, 480)
N = 720


def parity_db(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(10.0 * np.log10(np.var(b) / max(float(np.mean((a - b) ** 2)), 1e-300)))


def scene(lines: int) -> np.ndarray:
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    return np.ascontiguousarray(np.broadcast_to(smooth_scene(lines, N, seed=0),
                                                (2, 3, lines, N))).astype(np.float32)


def port_rows(device: str) -> None:
    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame import satellite
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.golden import transmission
    from color_modem_tpu_torch.modem.plan import make_plan

    plan = make_plan(NTSC(), N)
    sp = satellite.make_sat_plan(plan.fs, N)
    enc = make_pipeline(plan, "notch", "kernel", device)[0]
    wrap_filter = satellite._wrap_filter

    def float32_filter(s, taps):
        return wrap_filter(s.float(), taps)

    for lines in LINES:
        comp = enc(torch.tensor(scene(lines), device=device), 0)
        ref = transmission.fm_modulate(sp, comp.double().cpu().numpy())
        for video, filt in (("float64", wrap_filter), ("float32", float32_filter)):
            satellite._wrap_filter = filt
            try:
                got = satellite.fm_modulate(sp, comp).double().cpu().numpy()
            finally:
                satellite._wrap_filter = wrap_filter
            print(json.dumps({"package": "port", "device": device, "video": video,
                              "lines": lines, "parity_db": parity_db(got, ref),
                              "max_abs_diff": float(np.abs(got - ref).max())}), flush=True)


def time_rows(device: str) -> None:
    import subprocess

    import torch

    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame import satellite
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    plan = make_plan(NTSC(), N)
    sp = satellite.make_sat_plan(plan.fs, N)
    enc = make_pipeline(plan, "notch", "kernel", device)[0]
    rgb = torch.tensor(scene(480)[:1], device=device).expand(16, -1, -1, -1).contiguous()
    comp = enc(rgb, 0)
    wrap_filter = satellite._wrap_filter

    def float32_filter(s, taps):
        return wrap_filter(s.float(), taps)

    paths = {"float64": wrap_filter, "float32": float32_filter}
    windows = {k: [] for k in paths}
    for i in range(20):
        for video in (("float64", "float32") if i % 2 == 0 else ("float32", "float64")):
            satellite._wrap_filter = paths[video]
            try:
                satellite.fm_modulate(sp, comp)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                for _ in range(20):
                    satellite.fm_modulate(sp, comp)
                end.record()
                end.synchronize()
            finally:
                satellite._wrap_filter = wrap_filter
            windows[video].append(start.elapsed_time(end) / 20)
    for video, ms in windows.items():
        ms = sorted(ms[-10:])
        print(json.dumps({"timing": "fm_modulate", "video": video, "shape": [16, 480, N],
                          "ms": (ms[4] + ms[5]) / 2, "range": [ms[0], ms[-1]],
                          "card": card}), flush=True)


def jax_rows() -> None:
    import jax.numpy as jnp

    from color_modem_tpu.frame import satellite
    from color_modem_tpu.frame.pipeline import make_pipeline
    from color_modem_tpu.golden import transmission
    from color_modem_tpu.modem.plan import make_plan
    from color_modem_tpu.standards import NTSC

    plan = make_plan(NTSC(), N)
    sp = satellite.make_sat_plan(plan.fs, N)
    enc = make_pipeline(plan, "notch")[0]
    for lines in LINES:
        comp = np.asarray(enc(jnp.asarray(scene(lines)), 0))
        got = np.asarray(satellite.fm_modulate(sp, jnp.asarray(comp)), np.float64)
        ref = transmission.fm_modulate(sp, comp)
        print(json.dumps({"package": "jax", "device": "cpu", "video": "float32",
                          "lines": lines, "parity_db": parity_db(got, ref),
                          "max_abs_diff": float(np.abs(got - ref).max())}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax", action="store_true", help="the JAX package's rows too")
    ap.add_argument("--time", action="store_true", help="time both video paths (a card)")
    args = ap.parse_args(argv)
    port_rows(args.device)
    if args.time:
        time_rows(args.device)
    if args.jax:
        jax_rows()


if __name__ == "__main__":
    main()
