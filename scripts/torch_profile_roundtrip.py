"""Where the time of the PyTorch port's round trips goes on a CUDA GPU.

Traces a round trip with ``torch.profiler`` over a short steady window and
prints, per backend: the card, the host-clock time per round trip, the
device busy share (kernel time over the window) and the device time by
kernel.  Paths: ``ntsc-comb3`` (the main path, 16x3x480x720) and
``secam-interp`` (16x3x576x720).

    python3 scripts/torch_profile_roundtrip.py [--iters 20] [--backend kernel plain]
        [--path ntsc-comb3 secam-interp]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: path -> (standard, decoder, lines)
PATHS = {"ntsc-comb3": ("NTSC", "comb3", 480), "secam-interp": ("SECAM", "interp", 576)}


def profile(path: str, backend: str, iters: int, card: str) -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import color_modem_tpu_torch as cmt
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    standard, decoder, lines = PATHS[path]
    dev = torch.device("cuda:0")
    rgb = torch.tensor(np.broadcast_to(smooth_scene(lines, 720, seed=0), (16, 3, lines, 720)),
                       dtype=torch.float32, device=dev)
    _, _, rt = make_pipeline(make_plan(getattr(cmt, standard)(), 720), decoder, backend,
                             device=dev)
    for _ in range(5):
        rt(rgb, 0)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            rt(rgb, 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"== {path} 16x3x{lines}x720, backend {backend} on {card}: {wall_us / iters / 1e3:.4f} ms per round trip "
          f"(host clock, profiler on), device busy {busy_us / iters / 1e3:.4f} ms "
          f"= {100 * busy_us / wall_us:.1f}% of the window")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        share = 100 * e.self_device_time_total / busy_us
        print(f"  {e.self_device_time_total / iters:9.2f} us/rt {share:5.1f}%  "
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
        for backend in args.backend:
            profile(path, backend, args.iters, card)


if __name__ == "__main__":
    main()
