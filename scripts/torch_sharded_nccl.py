"""The parallel layer on four cards over NCCL, one rank per card.

On one card, ``chip_smoke.py`` phase 4j runs its ranks through gloo (NCCL
refuses two ranks on one GPU).  This script runs the same case list
(``chip_smoke.sharded_cases``: NTSC comb3, SECAM interp and PAL delayline
at full width, the rest of the JAX multi-chip gate's cases at 4 frames x
64 lines) on 4 NCCL ranks, rank r on cuda:r, and holds it to phase 4j's
checks: each gathered result against the unsharded pipeline on the card,
each rank's launches and device, the full-width PSNRs, the main path under
``set_sync_debug_mode("error")``; it prints each rank's round-trip and
halo-exchange times, then ``process_video(mesh=(2,2))`` NTSC comb3
48x480x720 in chunks of 16, plain and with captions and cutrotate through
the RF hop (without saving, each one's second run read: their Mpix/s and
PSNR, the cells exact).  Run
from the repository root on a machine with 4 cards:

    python3 scripts/torch_sharded_nccl.py

It exits nonzero when a check fails or fewer than 4 cards are present.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from color_modem_tpu_torch.parallel import multihost as mh

    n = cs.SHARDED_RANKS
    if torch.cuda.device_count() < n:
        raise SystemExit(f"needs {n} cards, found {torch.cuda.device_count()}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().replace("\n", " | ")
    print(f"cards: {card}")
    cases = cs.sharded_cases()
    video = {"name": "video-mesh", "kind": "video", "mesh": [2, 2], "standard": "ntsc",
             "out": "mesh", "source": "device", "backend": "kernel", "save": False,
             "opts": {"decoder": "comb3", "chunk": cs.VIDEO_CHUNK,
                      "n_frames": cs.VIDEO_FRAMES, "lines": 480}}
    services, bits, svc_psnr = cs.mesh_services_cases()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        warm = dict(video, name="video-mesh-warm", out="mesh-warm")
        recs = mh.launch(cases + [warm, video, *services], n, backend="nccl", outdir=out,
                         timeout=600.0)
        cells = np.concatenate([np.load(f) for f in sorted(
            glob.glob(os.path.join(out, "services", "cc_*.npy")))])
    wall = time.perf_counter() - t0
    launches = cs.check_sharded_records(cases, [rr[:-4] for rr in recs],
                                        [f"cuda:{r}" for r in range(n)], card,
                                        f"{n} NCCL ranks, one card each")
    for k, name, want in ((-3, "", cs.VIDEO_MIN_PSNR), (-1, " caption scramble rf", svc_psnr)):
        s = recs[0][k]["summary"]
        print(f"video mesh 2x2 ntsc comb3{name} {cs.VIDEO_FRAMES}x3x480x720 chunk "
              f"{cs.VIDEO_CHUNK}: min_psnr_db {s['min_psnr_db']} (expected {want} +- "
              f"{cs.PSNR_TOL}), {s['mpix_per_s']} Mpix/s without saving, launches per rank "
              f"{[rr[k]['launches'] for rr in recs]}, on {card}")
        cs._check(abs(s["min_psnr_db"] - want) <= cs.PSNR_TOL, f"video{name}: {s}")
    cs._check(np.array_equal(cells, bits), "video caption scramble rf: caption cells")
    print(f"launches per rank on the (2,2) full-width cases: {launches}")
    print(f"{len(cases) + 4} cases on {n} NCCL ranks in {wall:.1f} s: all checks passed")


if __name__ == "__main__":
    main()
