"""The video runner's noisy paths in one or more trees of this repository, on
one CUDA GPU, in turns.

    python3 scripts/torch_noisy_runner_ab.py [--tree DIR ...] [--runs 4]

Each tree (default: this one) runs in its own process, which imports that
tree's ``color_modem_tpu_torch`` and builds its kernels, and times
``process_video`` NTSC comb3 on ``synthetic_device_source(480, 720,
seed=0)``, 48 frames in chunks of 16 (``chip_smoke.py``'s phase 6 run):
clean, with channel noise 0.02 and through the satellite hop at 12 dB CNR.
After one warm-up run of each path, ``--runs`` fresh runs of each give the
runner's own Mpix/s (host clock over the run, its fetches included); each
path's ``min_psnr_db`` is printed beside.  The trees run forward then
backward (A, B, B, A for two).  The last line is a JSON object of every
measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: path -> process_video options
PATHS = {
    "clean": {},
    "channel noise 0.02": {"channel": {"noise_sigma": 0.02}},
    "satellite 12 dB CNR": {"satellite": True, "sat_cnr": 12.0},
}
FRAMES, CHUNK, LINES, SAMPLES = 48, 16, 480, 720


def worker(tree: str, runs: int) -> None:
    sys.path.insert(0, tree)
    import torch

    import color_modem_tpu_torch as cmt
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source
    from color_modem_tpu_torch.kernels.build import load_library
    from color_modem_tpu_torch.modem.plan import make_plan

    assert os.path.dirname(os.path.abspath(cmt.__file__)) == os.path.join(
        os.path.abspath(tree), "color_modem_tpu_torch"), cmt.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    dev = torch.device("cuda:0")
    plan = make_plan(cmt.NTSC(), SAMPLES).to(dev)
    src = synthetic_device_source(LINES, SAMPLES, seed=0, device=dev)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in PATHS.items():
            rates, psnr = [], None
            for i in range(runs + 1):
                s = process_video(plan, src, FRAMES, os.path.join(tmp, f"{name}_{i}"),
                                  decoder="comb3", chunk=CHUNK, device=dev, **kw)
                psnr = s["min_psnr_db"]
                if i:  # the first run warms the path up
                    rates.append(s["mpix_per_s"])
            res[name] = {"mpix_per_s": rates, "median": statistics.median(rates),
                         "min_psnr_db": psnr}
    print(json.dumps({"tree": tree, "results": res}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tree", nargs="+", default=[HERE])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.runs)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_noisy_runner_ab: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    out_runs = []
    for tree in list(args.tree) + list(reversed(args.tree)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                              "--runs", str(args.runs)],
                             check=True, capture_output=True, text=True, timeout=900)
        run = json.loads(out.stdout.strip().splitlines()[-1])
        out_runs.append(run)
        for name, r in run["results"].items():
            rates = r["mpix_per_s"]
            print(f"{tree} {name} {FRAMES}x3x{LINES}x{SAMPLES} chunk {CHUNK} on {card}: "
                  f"{r['median']:.1f} Mpix/s [{min(rates):.1f}, {max(rates):.1f}] "
                  f"({len(rates)} fresh runs), min_psnr_db {r['min_psnr_db']}")
    print(json.dumps({"card": card, "runs": out_runs}))


if __name__ == "__main__":
    main()
