"""Parent against change on the card: the round trip, the video runner and rf-sound.

Runs two trees of this repository in turns, each run in a fresh process
that puts its tree first on ``sys.path``, and alternates which tree runs
first in each pair.  Each run measures, on the card:

- ``rt_ms``: the NTSC comb3 kernel round trip at 16x3x480x720, ms per call
  (CUDA events, the median of 10 windows of 20 calls);
- ``runner_device_mpix``: ``process_video`` NTSC comb3, 48 frames in
  chunks of 16 from ``synthetic_device_source``, Mpix/s (the median of 4
  warm runs after a cold one);
- ``runner_numpy_mpix``: the same from a NumPy source (contiguous host
  float32 frames, the path of a user's decoded video);
- ``rf_sound_ms``: ``chip_smoke.py`` phase 5h's rf-sound chain (FM sound
  and NICAM over the RF hop, transmit and receive), ms per 16 frames
  (the median of 10 windows of 20 calls).

Each tree first runs once untimed (it builds its kernels).  Then the
summary gives, per metric, each tree's median over its runs and the
spread of its runs (the distance between their quartiles), the pairs the
change wins, and the verdict of the rule for a comparison: ``gain`` when
the change wins at least nine tenths of the pairs and the medians differ
by more than the parent's spread; ``regressed`` when the change's median
is worse by more than the bound (5%) and by more than the parent's spread;
``unresolved`` when the parent's spread is wider than the bound, unless
every run of the change reads better than every run of the parent; else
``unchanged``.  From the repository root, with the parent unpacked by
``git archive <rev> | tar -x -C ab_trees/parent``:

    python3 scripts/torch_runner_ab.py --pairs 10 ab_trees/parent .

The runs' lines and the summary go to standard output, one JSON object
per line, the summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

#: metric -> True where larger is better
METRICS = {"rt_ms": False, "runner_device_mpix": True, "runner_numpy_mpix": True,
           "rf_sound_ms": False}
BOUND = 0.05


def one_run(tree: str) -> dict:
    """The four metrics of ``tree``, measured in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    import color_modem_tpu_torch
    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.frame.video import process_video, synthetic_device_source
    from color_modem_tpu_torch.kernels.measure import time_ms
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    for mod in (color_modem_tpu_torch, chip_smoke):
        if not mod.__file__.startswith(tree):
            raise SystemExit(f"imported {mod.__file__}, not the tree {tree}")
    dev = torch.device("cuda:0")
    plan = make_plan(NTSC(), 720).to(dev)
    scene = smooth_scene(480, 720, seed=0)
    rgb = torch.tensor(scene, device=dev).expand(16, 3, 480, 720).contiguous()
    _, _, rt = make_pipeline(plan, "comb3", "kernel", dev)
    out = {"rt_ms": statistics.median(time_ms(lambda: rt(rgb, 0)) + time_ms(lambda: rt(rgb, 0)))}

    host = np.ascontiguousarray(np.broadcast_to(scene, (48, 3, 480, 720)), np.float32)
    sources = {"runner_device_mpix": synthetic_device_source(480, 720, seed=0, device=dev),
               "runner_numpy_mpix": lambda start, count: host[start : start + count]}
    with tempfile.TemporaryDirectory() as d:
        for key, src in sources.items():
            rates = [process_video(plan, src, 48, os.path.join(d, f"{key}{i}"), decoder="comb3",
                                   chunk=16, device=dev)["mpix_per_s"] for i in range(5)]
            out[key] = statistics.median(rates[1:])

    tx, rx = chip_smoke.sound_chains(dev)[0]["rf-sound"]
    hop = lambda: rx(tx())  # noqa: E731
    out["rf_sound_ms"] = statistics.median(time_ms(hop) + time_ms(hop))
    return out


def _quartile_spread(xs: list[float]) -> float:
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[2] - q[0]


def verdict(parent: list[float], change: list[float], higher_better: bool) -> dict:
    """The rule's reading of one metric over pairs run in turns."""
    sign = 1.0 if higher_better else -1.0
    wins = sum(sign * (c - p) > 0 for p, c in zip(parent, change))
    mp, mc = statistics.median(parent), statistics.median(change)
    spread = _quartile_spread(parent)
    worse = sign * (mp - mc)                     # > 0: the change is worse
    if wins >= 0.9 * len(parent) and abs(mc - mp) > spread:
        word = "gain"
    elif worse > BOUND * abs(mp) and worse > spread:
        word = "regressed"
    elif spread > BOUND * abs(mp) and not (
            min(sign * c for c in change) > max(sign * p for p in parent)):
        word = "unresolved"
    else:
        word = "unchanged"
    return {"parent_median": mp, "change_median": mc, "parent_spread": spread,
            "change_spread": _quartile_spread(change), "change_wins": wins,
            "pairs": len(parent), "verdict": word}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--one", action="store_true", help="measure the one tree given as parent")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_run(args.parent)))
        return

    def run(tree: str) -> dict:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"the run of {tree} failed with code {res.returncode}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **line}), flush=True)
        return line

    for tree in (args.parent, args.change):
        run(tree)  # builds the tree's kernels; not counted
    runs = {args.parent: [], args.change: []}
    for i in range(args.pairs):
        order = (args.parent, args.change) if i % 2 == 0 else (args.change, args.parent)
        for tree in order:
            runs[tree].append(run(tree))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "summary": {
        m: verdict([r[m] for r in runs[args.parent]], [r[m] for r in runs[args.change]], hi)
        for m, hi in METRICS.items()}}))


if __name__ == "__main__":
    main()
