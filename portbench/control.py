"""The control of each cell's comparison, run as the program would be: the
plain reference, computed one step below the configurations' float32
(float32 with TF32 products), is planted in the program's place
(``portbench/faults.py``), and ``harness.run`` drives the cell at its own
sizes through set-up, a window and the comparison, as a run does.  Its
``correct`` has to come out false; its reading is the upper end that a
cell's limit is set below.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

The control is slow, so the units a run compares are drawn from the
window's first ones (``sample_within`` cut to the number sampled): as many
are compared as in a run.  Needs a card and ``TMPDIR``; prints one JSON
line per seed and, last, the least reading; exits 1 where a seed comes out
correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.faults import plant  # noqa: E402


def control_cell(cell: harness.Cell) -> harness.Cell:
    """``cell`` with its sampled units drawn from the window's first."""
    tr = cell.traffic
    tr["sample_within"] = tr["sample_calls"] if tr["driver"] == "batch" else tr["sample_jobs"]
    return cell


def run_control(cell: harness.Cell, seed: int, seconds: float, device) -> dict:
    """``harness.run`` of ``cell`` with the control in the program's place:
    ``{"result": ..., "checks": ...}``."""
    undo = plant("control", cell)
    try:
        return harness.run(cell, seed, seconds, False, device, time.time())
    finally:
        undo()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control: needs a CUDA card")
    dev = torch.device("cuda", 0)
    gaps, correct = [], []
    for seed in args.seeds:
        cell = control_cell(harness.load_cell(args.workload))
        out = run_control(cell, seed, args.seconds, dev)
        gaps.append(out["checks"]["rgb_max_gap"]["value"])
        correct.append(out["result"]["correct"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct[-1], "checks": out["checks"]}), flush=True)
    print(json.dumps({"workload": args.workload, "least": min(g for g in gaps if g is not None),
                      "limit": cell.limits["rgb_max_gap"], "any_correct": any(correct)}))
    return 1 if any(correct) else 0


if __name__ == "__main__":
    sys.exit(main())
