"""A cell cut to a size the CPU tests hold (few lines, small batches, short
jobs; everything else as the cell has it), run with a fault of
``portbench/faults.py`` planted in the timed path or none.

    python -m portbench.tests.small <cell> [--trace] [--fault NAME]

runs one small cell on the CPU and prints its result line and the loaded
modules JAX would own.  With ``RANK``/``WORLD_SIZE`` in the environment it
is one rank of a mesh cell over gloo (rank 0 prints).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from portbench import harness
from portbench.faults import plant

#: cells whose files the benchmark keeps but ``BENCHMARK.json`` does not
#: list yet (``PERF.md``, Open questions): name -> its ``workloads`` entry
KEPT = {"ntsc-comb3.video-rf-mesh2x2": {"name": "ntsc-comb3.video-rf-mesh2x2",
                                        "config": "ntsc-comb3",
                                        "traffic": "video-rf-mesh2x2", "chips": 4}}


def small_cell(name: str, lines: int = 16):
    cell = harness.load_cell(name, entry=KEPT.get(name))
    cell.config["lines"] = lines
    tr = cell.traffic
    if tr["driver"] == "batch":
        tr.update(batch=2, ring=3, warmup_calls=1, trace_units=2, sample_within=2,
                  sample_calls=2)
    else:
        tr.update(frames=6, chunk=3, warmup_jobs=1, trace_units=1, sample_within=1,
                  sample_jobs=1, sample_frames=3)
        if tr.get("mesh"):
            tr["backend"] = "gloo"
    return cell


def run_small(name: str, seconds: float = 0.5, trace: bool = False, seed: int = 2**31 + 7,
              fault: str | None = None, device: str = "cpu", lines: int = 16):
    """``harness.run`` of the small cell, ``lines`` high, with ``fault``
    planted."""
    cell = small_cell(name, lines)
    undo = plant(fault, cell)
    try:
        world = int(os.environ.get("WORLD_SIZE", 1))
        return harness.run(cell, seed, seconds, trace, torch.device(device), time.time(),
                           world=world)
    finally:
        undo()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    args = ap.parse_args()
    torch.set_num_threads(1)
    out = run_small(args.cell, trace=args.trace, fault=args.fault, seed=args.seed)
    if out is not None:
        print(json.dumps({**out["result"], "checks": out["checks"]}))
        print(json.dumps({"forbidden": harness.forbidden_modules()}))


if __name__ == "__main__":
    main()


def run_ranks(cell: str, n: int = 4, fault: str | None = None, timeout: float = 300) -> dict:
    """The small mesh cell on ``n`` gloo ranks on the CPU, one process
    each; rank 0's result line."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "portbench.tests.small", cell]
    cmd += ["--fault", fault] if fault else []
    procs = [subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                                                  WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                                                  MASTER_PORT=str(port)))
             for r in range(n)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (o, e) in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"a rank failed ({p.returncode}):\n{e[-3000:]}")
    return json.loads(outs[0][0].splitlines()[0])
