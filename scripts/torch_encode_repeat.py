"""Repeat the main path's card-vs-CPU encode check of ``chip_smoke.py`` phase 4.

``check_path`` holds the NTSC comb3 kernel encode on the card against the
plain encode on the CPU on a small view of the full-width scene (frames
0-1, rows 0-63, frame 7) to 2e-5.  This script repeats both sides on the
same view and counts the results that differ from the first, in one
process and then in fresh processes, half of them encoding on the CPU
first and half on the card first.  Run from the repository root on a
machine with a card:

    python3 scripts/torch_encode_repeat.py --kernel 20000 --plain 3000 --fresh 6

It prints one line per experiment.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _setup():
    import torch

    import chip_smoke
    from color_modem_tpu_torch import NTSC
    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    x = chip_smoke.full_scene(480, dev)[:2, :, :64]
    enc_k = make_pipeline(make_plan(NTSC(), 720), "comb3", "kernel", dev)[0]
    enc_p = make_pipeline(make_plan(NTSC(), 720), "comb3", "plain", "cpu")[0]
    return x, (lambda: enc_k(x, 7).cpu()), (lambda: enc_p(x.to("cpu"), 7))


def _err(a, b) -> float:
    return float((a - b).abs().max())


def repeat(kernel: int, plain: int) -> None:
    """``kernel`` card encodes and ``plain`` CPU encodes in this process."""
    _, card, cpu = _setup()
    ref = cpu()
    for name, fn, n in (("kernel encode on the card", card, kernel),
                        ("plain encode on the CPU", cpu, plain)):
        t0 = time.perf_counter()
        first = fn()
        differ, worst, worst_ref = 0, 0.0, _err(first, ref)
        for _ in range(n):
            y = fn()
            d = _err(y, first)
            if d > 0:
                differ += 1
                worst = max(worst, d)
            worst_ref = max(worst_ref, _err(y, ref))
        print(f"{name}, (2, 3, 64, 720) view: {n} repeats, {differ} differ from the first "
              f"(worst {worst:.3e}); worst against the first plain CPU encode "
              f"{worst_ref:.3e}; {time.perf_counter() - t0:.1f} s", flush=True)


def first_two(order: str) -> None:
    """In this fresh process: two encodes of each side, in ``order``."""
    _, card, cpu = _setup()
    sides = {"cpu": cpu, "card": card}
    got = {s: (sides[s](), sides[s]()) for s in order.split(",")}
    (c1, c2), (k1, k2) = got["cpu"], got["card"]
    print(f"fresh process, order {order}: cpu 1 vs 2 {_err(c1, c2):.3e}, card 1 vs 2 "
          f"{_err(k1, k2):.3e}, card vs cpu {_err(k1, c1):.3e} and {_err(k2, c2):.3e}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", type=int, default=20000)
    ap.add_argument("--plain", type=int, default=3000)
    ap.add_argument("--fresh", type=int, default=6, help="fresh processes, both orders alike")
    ap.add_argument("--order", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.order:
        first_two(args.order)
        return
    repeat(args.kernel, args.plain)
    for i in range(args.fresh):
        order = "cpu,card" if i % 2 == 0 else "card,cpu"
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--order", order],
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"the fresh process ({order}) failed with code {res.returncode}")
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
