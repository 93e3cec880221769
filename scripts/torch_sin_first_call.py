"""Count inaccurate first calls of ``torch.sin`` (and ``cos``, ``exp``) on the
CPU in fresh processes.

The plain NTSC encode on the CPU (``chip_smoke.py`` phase 4) once in a
while read ``torch.sin`` of its (2, 64, 720) float32 carrier phase up to
1.5e-4 off on about one thread's share of the elements, in the first call
of the process only; the next call, and ``torch.cos`` right after, were
exact to float32 (``scripts/torch_encode_first_call.py``).  This script
starts ``--fresh`` processes per mode; each takes ``torch.sin`` of such a
tensor (phases uniform in [0.57, 9.96], the encode's range, from a seed)
twice and holds both calls against the float64 sine, then the same for
``torch.cos`` and ``torch.exp`` (of the negated phases).  Modes:

- ``bare``: the first thing the process computes;
- ``cuda``: after a CUDA context and one operation on the card;
- ``warm``: after ``torch.sin`` of a one-element tensor, which runs on the
  calling thread alone;
- ``port``: after ``import color_modem_tpu_torch.dsp``, which every
  module of the port that computes imports.

Run from the repository root (``cuda`` needs a card)::

    python3 scripts/torch_sin_first_call.py --fresh 100 --modes bare,warm,port

It prints one line per mode and function: processes, first calls off by
more than 1e-5, second calls off, and the worst errors.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a float32 sine this far from the float64 one is not a rounding difference
OFF = 1e-5


def _child(mode: str) -> None:
    import torch

    if mode == "cuda":
        torch.ones(1, device="cuda").add_(1).cpu()
    elif mode == "warm":
        torch.sin(torch.zeros(1))
    elif mode == "port":
        sys.path.insert(0, REPO)
        import color_modem_tpu_torch.dsp  # noqa: F401
    g = torch.Generator().manual_seed(0)
    phi = torch.rand((2, 64, 720), generator=g) * 9.39 + 0.57
    rec = {"threads": torch.get_num_threads()}
    for name, x in (("sin", phi), ("cos", phi), ("exp", -phi)):
        f = getattr(torch, name)
        first, second = f(x), f(x)
        ref = f(x.double())
        rec[name] = [float((first.double() - ref).abs().max()),
                     float((second.double() - ref).abs().max())]
    print(json.dumps(rec))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fresh", type=int, default=100, help="fresh processes per mode")
    ap.add_argument("--modes", default="bare,warm,port")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child)
        return
    for mode in args.modes.split(","):
        recs = []
        for _ in range(args.fresh):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", mode],
                                 capture_output=True, text=True, check=True, cwd=REPO)
            recs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        for name in ("sin", "cos", "exp"):
            firsts, seconds = ([r[name][k] for r in recs] for k in (0, 1))
            print(f"{mode} {name}: {args.fresh} processes, {recs[0]['threads']} threads: first "
                  f"call off by more than {OFF} in {sum(e > OFF for e in firsts)}, second call "
                  f"in {sum(e > OFF for e in seconds)}; worst first-call error "
                  f"{max(firsts):.3e}, worst second {max(seconds):.3e}", flush=True)


if __name__ == "__main__":
    main()
