"""Hunt the rare first-call deviation of the plain NTSC encode on the CPU.

``chip_smoke.py`` phase 4 holds the kernel encode on the card against the
plain encode on the CPU (frames 0-1, rows 0-63 of the full-width scene,
frame 7) to 2e-5.  A few whole runs read 2.96e-5 there, and the rerun
showed the plain CPU side moving between its first and second call.  This
script runs ``chip_smoke.main`` in ``--fresh`` new processes up to the end
of that check, with the plain CPU encode replaced by the same operations
that keep every stage (RGB in, line indices, Y'IQ, the two low-passes,
phase, sine, cosine, chroma, composite) of each call, and prints, per
process, the CPU's threads and vector unit and, when the first two calls
differ, which stages differ and where.  Run from the repository root on a
machine with a card:

    python3 scripts/torch_encode_first_call.py --fresh 20

It prints one JSON line per process and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAGES = ("rgb", "gline", "ycc", "c1f", "c2f", "phi", "sin", "cos", "chroma", "out")


class _Stop(Exception):
    """Raised after the NTSC comb3 check, so that the process ends there."""


def _child() -> None:
    import torch

    import chip_smoke
    from color_modem_tpu_torch.dsp.apply import fir_same
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
    from color_modem_tpu_torch.frame import pipeline
    from color_modem_tpu_torch.modem import qam

    calls = []
    encode_block = pipeline.encode_block

    def staged(plan, rgb, gline, backend="kernel"):
        if rgb.device.type != "cpu" or plan.cfg.is_fm:
            return encode_block(plan, rgb, gline, backend)
        st = {"rgb": rgb.clone(), "gline": gline.clone()}
        ycc = st["ycc"] = apply_mat3(plan.rgb_to_ycc, rgb.to(torch.float32))
        st["c1f"] = fir_same(ycc[..., 1, :, :], plan.c1_lpf_mat)
        st["c2f"] = fir_same(ycc[..., 2, :, :], plan.c2_lpf_mat)
        phi = st["phi"] = qam.carrier_phase(plan, gline)
        s = qam.v_sign(plan, gline)[..., None]
        st["sin"], st["cos"] = torch.sin(phi), torch.cos(phi)
        st["chroma"] = st["c1f"] * st["sin"] + s * st["c2f"] * st["cos"]
        st["out"] = ycc[..., 0, :, :] + st["chroma"]
        calls.append(st)
        return st["out"]

    pipeline.encode_block = staged
    check_path = chip_smoke.check_path

    def once(dev, name, decoder, *args):
        try:
            check_path(dev, name, decoder, *args)
            failed = None
        except AssertionError as e:
            failed = str(e)
        report(failed)
        raise _Stop

    def report(failed):
        rec = {"failed": failed, "threads": torch.get_num_threads(),
               "cpu_capability": torch.backends.cpu.get_cpu_capability(),
               "cpu_calls": len(calls)}
        if len(calls) >= 2:
            a, b = calls[0], calls[1]
            rec["first_vs_second"] = {
                k: float((a[k].double() - b[k].double()).abs().max()) for k in STAGES
                if a[k].shape == b[k].shape}
            for k in ("c1f", "c2f", "sin", "cos", "out"):
                d = (a[k].double() - b[k].double()).abs()
                if a[k].shape == b[k].shape and float(d.max()) > 0:
                    idx = torch.nonzero(d > 1e-6)
                    rec[f"{k}_over_1e-6"] = {"count": int(idx.shape[0]),
                                             "first": idx[:8].tolist(),
                                             "argmax": [int(i) for i in torch.unravel_index(
                                                 d.argmax(), d.shape)]}
        print(json.dumps(rec), flush=True)

    chip_smoke.check_path = once
    try:
        chip_smoke.main()
    except _Stop:
        pass


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fresh", type=int, default=20, help="fresh processes")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child()
        return
    failed = 0
    for i in range(args.fresh):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                             capture_output=True, text=True, cwd=REPO)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode or not lines:
            sys.stderr.write(res.stdout[-3000:] + res.stderr[-3000:])
            raise SystemExit(f"process {i} failed with code {res.returncode}")
        rec = json.loads(lines[-1])
        failed += rec["failed"] is not None
        print(json.dumps({"process": i, "seconds": round(time.perf_counter() - t0, 1), **rec}),
              flush=True)
        if rec["failed"]:
            print("\n".join(ln for ln in res.stdout.splitlines() if "failed" in ln), flush=True)
    print(f"{failed} of {args.fresh} fresh processes failed the phase 4 CPU encode check")


if __name__ == "__main__":
    main()
