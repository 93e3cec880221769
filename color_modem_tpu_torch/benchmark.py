"""One-card benchmark of the port: prints ONE JSON line.

Port of ``color_modem_tpu/benchmark.py``.  Metric: encode + decode round-trip
throughput in Mpix/s on one card for a standard, decoder and batch (default
NTSC comb3, 16 frames of 480 x 720, the main path); ``vs_baseline`` is the
speedup over the reference's estimated ceiling of 1 Mpix/s (BASELINE.md),
i.e. value / 1.0.  The PSNR of the first output against its input is the
health check, in the metric string.

    python -m color_modem_tpu_torch.benchmark [--batch B] [--iters K] \\
        [--standard ntsc] [--decoder comb3] [--backend kernel|plain] [--roofline]
    python -m color_modem_tpu_torch.cli bench [same flags]

The input is ``smooth_scene(lines, samples, seed=0)`` broadcast to the
batch, on the device before timing.  Timing (``utils/profiling.py::
measure``): one warm-up call, then 10 windows of ``--iters`` calls, CUDA
events on a card (the host clock with ``--device cpu``); the median window
and the spread ``[min, max]``.  The pipeline runs its float32 products
with TF32 off (``dsp/apply.py::full_float32``).

Besides the line, ``results/bench_{standard}_{decoder}_{backend}.json``
(relative to the working directory) keeps the JAX benchmark's record keys
plus ``device_name``, ``power_limit_w`` (``nvidia-smi``; null on the CPU
or where it cannot be read),
``spread_mpix_per_s`` and ``kernel_launches`` (each launch counter's
increase per call).  With ``--roofline`` a ``{"roofline": ...}`` line is
printed before the metric line and kept in the record; see
:func:`logical_work` for what it counts.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: flops per pixel of one 3x3 colour matrix (9 products, 9 sums)
MAT3_FLOPS = 18
#: least device-memory bytes per pixel of a round trip: RGB float32 read
#: once and written once
RGB_BYTES = 24


def add_bench_args(ap) -> None:
    """Benchmark flags, shared by this module and the ``bench`` CLI verb.
    JAX's flags by the same names and defaults, except ``--backend``
    (``kernel|plain``, as every verb of the port's CLI), ``--iters`` (calls
    per window, 10 windows) and ``--device``."""
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20,
                    help="calls per timed window (10 windows; median and spread)")
    ap.add_argument("--standard", default="ntsc")
    ap.add_argument("--decoder", default="comb3")
    ap.add_argument("--lines", type=int, default=0, help="0 = standard active lines")
    ap.add_argument("--samples", type=int, default=720)
    ap.add_argument("--backend", default="kernel", choices=("kernel", "plain"),
                    help="kernel (the CUDA kernels) | plain (plain PyTorch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; 'cpu' for a CPU run)")
    ap.add_argument("--roofline", action="store_true",
                    help="also report achieved TFLOP/s and GB/s against the card's peaks")


def path_kernels(plan, decoder: str) -> tuple:
    """The kernels a kernel-backend round trip launches once each: SECAM's
    pair, or the QAM encode and, unless the decoder is an adaptive comb
    (whose separation and detection are plain code), the QAM decode."""
    from color_modem_tpu_torch.separate.comb import ADAPTIVE

    if plan.cfg.is_fm:
        return ("secam_encode", "secam_decode")
    return ("qam_encode",) if decoder in ADAPTIVE else ("qam_encode", "qam_decode")


def logical_work(plan, decoder: str, batch: int, lines: int) -> tuple[float, float]:
    """``(flops, bytes)`` of one round trip, from the plan and the shape only,
    so the count is the same whichever backend runs it.  Flops: the FIRs of
    :func:`path_kernels` (``kernels/measure.py::kernel_flops``) and
    :data:`MAT3_FLOPS` per pixel for each of the two colour matrices; the
    comb stencils and the chroma hooks are left out.  Bytes: the least
    device-memory traffic, :data:`RGB_BYTES` per pixel."""
    from color_modem_tpu_torch.kernels.measure import kernel_flops

    pixels = batch * lines * plan.n_samples
    flops = sum(kernel_flops(plan, k, batch * lines) for k in path_kernels(plan, decoder))
    return flops + 2 * MAT3_FLOPS * pixels, float(RGB_BYTES * pixels)


def _uuid(text: str) -> str:
    return text.strip().lower().removeprefix("gpu-")


def power_limit_w(device) -> float | None:
    """The card's power limit in W as ``nvidia-smi`` reads it, found by the
    card's UUID (torch's device index is not ``nvidia-smi``'s under
    ``CUDA_VISIBLE_DEVICES``); None on the CPU, or where it cannot be
    read."""
    if device.type != "cuda":
        return None
    import torch

    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return None if uuid is None else card_power_limit_w(str(uuid))


def card_power_limit_w(uuid: str) -> float | None:
    """The power limit in W of the card with ``uuid`` from ``nvidia-smi
    --query-gpu=uuid,power.limit``; None where ``nvidia-smi`` is missing,
    fails, lists no such card or prints no number (``[N/A]``)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    for row in res.stdout.splitlines():
        fields = row.split(",")
        if len(fields) == 2 and _uuid(fields[0]) == _uuid(uuid):
            try:
                return float(fields[1])
            except ValueError:
                return None
    return None


def _num(v, nd):
    # NaN or an unknown peak is not valid JSON
    return round(v, nd) if v is not None and math.isfinite(v) else None


def run(args) -> dict:
    """Run the benchmark for parsed ``args``; print the line, write the
    record and return it."""
    import torch

    from color_modem_tpu_torch.frame.pipeline import make_pipeline, resolve_device
    from color_modem_tpu_torch.kernels import launch_counts
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.standards import ALL_STANDARDS
    from color_modem_tpu_torch.standards.decoders import allowed_decoders
    from color_modem_tpu_torch.utils.metrics import psnr
    from color_modem_tpu_torch.utils.profiling import chip_peaks, measure
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    dev = resolve_device(args.device)
    cfg = ALL_STANDARDS[args.standard]()
    lines = args.lines or cfg.active_lines
    plan = make_plan(cfg, args.samples)
    if args.decoder not in allowed_decoders(cfg):
        fallback = allowed_decoders(cfg)[0]
        print(f"bench: {cfg.name} does not support decoder {args.decoder!r}; "
              f"benchmarking {fallback!r} instead", file=sys.stderr)
        args.decoder = fallback
    backend = args.backend

    # band-limited scene: makes the reported PSNR a meaningful health check
    one = smooth_scene(lines, args.samples, seed=0)
    rgb = torch.tensor(np.broadcast_to(one, (args.batch, 3, lines, args.samples)),
                       dtype=torch.float32, device=dev)
    _, _, rt = make_pipeline(plan, args.decoder, backend, dev)
    quality = psnr(rt(rgb, 0), rgb)

    calls = [0]

    def counted(x, frame0):
        calls[0] += 1
        return rt(x, frame0)

    flops, byt = logical_work(plan, args.decoder, args.batch, lines)
    before = launch_counts()
    rep = measure(counted, rgb, 0, iters=args.iters)
    after = launch_counts()
    dt = rep["seconds_per_call"]
    pixels = args.batch * lines * args.samples
    mpix_s = pixels / dt / 1e6
    scanlines_s = args.batch * lines / dt

    record = {
        "ts": time.time(),
        "standard": args.standard,
        "decoder": args.decoder,
        "backend": backend,
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "power_limit_w": power_limit_w(dev),
        "shape": [args.batch, lines, args.samples],
        "iters": args.iters,
        "mpix_per_s": round(mpix_s, 1),
        "spread_mpix_per_s": [pixels / t / 1e6 for t in reversed(rep["spread_seconds"])],
        "scanlines_per_s": round(scanlines_s),
        "seconds_per_call": dt,
        "roundtrip_psnr_db": round(float(quality), 2),
        "kernel_launches": {k: (after[k] - before[k]) / calls[0] for k in after},
    }
    if args.roofline:
        # one lookup of the card's peaks gives the bound and both shares;
        # an unknown card or the CPU has NaN peaks, so all four are null
        peaks = chip_peaks(dev)
        tflops, gbps = flops / dt / 1e12, byt / dt / 1e9
        t_bytes, t_ops = byt / (peaks["hbm_gbps"] * 1e9), flops / (peaks["f32_tflops"] * 1e12)
        known = math.isfinite(t_bytes) and math.isfinite(t_ops)
        record["roofline"] = {
            "flops_per_call": flops,
            "bytes_per_call": byt,
            "bound_ms": 1e3 * max(t_bytes, t_ops) if known else None,
            "logical_tflops": _num(tflops, 2),
            "tflops_fraction_of_f32_peak": _num(tflops / peaks["f32_tflops"], 3),
            "hbm_gbps": _num(gbps, 1),
            "hbm_fraction_of_peak": _num(gbps / peaks["hbm_gbps"], 3),
            "binding_constraint": ("bytes" if t_bytes >= t_ops else "operations")
                                  if known else None,
        }
        print(json.dumps({"roofline": record["roofline"]}))

    where = "1 card" if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": f"{args.standard}-{args.decoder} roundtrip throughput ({where}, {backend}, "
                  f"{args.batch}x{lines}x{args.samples}, psnr={quality:.1f}dB, "
                  f"{scanlines_s:,.0f} scanlines/s)",
        "value": round(mpix_s, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / 1.0, 1),
    }))

    os.makedirs("results", exist_ok=True)
    path = f"results/bench_{args.standard}_{args.decoder}_{backend}.json"
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_bench_args(ap)
    run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
