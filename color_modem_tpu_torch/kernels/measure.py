"""What a kernel's times are held against: the least time the card could
take for a launch's work, and CUDA-event timing.  The pipelines never call
this module; the benchmark (``benchmark.py`` through
``utils/profiling.py``), ``chip_smoke.py`` and
``scripts/torch_kernel_ab.py`` read it, so their peaks, bounds and windows
are the same.

It imports nothing of the package (a plan is read by its attributes only),
so a script may load this file by its path while it times another tree.
"""

from __future__ import annotations

#: the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
#: memory, and float32-accurate products on the tensor cores (495 TFLOP/s of
#: TF32 over three passes)
HBM_BYTES_PER_S, FP32_FLOPS_PER_S = 3.35e12, 495e12 / 3


def kernel_flops(plan, kernel: str, n_lines: int) -> float:
    """The FIRs' flops of one launch on ``n_lines`` lines: 2 per tap per
    sample, each filter at the width its kernel filters.  SECAM decode runs
    five filters over the extended line N + 2M and ``demod_lpf`` over the
    cropped N alone (``csrc/secam_decode.cu``)."""
    n = plan.n_samples
    if kernel in ("qam_encode", "qam_decode"):
        filters = 2 if kernel == "qam_encode" else 3
        return 2.0 * plan.c1_lpf.numel() * filters * n_lines * n
    if kernel == "secam_encode":
        taps = plan.comp_lpf.numel() + plan.preemph.numel() + plan.anticloche.numel()
        return 2.0 * taps * n_lines * n
    if kernel == "secam_decode":
        ext = (2 * plan.bell_takeoff.numel() + 2 * plan.mix_lpf.numel()
               + 2 * plan.diff.numel() + plan.deemph.numel())
        return 2.0 * n_lines * (ext * (n + 2 * plan.fm_margin)
                                + plan.demod_lpf.numel() * n)
    raise ValueError(f"unknown kernel {kernel!r}")


#: line planes each kernel reads and writes once: QAM encode y, c1, c2 in
#: and the composite out; decode sep and comp in, y, c1, c2 out; SECAM
#: encode y and the line's own chroma plane in, the composite out; SECAM
#: decode the composite in, luma and the FM component out
PLANES = {"qam_encode": 4, "qam_decode": 5, "secam_encode": 3, "secam_decode": 3}


def kernel_bound(plan, kernel: str, n_lines: int) -> tuple[float, str]:
    """The least time of one launch in ms, and what sets it: the line planes
    read and written once over the memory rate ("bytes"), or the FIRs' flops
    over the float32-accurate tensor-core rate ("operations"), whichever is
    larger.  The per-line columns, ramps and taps add under 0.1% and are
    left out."""
    t_bytes = 4.0 * PLANES[kernel] * n_lines * plan.n_samples / HBM_BYTES_PER_S
    t_ops = kernel_flops(plan, kernel, n_lines) / FP32_FLOPS_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def colour_matrix_bound(values: int) -> tuple[float, str]:
    """The least time in ms of one pass of ``csrc/colour_matrix.cu`` over
    ``values`` input samples (the three planes of every group), and what
    sets it: each sample read once and each output written once, 8 bytes a
    sample (6 planes per group of 3) over the memory rate ("bytes"), 2.39 us
    per million samples.  Its 3 multiply-adds a sample take 0.09 us per
    million on the 67 TFLOP/s float32 lanes, 27 times less."""
    return 1e3 * 8.0 * values / HBM_BYTES_PER_S, "bytes"


def comb_stencil_bound(samples: int) -> tuple[float, str]:
    """The least time in ms of one pass of ``csrc/comb_stencil.cu`` over
    ``samples`` composite samples, and what sets it: the composite read once
    and the stencil signal written once, 8 bytes a sample, over the memory
    rate ("bytes"), 0.0528 ms at 64 x 480 x 720.  Its three operations a
    sample take 0.09 us per million on the float32 lanes, 27 times less."""
    return 1e3 * 8.0 * samples / HBM_BYTES_PER_S, "bytes"


#: 32-bit integer operations per second of the INT32 lanes alone: 64 on
#: each of 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper
#: architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: operations per value of ``csrc/threefry.cu`` that only the INT32 lanes
#: run, by entry point: the hash's 20 rotations (funnel shifts) and 20
#: xors and the xor of its two words (the bits); the normal adds the shift
#: and or that make the float's mantissa.  The hash's 32 adds (the rounds'
#: and the key injections') the compiler may issue to the float lanes as
#: integer multiply-adds, beside the ~45 float operations of the normal:
#: 77 of the 128 float lanes' 2 x 64, under the INT32 lanes' time.
THREEFRY_INT_OPS = {"threefry_bits": 41, "threefry_add_normal": 43}


def threefry_bound(entry: str, words: int, bytes_per_word: int) -> tuple[float, str]:
    """The least time in ms of one launch of the threefry entry point
    ``entry`` over ``words`` values, and what sets it: ``bytes_per_word``
    read and written once (4 for the bits, 8 for ``x + sigma * normal``, 4
    for the normal alone) over the memory rate ("bytes"), or the operations
    only the INT32 lanes run (:data:`THREEFRY_INT_OPS`) over their rate
    ("operations"), whichever is larger."""
    t_bytes = bytes_per_word * words / HBM_BYTES_PER_S
    t_ops = THREEFRY_INT_OPS[entry] * words / INT32_OPS_PER_S
    return (1e3 * t_bytes, "bytes") if t_bytes >= t_ops else (1e3 * t_ops, "operations")


def time_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3) -> list[float]:
    """Milliseconds per call in each of ``windows`` CUDA-event windows of
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return per_call
