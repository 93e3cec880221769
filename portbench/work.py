"""The work a cell's calls need, counted from the configuration's shapes and
taps alone, and the card's published peaks: what the rooflines divide by.

Frozen copies of the program's arithmetic as it stood when the benchmark
was written (``kernels/measure.py::kernel_flops``, ``PLANES``,
``benchmark.py::logical_work``), so a later change to the program cannot
move the yardstick.  The one change: operations are held against the
published dense TF32 peak, which no float32-accurate method can beat,
where the program's bound takes its own kernels' rate (TF32 in three
passes, a third of it).
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: device
#: memory bytes/s, TF32 tensor-core FLOP/s, the power limit in W
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
POWER_LIMIT_W = 700.0

#: flops per pixel of one 3x3 colour matrix (9 products, 9 sums)
MAT3_FLOPS = 18
#: least device-memory bytes per pixel of a round trip: float32 RGB read
#: once and written once
RGB_BYTES = 24
#: line planes each kernel reads and writes once: QAM encode y, c1, c2 in
#: and the composite out; decode the separated signal and the composite
#: in, y, c1, c2 out; SECAM encode y and the line's own chroma plane in,
#: the composite out; SECAM decode the composite in, luma and the FM
#: component out
PLANES = {"qam_encode": 4, "qam_decode": 5, "secam_encode": 3, "secam_decode": 3}

#: the system's tap counts at the 720-sample BT.601 line (13.5 MHz); each
#: scales with the sample rate (``_odd(count * fs / 13.5 MHz)``)
REF_FS = 13.5e6
QAM_NTAPS = 129
SECAM_NTAPS = {"lpf": 129, "bell": 193, "diff": 31, "emph": 257}
SECAM_MARGIN = 48


def _odd(x: float) -> int:
    v = max(3, int(round(x)))
    return v if v % 2 == 1 else v + 1


def sample_rate(cfg: dict) -> float:
    return cfg["samples"] / cfg["params"]["t_active"]


def is_fm(cfg: dict) -> bool:
    return "f0r" in cfg["params"]


def kernels(cfg: dict) -> tuple:
    """The kernels one round trip launches once each: SECAM's pair, or the
    QAM pair (the comb decoders' separation feeds the QAM decode kernel)."""
    return ("secam_encode", "secam_decode") if is_fm(cfg) else ("qam_encode", "qam_decode")


def kernel_flops(cfg: dict, kernel: str, n_lines: int) -> float:
    """The FIRs' flops of one launch on ``n_lines`` lines: 2 per tap per
    sample, each filter at the width its kernel filters; SECAM decode runs
    five filters over the extended line N + 2M and its last low-pass over
    N alone."""
    n = cfg["samples"]
    k = sample_rate(cfg) / REF_FS
    if kernel in ("qam_encode", "qam_decode"):
        filters = 2 if kernel == "qam_encode" else 3
        return 2.0 * _odd(QAM_NTAPS * k) * filters * n_lines * n
    lpf, bell, diff, emph = (_odd(SECAM_NTAPS[f] * k) for f in ("lpf", "bell", "diff", "emph"))
    if kernel == "secam_encode":
        return 2.0 * (lpf + emph + bell) * n_lines * n
    if kernel == "secam_decode":
        margin = int(round(SECAM_MARGIN * k))
        ext = 2 * bell + 2 * lpf + 2 * diff + emph
        return 2.0 * n_lines * (ext * (n + 2 * margin) + lpf * n)
    raise ValueError(f"unknown kernel {kernel!r}")


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of ``flops`` and ``nbytes`` on the card, and which of
    the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound_s(cfg: dict, kernel: str, n_lines: int) -> tuple[float, str]:
    """The least time of one launch: its line planes read and written once,
    or its FIRs' flops, whichever is longer."""
    nbytes = 4.0 * PLANES[kernel] * n_lines * cfg["samples"]
    return bound_s(kernel_flops(cfg, kernel, n_lines), nbytes)


def roundtrip_work(cfg: dict, frames: int) -> tuple[float, float]:
    """``(flops, bytes)`` of one round trip of ``frames`` frames: the
    kernels' FIRs and the two colour matrices; the least memory traffic,
    the RGB read and written once.  The comb stencils and the hooks are
    left out, so the count is the same whatever implements them."""
    pixels = frames * cfg["lines"] * cfg["samples"]
    flops = sum(kernel_flops(cfg, k, frames * cfg["lines"]) for k in kernels(cfg))
    return flops + 2 * MAT3_FLOPS * pixels, float(RGB_BYTES * pixels)
