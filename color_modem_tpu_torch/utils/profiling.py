"""Tracing and timing helpers.

Port of ``color_modem_tpu/utils/profiling.py``.  ``trace(dir)`` wraps
``torch.profiler.profile`` and writes a Chrome/Perfetto trace into ``dir``
(TensorBoard's profiler plugin or ui.perfetto.dev reads it).  ``measure``
times a callable after a warm-up and reports its throughput against the
card's published peaks, the speed-of-light check.

On a CUDA tensor the windows are timed with CUDA events on that tensor's
card (``kernels/measure.py::time_ms``); on a CPU tensor with the host clock,
since that is where the work runs.  The JAX package's relay workarounds
(slope timing, a per-call input offset, ``force``) have no counterpart:
a CUDA event ends when the card has run the work before it.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import torch

from color_modem_tpu_torch.kernels.measure import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, time_ms

#: published peaks by ``torch.cuda.get_device_name`` (lower case): device
#: memory in GB/s and float32-accurate tensor-core TFLOP/s (TF32 over three
#: passes), from ``kernels/measure.py``.  Used for the roofline report only.
PEAKS = {
    "h100 80gb hbm3": {"hbm_gbps": HBM_BYTES_PER_S / 1e9, "f32_tflops": FP32_FLOPS_PER_S / 1e12},
}

#: the number of timed windows; the median and spread are over these
WINDOWS = 10


def chip_peaks(device: torch.device | str | None = None) -> dict:
    """The peaks of ``device`` (default: the current card); NaNs for an
    unknown card or the CPU, as the JAX package gives for an unknown chip."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device).lower()
        for k, v in PEAKS.items():
            if k in kind:
                return dict(v)
    return {"hbm_gbps": float("nan"), "f32_tflops": float("nan")}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace('/tmp/tb'): run()`` writes a
    ``*.pt.trace.json`` into ``log_dir``; the card's activity is traced too
    when CUDA is available.  The trace holds the package's own ``cm.*``
    spans (``utils/tracing.py``: the runner's stages, the hop, the
    pipeline's calls, every rebuilt plan) beside the operators and kernels,
    on the same clock; they are recorded only while a profiler records."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _host_ms(fn, iters: int, windows: int) -> list[float]:
    """Milliseconds per call in each of ``windows`` host-clock windows."""
    fn()
    per_call = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    return per_call


def _fraction(rate: float, peak: float) -> float | None:
    return rate / peak if math.isfinite(peak) else None


def measure(fn, *args, iters: int = 20, bytes_moved: float | None = None,
            flops: float | None = None) -> dict:
    """One warm-up call of ``fn(*args)``, then :data:`WINDOWS` windows of
    ``iters`` calls.  Returns ``seconds_per_call`` (the median window) and
    ``spread_seconds`` (its ``[min, max]``); with ``bytes_moved``/``flops``
    (per call, counted by the caller) also ``hbm_gbps`` and
    ``hbm_fraction_of_peak``, ``tflops`` and ``f32_fraction_of_peak``
    against :func:`chip_peaks` of the arguments' device (a fraction is None
    where the peak is unknown, as on the CPU)."""
    dev = _device_of(args)
    call = lambda: fn(*args)  # noqa: E731
    if dev.type == "cuda":
        # the events are recorded on, and synchronise, the current card
        with torch.cuda.device(dev):
            ms = time_ms(call, iters=iters, windows=WINDOWS, warmup=1)
    else:
        ms = _host_ms(call, iters, WINDOWS)
    dt = statistics.median(ms) / 1e3
    rep = {"seconds_per_call": dt, "spread_seconds": [min(ms) / 1e3, max(ms) / 1e3]}
    if bytes_moved is None and flops is None:
        return rep
    peaks = chip_peaks(dev)
    if bytes_moved is not None:
        rep["hbm_gbps"] = bytes_moved / dt / 1e9
        rep["hbm_fraction_of_peak"] = _fraction(rep["hbm_gbps"], peaks["hbm_gbps"])
    if flops is not None:
        rep["tflops"] = flops / dt / 1e12
        rep["f32_fraction_of_peak"] = _fraction(rep["tflops"], peaks["f32_tflops"])
    return rep
