"""The traced run's record: ``torch.profiler`` over two fixed stretches of
the cell's work, read back from its Chrome trace into plain tuples that the
per-layer metrics (``portbench/metrics/``) read.  The first records the host
and the card (``events``); the host's recording slows it, so the device's
busy and idle time come from the second, which records the card alone
(``device_events``, ``device_window``).

An event is ``(cat, name, ts, dur)`` in microseconds on the profiler's
clock: device operations (``kernel``, ``gpu_memcpy``, ``gpu_memset``), CUDA
runtime calls (``cuda_runtime``, ``cuda_driver``), PyTorch operators
(``cpu_op``) and the harness's own spans (``user_annotation``, named
``portbench.*``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
#: the span around the whole traced stretch
SEGMENT = "portbench.segment"
#: longest kernel name kept in the breakdown
NAME_CHARS = 120


def _events(prof, scratch: str) -> list:
    """The profiler's events that the readers use, from its Chrome trace
    (written to ``scratch`` and deleted)."""
    path = os.path.join(scratch, f"portbench-trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    keep = DEVICE_CATS + HOST_CATS
    return [(e["cat"], e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
            for e in raw if e.get("ph") == "X" and e.get("cat") in keep]


@contextlib.contextmanager
def profiled(scratch: str, into: dict, device: torch.device):
    """Profile the block on the host and on ``device``'s card; afterwards
    ``into`` holds ``events``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        with torch.profiler.record_function(SEGMENT):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    into["events"] = _events(prof, scratch)


@contextlib.contextmanager
def device_profiled(scratch: str, into: dict, device: torch.device):
    """Profile only the card over the block, which then runs at close to
    its untraced pace (no host operator is recorded), between two marker
    operations on the card: afterwards ``into`` holds ``device_events``,
    the card's operations, and ``device_window``, (start of the first
    marker, end of the last) on the card's timeline.  The card is idle
    before the block begins, so the window starts when the block does and
    ends when its last work does.  Nothing is recorded on a CPU device."""
    if device.type != "cuda":
        yield
        return
    mark = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        mark.zero_()
        yield
        mark.zero_()
        torch.cuda.synchronize(device)
    ops = [e for e in _events(prof, scratch) if e[0] in DEVICE_CATS]
    into["device_events"] = ops
    if ops:
        into["device_window"] = (min(ts for _, _, ts, _ in ops),
                                 max(ts + d for _, _, ts, d in ops))


def segment(events) -> tuple[float, float]:
    """(start, end) of the traced stretch, in microseconds."""
    for cat, name, ts, dur in events:
        if cat == "user_annotation" and name == SEGMENT:
            return ts, ts + dur
    raise ValueError("the trace has no segment span")


def device_ops(events, cats=DEVICE_CATS) -> list:
    """Device operations ``(name, ts, dur)`` sorted by start."""
    return sorted((n, ts, d) for c, n, ts, d in events if c in cats)


def busy_intervals(events, window, skip: str | None = None) -> list[tuple[float, float]]:
    """The union of device operations inside ``window``, merged, sorted;
    ``skip``: leave out operations whose name holds it."""
    w0, w1 = window
    merged = []
    for name, ts, d in sorted(device_ops(events), key=lambda o: o[1]):
        if skip and skip in name:
            continue
        a, b = max(ts, w0), min(ts + d, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(iv) for iv in merged]


def device_busy(rec: dict) -> tuple[float, float] | None:
    """(busy, window) in seconds of a rank's card-only stretch: the union of
    its device operations, and the stretch's length; None where nothing
    ran on the card."""
    w = rec.get("device_window")
    if not w or w[1] <= w[0]:
        return None
    busy = sum(b - a for a, b in busy_intervals(rec["device_events"], w))
    return busy * 1e-6, (w[1] - w[0]) * 1e-6


def top_device_ops(events, k: int = 10) -> list:
    """``[name, seconds]`` of the ``k`` device operations that took most
    time, by name."""
    tot: dict = {}
    for name, _, d in device_ops(events):
        key = name[:NAME_CHARS]
        tot[key] = tot.get(key, 0.0) + d
    return [[n, s * 1e-6] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, k: int = 10) -> list:
    """``[what the host was doing, seconds]``: the device's idle time inside
    the traced stretch, by the innermost host event that covers the middle
    of each gap, the ``k`` largest totals."""
    w0, w1 = segment(events)
    busy = busy_intervals(events, (w0, w1))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted((ts, ts + d, n) for c, n, ts, d in events if c in HOST_CATS and n != SEGMENT)
    starts = [h[0] for h in host]
    tot: dict = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, e, n in host[max(0, i - 4000):i]:
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        label = best[2][:NAME_CHARS] if best else "no host event"
        tot[label] = tot.get(label, 0.0) + (b - a)
    return [[n, s * 1e-6] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def spans(events, name: str) -> list[tuple[float, float]]:
    """(start, end) of the harness spans called ``name``, by start."""
    return sorted((ts, ts + d) for c, n, ts, d in events
                  if c == "user_annotation" and n == name)
