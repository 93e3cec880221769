"""From a traced job's span opening to its first device operation: the
runner's per-call set-up (manifest, pipeline, plans, the hop's plan) before
the card gets work; the median over the traced jobs, on rank 0.  Layer:
video runner (``frame/video.py::process_video``)."""

import bisect
import statistics

from portbench import trace


def read(record):
    if record.get("unit") != "job":
        return None
    events = record["ranks"][0]["events"]
    starts = [ts for _, ts, _ in trace.device_ops(events)]
    starts.sort()
    waits = []
    for a, b in trace.spans(events, "portbench.job"):
        i = bisect.bisect_left(starts, a)
        if i < len(starts) and starts[i] <= b:
            waits.append((starts[i] - a) * 1e-3)
    return statistics.median(waits) if waits else None
