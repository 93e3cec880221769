"""Blocking CUDA runtime calls per runner chunk: stream, device and event
synchronisations and synchronous copies inside the traced jobs' spans (so
not the harness's own closing synchronise), the most over the ranks.
Layer: video runner (``frame/video.py::process_video``)."""

from portbench import trace

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")


def read(record):
    if record.get("unit") != "job":
        return None
    chunks = record["units"] * record["chunks_per_unit"]
    counts = []
    for r in record["ranks"]:
        jobs = trace.spans(r["events"], "portbench.job")
        counts.append(sum(1 for c, n, ts, _ in r["events"]
                          if c == "cuda_runtime" and n in BLOCKING
                          and any(a <= ts <= b for a, b in jobs)))
    return max(counts) / chunks
