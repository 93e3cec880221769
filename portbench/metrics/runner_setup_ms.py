"""The runner's per-call set-up: the length of ``process_video``'s
``cm.video.setup`` span (checks, manifest, pipeline factory, hop plan,
sound track), the median over the traced jobs, on rank 0, host clock
with the profiler recording.  Layer: video runner
(``frame/video.py::process_video``)."""

from portbench import program_spans


def read(record):
    return program_spans.median_ms(record, "job", "cm.video.setup")
