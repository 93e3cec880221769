"""The host's dispatch of one round-trip call: the length of the
program's ``cm.pipeline.roundtrip`` span (``make_pipeline``'s
``roundtrip``: the host returns once every launch is enqueued, so where
the card paces the calls the span also holds the waits for launch-queue
slots), the median over the traced calls, on rank 0, with the profiler
recording.  Layer: pipeline (``frame/pipeline.py``)."""

from portbench import program_spans


def read(record):
    return program_spans.median_ms(record, "call", "cm.pipeline.roundtrip")
