"""Host milliseconds per traced job inside the program's outermost
``cm.build.*`` spans (a build inside another counted once), on rank 0,
with the profiler recording.  Layer: video runner
(``frame/video.py::process_video`` and what it builds)."""

from portbench import program_spans


def read(record):
    units = program_spans.per_unit(record, "job")
    if units is None:
        return None
    return sum(program_spans.union_ms(spans, "cm.build.") for spans in units) / len(units)
