"""Host milliseconds per runner chunk in the program's ``cm.video.fetch``
spans: each wave's one stacked device-to-host fetch, where the runner
waits for the card, on rank 0, with the profiler recording.  Layer: video
runner (``frame/video.py::process_video``)."""

from portbench import program_spans


def read(record):
    units = program_spans.per_unit(record, "job")
    if units is None:
        return None
    waits = [ms for spans in units for ms in program_spans.lengths_ms(spans, "cm.video.fetch")]
    if not waits:
        return None
    return sum(waits) / (len(units) * record["chunks_per_unit"])
