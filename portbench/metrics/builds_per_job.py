"""Builds per traced job: the program's ``cm.build.*`` spans (RF plan, a
plan's copy to the card, memoised taps, spectra, carrier tables, the
kernel library), each of which runs only on a cache miss, on rank 0.
Layer: video runner (``frame/video.py::process_video`` and what it
builds)."""

from portbench import program_spans


def read(record):
    units = program_spans.per_unit(record, "job")
    if units is None:
        return None
    return sum(1 for spans in units for n, _, _ in spans
               if n.startswith("cm.build.")) / len(units)
