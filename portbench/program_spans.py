"""The program's own spans in a traced run's record, for the per-layer
metrics that read them: the ``cm.*`` spans that ``color_modem_tpu_torch``
records under ``torch.profiler`` (``utils/tracing.py::SPANS``), on rank 0,
inside the harness's span around each traced unit (``portbench.job``,
``portbench.call``).  They read the host's clock with the profiler's host
recording on, which slows the host (``PERF.md``, section 3).  A program
that records no such span gives None, and so do its readers."""

from __future__ import annotations

import statistics

from portbench import trace

#: the harness span around a traced unit, by the record's unit
UNIT_SPANS = {"job": "portbench.job", "call": "portbench.call"}


def per_unit(record, unit: str) -> list[list[tuple[str, float, float]]] | None:
    """For each traced unit on rank 0, its ``cm.*`` spans ``(name, start,
    end)`` in microseconds, by start; None where the record is of another
    unit or holds no ``cm.*`` span in any traced unit."""
    if record.get("unit") != unit:
        return None
    events = record["ranks"][0]["events"]
    program = sorted((ts, ts + d, n) for c, n, ts, d in events
                     if c == "user_annotation" and n.startswith("cm."))
    units = [[(n, s, e) for s, e, n in program if a <= s and e <= b]
             for a, b in trace.spans(events, UNIT_SPANS[unit])]
    return units if any(units) else None


def lengths_ms(spans, name: str) -> list[float]:
    """The lengths, in milliseconds, of the spans called ``name``."""
    return [(e - s) * 1e-3 for n, s, e in spans if n == name]


def union_ms(spans, prefix: str) -> float:
    """Milliseconds covered by the spans whose name starts with ``prefix``:
    a span inside another is counted once."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted((x for x in spans if x[0].startswith(prefix)), key=lambda x: x[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total * 1e-3


def median_ms(record, unit: str, name: str) -> float | None:
    """The median length, in milliseconds, of the spans called ``name``
    inside the traced units; None where there is none."""
    units = per_unit(record, unit)
    got = [] if units is None else [ms for spans in units for ms in lengths_ms(spans, name)]
    return statistics.median(got) if got else None
