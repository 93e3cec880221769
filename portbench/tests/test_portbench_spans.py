"""The readers of the program's spans (``portbench/program_spans.py`` and
the metrics that use it) on hand-built traces: each value, a build inside
another counted once, spans outside the traced units left out, and None
where the program records no span."""

import pytest

from portbench import harness, program_spans

JOB, CALL = "portbench.job", "portbench.call"


def ann(name, ts, dur):
    return ("user_annotation", name, float(ts), float(dur))


def record(unit, events, chunks=3):
    rec = {"unit": unit, "units": 2, "ranks": [{"events": events}]}
    if unit == "job":
        rec["chunks_per_unit"] = chunks
    return rec


#: two traced jobs of 3 chunks, 1000 us each; a build nested in a build, and
#: spans before the first job (the traced stretch's own set-up) ignored
JOBS = [
    ann("cm.video.setup", -500, 400), ann("cm.build.rf_plan", -450, 100),
    ann(JOB, 0, 1000),
    ann("cm.video.setup", 10, 200), ann("cm.build.rf_plan", 20, 100),
    ann("cm.build.table", 40, 30),
    ann("cm.video.step", 300, 100), ann("cm.build.memo", 310, 20),
    ann("cm.video.fetch", 500, 300),
    ("kernel", "vector_fft", 320.0, 50.0), ("cpu_op", "aten::add", 330.0, 5.0),
    ann(JOB, 2000, 1000),
    ann("cm.video.setup", 2010, 400), ann("cm.build.rf_plan", 2020, 150),
    ann("cm.video.fetch", 2500, 60), ann("cm.video.fetch", 2600, 40),
]
CALLS = [ann(CALL, 0, 100), ann("cm.pipeline.roundtrip", 5, 80),
         ann(CALL, 200, 100), ann("cm.pipeline.roundtrip", 205, 60),
         ann(CALL, 400, 100), ann("cm.pipeline.roundtrip", 405, 70)]

WANT = {
    # median of 0.2 and 0.4 ms
    "runner_setup_ms": ("job", JOBS, 0.3),
    # 3 builds in job 0 (one inside another), 1 in job 1
    "builds_per_job": ("job", JOBS, 2.0),
    # job 0: 0.1 (rf_plan holds the table) + 0.02; job 1: 0.15
    "build_ms_per_job": ("job", JOBS, (0.12 + 0.15) / 2),
    # 0.3 + 0.06 + 0.04 ms over 2 jobs of 3 chunks
    "fetch_wait_ms_per_chunk": ("job", JOBS, 0.4 / 6),
    "dispatch_ms_per_call": ("call", CALLS, 0.07),
}


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_value(metric):
    unit, events, want = WANT[metric]
    assert harness.metric_reader(metric)(record(unit, events)) == pytest.approx(want)


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_is_none_without_the_programs_spans(metric):
    unit, events, _ = WANT[metric]
    bare = [e for e in events if not e[1].startswith("cm.")]
    assert harness.metric_reader(metric)(record(unit, bare)) is None


@pytest.mark.parametrize("metric", list(WANT))
def test_reader_is_none_on_the_other_unit(metric):
    unit, events, _ = WANT[metric]
    other = "call" if unit == "job" else "job"
    assert harness.metric_reader(metric)(record(other, events)) is None


def test_builds_read_zero_where_nothing_is_built():
    """A program that records its stages but builds nothing reads 0, not
    None: the count a caching change drives down."""
    events = [e for e in JOBS if not e[1].startswith("cm.build.")]
    rec = record("job", events)
    assert harness.metric_reader("builds_per_job")(rec) == 0
    assert harness.metric_reader("build_ms_per_job")(rec) == 0


def test_union_counts_nested_and_overlapping_spans_once():
    spans = [("cm.build.a", 0, 100), ("cm.build.b", 10, 50), ("cm.build.c", 90, 150),
             ("cm.build.d", 200, 210), ("cm.video.step", 0, 1000)]
    assert program_spans.union_ms(spans, "cm.build.") == pytest.approx(0.16)


def test_spans_outside_the_units_are_left_out():
    units = program_spans.per_unit(record("job", JOBS), "job")
    assert len(units) == 2
    assert all(s >= 0 for spans in units for _, s, _ in spans)
    assert [n for n, _, _ in units[1]] == ["cm.video.setup", "cm.build.rf_plan",
                                          "cm.video.fetch", "cm.video.fetch"]
