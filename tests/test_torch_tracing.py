"""The port's spans (``color_modem_tpu_torch/utils/tracing.py``): off, a
shared null context; under ``torch.profiler``, recorded where
``SPANS`` says, nested as the runner's stages are, covering the runner's
call, and changing nothing the runner computes or writes."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from color_modem_tpu_torch.dsp.apply import kernel_spectrum
from color_modem_tpu_torch.dsp.stream import plan_memo
from color_modem_tpu_torch.frame import rf as rf_mod
from color_modem_tpu_torch.frame.pipeline import make_pipeline
from color_modem_tpu_torch.frame.video import process_video, synthetic_source
from color_modem_tpu_torch.modem.plan import make_plan
from color_modem_tpu_torch.standards import ALL_STANDARDS
from color_modem_tpu_torch.utils.manifest import MANIFEST_NAME
from color_modem_tpu_torch.utils.tracing import SPANS, span
from torch_threads import one_torch_thread  # noqa: F401

L, N, FRAMES, CHUNK = 32, 720, 5, 2
PACKAGE = Path(__file__).resolve().parents[1] / "color_modem_tpu_torch"
#: the runner's stages, one after another inside its call
TOP = ("cm.video.setup", "cm.video.read", "cm.video.step", "cm.video.fetch",
       "cm.video.record", "cm.video.summary")
#: (span, the span that encloses it) in an RF run
NESTED = [("cm.build.rf_plan", "cm.video.setup"), ("cm.pipeline.encode", "cm.video.step"),
          ("cm.hop", "cm.video.step"), ("cm.build.memo", "cm.hop"),
          ("cm.pipeline.decode", "cm.video.step")]
#: summary keys that read the host's clock
CLOCK_KEYS = ("mpix_per_s", "seconds")


def _plan():
    return make_plan(ALL_STANDARDS["ntsc"](), N)


def _recorded(fn):
    """``fn()`` under a CPU profiler inside an outer span ``test.call``;
    its result and the recorded spans ``(name, start, end)`` by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.call"):
            out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(("cm.", "test.call"))]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One small RF run untraced, then one under the profiler, each into a
    directory of its own."""
    root = tmp_path_factory.mktemp("runs")
    plan = _plan()

    def run(name):
        d = str(root / name)
        return d, process_video(plan, synthetic_source(L, N), FRAMES, d, decoder="comb3",
                                chunk=CHUNK, rf=True, device="cpu")

    plain = run("plain")
    traced, spans = _recorded(lambda: run("traced"))
    return {"plain": plain, "traced": traced, "spans": spans}


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    off = span("cm.hop")
    assert off is span("cm.video.read")
    with off as got:
        assert got is None


def test_the_runner_records_every_stage_and_a_build(runs):
    names = {n for n, _, _ in runs["spans"]}
    assert set(TOP) | {"cm.hop", "cm.pipeline.encode", "cm.pipeline.decode"} <= names
    assert any(n.startswith("cm.build.") for n in names)
    assert names - {"test.call"} <= set(SPANS)
    chunks = -(-FRAMES // CHUNK)
    count = {n: sum(1 for m, _, _ in runs["spans"] if m == n) for n in names}
    assert count["cm.video.read"] == count["cm.video.step"] == count["cm.hop"] == chunks
    assert count["cm.video.setup"] == count["cm.video.summary"] == 1


@pytest.mark.parametrize("inner,outer", NESTED, ids=[i for i, _ in NESTED])
def test_spans_nest_as_the_stages_do(runs, inner, outer):
    spans = runs["spans"]
    found = [s for s in spans if s[0] == inner]
    assert found
    for s in found:
        assert any(_inside(s, o) for o in spans if o[0] == outer), s


def test_the_stages_do_not_overlap_and_cover_the_call(runs):
    spans = runs["spans"]
    call = next(s for s in spans if s[0] == "test.call")
    top = [s for s in spans if s[0] in TOP]
    assert all(_inside(s, call) for s in top)
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1], (a, b)
    covered = sum(e - s for _, s, e in top)
    assert covered >= 0.8 * (call[2] - call[1])


def test_the_profiler_changes_no_output(runs):
    (d0, s0), (d1, s1) = runs["plain"], runs["traced"]

    def strip(s):
        return {k: v for k, v in s.items() if k not in CLOCK_KEYS}

    assert strip(s0) == strip(s1)
    manifests = [json.loads(Path(d, MANIFEST_NAME).read_text()) for d in (d0, d1)]
    assert manifests[0] == manifests[1]


@pytest.mark.parametrize("which", ["encode", "decode", "roundtrip"])
def test_each_pipeline_call_is_one_span(which):
    enc, dec, rt = make_pipeline(_plan(), "comb3", "plain", "cpu")
    rgb = torch.rand(2, 3, 16, N)
    fn, x = {"encode": (enc, rgb), "decode": (dec, enc(rgb)), "roundtrip": (rt, rgb)}[which]
    _, spans = _recorded(lambda: [fn(x, k) for k in range(3)])
    assert [n for n, _, _ in spans if n.startswith("cm.")] == [f"cm.pipeline.{which}"] * 3


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_the_delayline_step_is_a_span_inside_the_decode(backend):
    """PAL's delay-line decode dispatches its delay line and matrix (one
    pass on the kernel backend) inside ``cm.pipeline.delayline``, within
    the decode's span; a comb decode records no such span (on the kernel
    backend its line stencil's, ``cm.pipeline.stencil``)."""
    plan = make_plan(ALL_STANDARDS["pal"](), N)
    enc, dec, _ = make_pipeline(plan, "delayline", backend, "cpu")
    comp = enc(torch.rand(2, 3, 16, N), 0)
    _, spans = _recorded(lambda: dec(comp, 0))
    got = [s for s in spans if s[0].startswith("cm.")]
    assert [n for n, _, _ in got] == ["cm.pipeline.decode", "cm.pipeline.delayline"]
    assert _inside(got[1], got[0])
    comb = make_pipeline(plan, "comb3", backend, "cpu")[1]
    _, spans = _recorded(lambda: comb(comp, 0))
    assert [n for n, _, _ in spans if n.startswith("cm.")] == (
        ["cm.pipeline.decode"] + ["cm.pipeline.stencil"] * (backend == "kernel"))


@pytest.mark.parametrize("name,decoder", [("ntsc", "comb3"), ("ntsc", "comb2"),
                                          ("pal", "comb3"), ("pal", "comb2")])
def test_the_comb_stencil_is_a_span_inside_the_decode(name, decoder):
    """On the kernel backend a 'comb2' or 'comb3' decode dispatches its line
    stencil inside ``cm.pipeline.stencil``, within the decode's span; the
    plain backend and a notch decode record no such span."""
    plan = make_plan(ALL_STANDARDS[name](), N)
    comp = make_pipeline(plan, decoder, "kernel", "cpu")[0](torch.rand(2, 3, 16, N), 0)
    for backend, want in (("kernel", ["cm.pipeline.decode", "cm.pipeline.stencil"]),
                          ("plain", ["cm.pipeline.decode"])):
        dec = make_pipeline(plan, decoder, backend, "cpu")[1]
        _, spans = _recorded(lambda: dec(comp, 0))
        got = [s for s in spans if s[0].startswith("cm.")]
        assert [n for n, _, _ in got] == want
        if backend == "kernel":
            assert _inside(got[1], got[0])
    notch = make_pipeline(plan, "notch", "kernel", "cpu")[1]
    _, spans = _recorded(lambda: notch(comp, 0))
    assert [n for n, _, _ in spans if n.startswith("cm.")] == ["cm.pipeline.decode"]


class _Holder:
    """A stand-in for a hop plan: ``plan_memo`` keeps its memo in the
    instance's ``__dict__``."""


_HOLDER = _Holder()
#: each build with a key no other test uses: its first call is a miss
BUILDS = {
    "memo": lambda: plan_memo(_HOLDER, "k", lambda: 1.0),
    "spectrum": lambda: kernel_spectrum(np.array([1.0, 0.3125, 0.5]), 8, True, "cpu"),
    "table": lambda: rf_mod._upload(np.array([0.3125, 2.0]), "cpu"),
}


@pytest.mark.parametrize("kind", list(BUILDS))
def test_a_build_span_marks_a_miss_only(kind):
    """The first call builds, inside its span; the second is a hit and
    records nothing."""
    _, first = _recorded(BUILDS[kind])
    _, again = _recorded(BUILDS[kind])
    assert [n for n, _, _ in first if n != "test.call"] == [f"cm.build.{kind}"]
    assert [n for n, _, _ in again if n != "test.call"] == []


def _literals() -> set[str]:
    found = set()
    for path in PACKAGE.rglob("*.py"):
        found |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    return found


def test_every_span_in_the_package_is_catalogued():
    assert _literals() <= set(SPANS)


def test_every_catalogued_span_is_used():
    assert set(SPANS) <= _literals()
