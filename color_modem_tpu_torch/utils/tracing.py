"""Spans: named stretches of the host's work, recorded by ``torch.profiler``.

``with span("cm.video.fetch"): ...`` is ``torch.profiler.record_function``
while a profiler records (``utils/profiling.py::trace``, or any
``torch.profiler.profile`` around the call), so the span lands in the same
trace as the operators and the card's kernels, on the profiler's clock.
With no profiler recording it is one shared ``contextlib.nullcontext``:
one C call per span.  A span never synchronises the card, allocates a
tensor or reads a tensor's value.  Spans nest by time on the host thread;
the enclosing span is the parent.

:data:`SPANS` is the catalogue.  The ``cm.build.*`` spans wrap work that
runs only when something is built (a cache miss): their number counts the
builds and their length is what the builds cost.
"""

from __future__ import annotations

import contextlib

import torch

#: every span the package records, with what it covers
SPANS = {
    "cm.video.setup": "process_video from entry to the loop: checks, manifest open and "
                      "config check, pipeline factory, hop plan, sound track",
    "cm.video.read": "a chunk's frames (this rank's block) and sound to the device",
    "cm.video.step": "one chunk's round trip, link, NR, PSNR and fingerprint enqueued",
    "cm.video.fetch": "a wave's one stacked device-to-host fetch: the runner waits for the card",
    "cm.video.record": "a wave's saved frames, audio and caption files and manifest marks",
    "cm.video.summary": "after the last wave: the summary file, the mesh's barrier",
    "cm.hop": "the runner's transmission hop (RF or satellite), dispatched",
    "cm.pipeline.encode": "make_pipeline's encode call, dispatched",
    "cm.pipeline.decode": "make_pipeline's decode call, dispatched",
    "cm.pipeline.roundtrip": "make_pipeline's roundtrip call, dispatched",
    "cm.pipeline.stencil": "_demodulate_qam's line stencil of 'comb2' and 'comb3' on the "
                           "kernel backend (one pass), dispatched",
    "cm.pipeline.delayline": "decode_block's delay line and decoder's matrix, for every "
                             "averaging decoder (one pass on the kernel backend), dispatched",
    "cm.build.rf_plan": "frame/rf.py::make_rf_plan: the RF geometry and its float64 filter design",
    "cm.build.plan_copy": "modem/plan.py::plan_on: a plan's buffers copied to another device",
    "cm.build.memo": "dsp/stream.py::plan_memo: a hop plan's composed taps built",
    "cm.build.spectrum": "dsp/apply.py::_spectrum_cached: a filter's spectrum computed "
                         "and uploaded",
    "cm.build.table": "frame/rf.py::_table: a carrier table uploaded",
    "cm.build.library": "kernels/build.py::load_library: the CUDA library built or loaded",
}

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager around the block named ``name`` (a key of
    :data:`SPANS`): ``record_function(name)`` while a profiler records,
    else a shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
