"""The comb stencil's roofline reader (``portbench/metrics/comb_roofline.py``)
on hand-built traces: the share from the pass's device time per call, and
None where no such kernel ran (the parent's program, the notch and
delay-line decoders) or the unit is a job."""

import pytest

from portbench import harness, work

CONFIG = {"lines": 480, "samples": 720}
KERNEL = "void (anonymous namespace)::comb_stencil_kernel<float4, 1, true>(...)"


def record(events, unit="call", units=200, frames=64):
    return {"unit": unit, "units": units, "frames_per_unit": frames, "config": CONFIG,
            "ranks": [{"events": events}]}


def test_share_of_the_bound_per_call():
    # 200 calls, 75 us each: 8 bytes a pixel of 64 x 480 x 720 over 3.35 TB/s
    events = [("kernel", KERNEL, 100.0 * k, 75.0) for k in range(200)]
    events += [("kernel", "qam_decode_kernel", 1e5, 500.0), ("cpu_op", "aten::sub", 0.0, 9.0)]
    want = 100.0 * 8 * 64 * 480 * 720 / work.HBM_BYTES_PER_S / 75e-6
    got = harness.metric_reader("comb_roofline")(record(events))
    assert got == pytest.approx(want)
    assert 70.0 < got < 71.0


@pytest.mark.parametrize("events,unit", [
    ([("kernel", "CatArrayBatchedCopy", 0.0, 236.0)], "call"),
    ([("kernel", "delayline_matrix_kernel", 0.0, 240.0)], "call"),
    ([("kernel", KERNEL, 0.0, 75.0)], "job"),
])
def test_silent_without_the_pass(events, unit):
    assert harness.metric_reader("comb_roofline")(record(events, unit)) is None
