"""The comb stencil's share of its roofline: its least time, the composite
read once and the stencil signal written once (8 bytes a pixel of
``frames_per_unit`` x lines x samples) over ``work.HBM_BYTES_PER_S``, over
the device time per call of the kernels whose name holds ``comb_stencil``,
in per cent; None where none ran.  Layer: pipeline
(``frame/pipeline.py::_demodulate_qam`` -> ``kernels/comb.py::comb_stencil``
-> ``csrc/comb_stencil.cu``)."""

from portbench import trace, work

#: bytes a pixel: the composite read once, the stencil signal written once, float32
PLANE_BYTES = 8


def read(record):
    if record.get("unit") != "call":
        return None
    device_us = sum(d for n, _, d in trace.device_ops(record["ranks"][0]["events"], ("kernel",))
                    if "comb_stencil" in n)
    if not device_us:
        return None
    cfg = record["config"]
    bound_s = (PLANE_BYTES * record["frames_per_unit"] * cfg["lines"] * cfg["samples"]
               / work.HBM_BYTES_PER_S)
    return 100.0 * bound_s / (device_us * 1e-6 / record["units"])
