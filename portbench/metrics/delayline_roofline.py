"""The delay-line pass's share of its roofline: its least time, three planes
read and three written once (24 bytes a pixel of ``frames_per_unit`` x
lines x samples) over ``work.HBM_BYTES_PER_S``, over the device time per
call of the kernels whose name holds ``delayline``, in per cent; None where
none ran.  Layer: pipeline (``frame/pipeline.py::decode_block`` ->
``kernels/colorimetry.py::delayline_matrix`` -> ``csrc/colour_matrix.cu``)."""

from portbench import trace, work

#: bytes a pixel: the planes Y, C1, C2 read once, R, G, B written once, float32
PLANE_BYTES = 24


def read(record):
    if record.get("unit") != "call":
        return None
    device_us = sum(d for n, _, d in trace.device_ops(record["ranks"][0]["events"], ("kernel",))
                    if "delayline" in n)
    if not device_us:
        return None
    cfg = record["config"]
    bound_s = (PLANE_BYTES * record["frames_per_unit"] * cfg["lines"] * cfg["samples"]
               / work.HBM_BYTES_PER_S)
    return 100.0 * bound_s / (device_us * 1e-6 / record["units"])
