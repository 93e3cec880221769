"""The round trip's least time on the card over the timed window's time per
call, in per cent.  The least time is the larger of the logical bytes (the
RGB read and written once) over the memory rate and the logical
operations (the kernels' FIRs and the two colour matrices,
``portbench/work.py``) over the TF32 peak; it holds whatever implements
the round trip.  Layer: pipeline."""

from portbench import work


def read(record):
    if record.get("unit") != "call" or not record["timed_units"]:
        return None
    flops, nbytes = work.roundtrip_work(record["config"], record["frames_per_unit"])
    bound, _ = work.bound_s(flops, nbytes)
    return 100.0 * bound / (record["timed_s"] / record["timed_units"])
