"""A kernel family's share of its roofline, for the per-layer metrics that
read one: the least times of its kernels on the cell's shapes
(``portbench/work.py``) over their device time per call in the trace."""

from __future__ import annotations

from portbench import trace, work


def read(record, family: dict) -> float | None:
    """``family``: work.py's kernel name -> the kernel names in the trace
    that compute it.  None where no such kernel ran."""
    if record.get("unit") != "call":
        return None
    cfg = record["config"]
    names = [n for names in family.values() for n in names]
    events = record["ranks"][0]["events"]
    device_us = sum(d for n, _, d in trace.device_ops(events, ("kernel",))
                    if any(k in n for k in names))
    if not device_us:
        return None
    lines = record["frames_per_unit"] * cfg["lines"]
    bound = sum(work.kernel_bound_s(cfg, k, lines)[0] for k in family)
    return 100.0 * bound / (device_us * 1e-6 / record["units"])
