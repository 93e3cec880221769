"""The device's idle share, for the per-layer metrics that read it: the
share of the card-only traced stretch (``trace.device_profiled``) in which
no operation ran on the card, the union of kernels, copies and sets over
the stretch's own length, both on the card's timeline; on a mesh, the mean
over the ranks' cards.  Every device operation counts as busy, NCCL's too
(which spins on the card while it waits for a peer)."""

from __future__ import annotations

from portbench import trace


def read(record, unit: str) -> float | None:
    """None where the unit is not ``unit`` or nothing ran on a card."""
    if record.get("unit") != unit:
        return None
    shares = []
    for r in record["ranks"]:
        got = trace.device_busy(r)
        if got is None:
            return None
        busy, window = got
        shares.append(100.0 * (1.0 - busy / window))
    return sum(shares) / len(shares)
