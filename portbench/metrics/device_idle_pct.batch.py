"""The share of a traced stretch of the cell's calls in which the card runs
nothing, in per cent: the stretch recorded on the card alone, one less the
union of its kernels, copies and sets over the stretch's length (see
``portbench/idle.py``).  Layer: device."""

from portbench import idle


def read(record):
    return idle.read(record, "call")
