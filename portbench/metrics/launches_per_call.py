"""Device kernels per round-trip call in the traced calls.  Layer: pipeline
(``frame/pipeline.py``, ``dsp/colorimetry.py``, ``separate/``)."""

from portbench import trace


def read(record):
    if record.get("unit") != "call":
        return None
    kernels = trace.device_ops(record["ranks"][0]["events"], ("kernel",))
    return len(kernels) / record["units"] if kernels else None
