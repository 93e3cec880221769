"""Device time of cuFFT kernels per runner chunk, the most over the ranks:
the RF hop's overlap-save transforms.  Layer: transmission hop and stream
engine (``frame/rf.py``, ``dsp/stream.py``)."""

import re

from portbench import trace

#: cuFFT's kernels: ``regular_fft``, ``vector_fft``, ``fft_*``, the
#: ``spRadix``/``dpRadix`` families
PATTERN = re.compile(r"fft|radix", re.IGNORECASE)


def read(record):
    if record.get("unit") != "job":
        return None
    chunks = record["units"] * record["chunks_per_unit"]
    per_rank = [sum(d for n, _, d in trace.device_ops(r["events"], ("kernel",))
                    if PATTERN.search(n))
                for r in record["ranks"]]
    if not any(per_rank):
        return None
    return max(per_rank) * 1e-3 / chunks
