"""Host arrays onto a device without stalling the device.

A plain ``torch.tensor(array, device="cuda")`` copies from pageable memory
and then synchronises the stream: one blocking operation per call, which
the port keeps out of every per-chunk path.  :func:`upload` issues the
copy asynchronously instead.  From pageable memory the CUDA driver copies
the array into its own staging buffer before the call returns, so the
caller may reuse or free the array at once, and nothing waits for the
work already queued on the card.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def upload(arr, device: torch.device | str, dtype=None) -> torch.Tensor:
    """``arr`` (anything ``np.asarray`` takes), as ``dtype`` if given, as a
    tensor of its own on ``device``, copied once where ``arr`` is already
    contiguous in ``dtype``.  On the CPU the copy is the tensor's own
    memory, so the caller's memory (a read-only NumPy view of another
    library's buffer, say) is never shared or written."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
    src = np.asarray(arr, dtype=dtype, order="C")
    with warnings.catch_warnings():
        # a read-only array: the wrapper is only read, by the copy below
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        host = torch.from_numpy(src)
    return host.to(device, non_blocking=True)
