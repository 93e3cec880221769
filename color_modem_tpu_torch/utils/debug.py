"""Development-run sanitizer: finite-value checks on a function's outputs.

The port's counterpart of the JAX package's ``utils/debug.py::checked``
(checkify's float checks) and of the ``jax_debug_nans`` switch its tests
turn on.  :func:`checked` wraps a function so that a NaN or an infinity in
what it returns raises ``FloatingPointError`` instead of flowing on.  It
checks the outputs only, not every operation as checkify does: a NaN that
an intermediate step makes and a later one removes (a ``clamp``, a
``where``) passes.  For development runs: no factory of the port wraps
itself.
"""

from __future__ import annotations

import torch


def _float_tensors(out, path: str):
    """(name, tensor) for every floating tensor in ``out``, through nested
    tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            yield path, out
    elif isinstance(out, (tuple, list)):
        for i, item in enumerate(out):
            yield from _float_tensors(item, f"{path}[{i}]")
    elif isinstance(out, dict):
        for k, item in out.items():
            yield from _float_tensors(item, f"{path}[{k!r}]")


def checked(fn):
    """Wrap ``fn`` so that a non-finite value in its outputs raises.

    All the outputs' checks are reduced on their devices and fetched
    together, one host sync per call; ``FloatingPointError`` names the
    first output that holds a NaN or an infinity.

        rt_checked = checked(roundtrip)
        out = rt_checked(rgb, 0)   # raises FloatingPointError on NaN/Inf
    """

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        named = list(_float_tensors(out, "output"))
        if named:
            dev = named[0][1].device
            ok = torch.stack([torch.isfinite(t).all().to(dev) for _, t in named]).cpu()
            if not bool(ok.all()):
                name = named[int((~ok).nonzero()[0])][0]
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'function')}: {name} holds a NaN or an infinity")
        return out

    return wrapper
