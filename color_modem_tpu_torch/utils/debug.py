"""Development-run sanitizer: per-operation float checks.

The port's counterpart of the JAX package's ``utils/debug.py::checked``,
which runs a function under checkify's ``float_checks``.  :func:`checked`
runs ``fn`` under a ``TorchDispatchMode`` that sees every aten operation:

* after each operation with a floating or complex output it records a
  flag on the output's device, ``isnan(out).any()`` (views share their
  base's values and uninitialised allocations hold no values yet, so
  neither is checked);
* for a division (``div``, ``reciprocal``, ``remainder``, ``fmod``,
  ``floor_divide``) it records ``(divisor == 0).any()`` first;
* each flag keeps the operation's name and the source line of its nearest
  caller in ``color_modem_tpu_torch/`` (else the nearest caller outside
  torch), so that a NaN made and removed again, by a ``where`` or a
  ``clamp``, is still named where it was made.

The hand-written kernels launch through ``ctypes`` and so pass by the
dispatcher: their wrappers hand their outputs to :func:`note_kernel`,
which checks them for NaNs under the kernel's name, and costs one look
at torch's (empty) dispatch-mode stack when no check is active.

Then, as before, the outputs of ``fn`` are checked for NaNs and
infinities.  All flags are stacked and fetched once per call.  The first
flagged operation in program order decides: ``ZeroDivisionError`` for a
division by zero, ``FloatingPointError`` for a NaN; a non-finite output
raises ``FloatingPointError`` naming the output (and the first operation
that made a NaN, if any).  JAX's checks let an infinity through; the
output check here does not.  For development runs: no factory of the port
wraps itself.
"""

from __future__ import annotations

import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_THIS = os.path.abspath(__file__)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep

#: operations whose outputs are uninitialised memory: nothing to check yet
_UNINITIALISED = frozenset((
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "resize_", "set_",
))
#: divisions, and the position of the divisor among their arguments
_DIVISOR = {"div": 1, "div_": 1, "remainder": 1, "remainder_": 1, "fmod": 1, "fmod_": 1,
            "floor_divide": 1, "floor_divide_": 1, "reciprocal": 0, "reciprocal_": 0}


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


def _caller() -> str:
    """``file:line`` of the nearest caller inside the port, else of the
    nearest one outside torch and this module."""
    frame, outside = sys._getframe(2), None
    while frame is not None:
        name = frame.f_code.co_filename
        if name != _THIS and not name.startswith(_TORCH):
            if name.startswith(_PACKAGE):
                return f"{os.path.relpath(name, os.path.dirname(_PACKAGE[:-1]))}:{frame.f_lineno}"
            if outside is None:
                outside = f"{name}:{frame.f_lineno}"
        frame = frame.f_back
    return outside or "?"


class _FloatChecks(TorchDispatchMode):
    """Records, per operation, its NaN and division-by-zero flags."""

    def __init__(self):
        super().__init__()
        self.flags = []  # (flag: device tensor or bool, error class, what, where)

    def _nan(self, what: str, outs) -> None:
        named = list(_float_tensors(outs, ""))
        if not named:
            return
        flags = [torch.isnan(t).any() for _, t in named]
        flag = flags[0] if len(flags) == 1 else torch.stack(
            [f.to(flags[0].device) for f in flags]).any()
        self.flags.append((flag, FloatingPointError, f"{what} made a NaN", _caller()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = func.overloadpacket.__name__
        if func.is_view or op in _UNINITIALISED:
            return out
        if op in _DIVISOR:
            pos = _DIVISOR[op]
            d = args[pos] if len(args) > pos else kwargs.get("other")
            if isinstance(d, torch.Tensor):
                flag = (d == 0).any()
            else:
                flag = d is not None and d == 0
            self.flags.append((flag, ZeroDivisionError, f"{func} divides by zero", _caller()))
        self._nan(str(func), out)
        return out


def note_kernel(name: str, *outputs: torch.Tensor) -> None:
    """Called by a kernel wrapper after its launch: under :func:`checked`,
    flags a NaN in ``outputs`` as made by the kernel ``name`` (found on
    torch's dispatch-mode stack, empty when no check is active)."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _FloatChecks):
            mode._nan(f"the CUDA kernel {name}", outputs)


def _fetch(flags: list) -> list[bool]:
    """Every flag as a bool, the device ones in one stacked fetch."""
    tensors = [f for f in flags if isinstance(f, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        got = iter(torch.stack([t.to(dev) for t in tensors]).cpu().tolist())
    return [bool(next(got)) if isinstance(f, torch.Tensor) else bool(f) for f in flags]


def checked(fn):
    """Wrap ``fn`` so that a NaN made by any operation, a division by zero,
    or a non-finite value in its outputs raises (module docstring).

        rt_checked = checked(roundtrip)
        out = rt_checked(rgb, 0)   # FloatingPointError / ZeroDivisionError
    """
    fname = getattr(fn, "__name__", "function")

    def wrapper(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        named = list(_float_tensors(out, "output"))
        outs = [(~torch.isfinite(t)).any() for _, t in named]
        got = _fetch([f for f, _, _, _ in mode.flags] + outs)
        first = next(((err, what, where) for (_, err, what, where), bad
                      in zip(mode.flags, got) if bad), None)
        bad_out = next((name for (name, _), bad in zip(named, got[len(mode.flags):]) if bad),
                       None)
        if first is not None and (first[0] is ZeroDivisionError or bad_out is None):
            err, what, where = first
            raise err(f"{fname}: {what} at {where}")
        if bad_out is not None:
            made = f"; first {first[1]} at {first[2]}" if first else ""
            raise FloatingPointError(f"{fname}: {bad_out} holds a NaN or an infinity{made}")
        return out

    return wrapper
