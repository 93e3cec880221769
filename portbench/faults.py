"""What a run has to come out not correct on, planted in the program's timed
path underneath the harness: the control, the plain reference in the
program's place one step below the configuration's precision, and each
fault a cell can have (a step that returns its input, half a batch left
out, one value altered where it is made, the halo exchange left out).

``plant(name, cell)`` patches the port's pipeline factories, which the
batch driver and the runner both call, and returns the undo.
"""

from __future__ import annotations

import torch

from portbench.reference import CONTROL, Reference

#: every name :func:`plant` takes
FAULTS = ("control", "unchanged", "half", "altered", "no_exchange")


def _wrap_pipeline(module, fault, name="make_pipeline"):
    """Replace the factory ``module.<name>`` with one whose decoded frames go
    through ``fault(out, rgb, frame0)``, ``rgb`` being the frames that were
    encoded (a rank's block, on a mesh) and ``frame0`` the first one's
    index."""
    real = getattr(module, name)

    def make(*args, **kw):
        enc, dec, rt = real(*args, **kw)
        seen = {}

        def enc2(rgb, frame0=0):
            seen["rgb"] = torch.as_tensor(rgb)
            return enc(rgb, frame0)

        def dec2(comp, frame0=0):
            return fault(dec(comp, frame0), seen["rgb"], frame0)

        def rt2(rgb, frame0=0):
            return fault(rt(rgb, frame0), torch.as_tensor(rgb), frame0)

        return enc2, dec2, rt2

    setattr(module, name, make)
    return lambda: setattr(module, name, real)


def _unchanged(out, rgb, frame0):
    """The step hands back what it was given."""
    return rgb.to(out.dtype).clone()


def _half(out, rgb, frame0):
    """Half of the batch computed, the rest a copy of it."""
    n = out.shape[0]
    h = max(1, n // 2)
    return torch.cat([out[:h]] * -(-n // h))[:n]


def _altered(out, rgb, frame0):
    """One value of each batch's first frame changed where it is made."""
    out = out.clone()
    out[0, 0, 0, 0] += 0.01
    return out


def _no_exchange():
    """The line halos never cross ranks: each rank takes its own edge lines."""
    from color_modem_tpu_torch.parallel import halo

    real = halo.ring_exchange

    def own(mesh, axis, to_prev, to_next):
        got_prev, got_next = real(mesh, axis, to_prev, to_next)
        return (None if got_prev is None else to_prev.clone(),
                None if got_next is None else to_next.clone())

    halo.ring_exchange = own
    return lambda: setattr(halo, "ring_exchange", real)


def _control(cell):
    """The control in the program's place: the plain reference of the
    cell's configuration and hop, in float32 with TF32 products (one step
    below the configuration's float32), from the frames that were encoded;
    what the program decoded is dropped."""
    ref = Reference(cell.config, cell.traffic.get("hop"))

    def control(out, rgb, frame0):
        parts = []
        for lo in range(0, rgb.shape[0], 4):
            part = rgb[lo:lo + 4].to(torch.float32)
            frames = list(range(frame0 + lo, frame0 + lo + part.shape[0]))
            parts.append(ref.roundtrip(part, frames, CONTROL).to(out.dtype))
        return torch.cat(parts)

    return control


def plant(fault: str | None, cell=None):
    """Plant ``fault`` (one of :data:`FAULTS`, or None) in the program;
    ``cell``: the cell run, which the control needs.  Returns the undo."""
    if fault is None:
        return lambda: None
    if fault == "no_exchange":
        return _no_exchange()
    import color_modem_tpu_torch.frame.pipeline as pipeline
    import color_modem_tpu_torch.frame.video as video

    fn = (_control(cell) if fault == "control" else
          {"unchanged": _unchanged, "half": _half, "altered": _altered}[fault])
    undo = [_wrap_pipeline(pipeline, fn), _wrap_pipeline(video, fn),
            _wrap_pipeline(video, fn, "make_sharded_pipeline")]
    return lambda: [u() for u in undo]
