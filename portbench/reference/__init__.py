"""The plain reference that decides ``correct``: plain PyTorch in float64,
on any device, and nothing of the program.

A configuration file names its round-trip module (``"reference"``), a
traffic file its hop's (``"hop": {"kind": ...}``); each is a module of this
package with ``make`` and the round trip, so a configuration or hop of a
later cell is a module added beside these.
"""

from __future__ import annotations

import importlib

from portbench.reference.common import CONTROL, REFERENCE, Precision  # noqa: F401


class Reference:
    """The round trip of ``cfg`` (a configuration file's contents), through
    the hop ``hop`` (a traffic file's ``"hop"``, or None)."""

    def __init__(self, cfg: dict, hop: dict | None = None):
        self.decoder = cfg["decoder"]
        self.modem = importlib.import_module(f"portbench.reference.{cfg['reference']}")
        self.plan = self.modem.make(cfg)
        self.hop, self.hop_plan = None, None
        if hop:
            self.hop = importlib.import_module(f"portbench.reference.{hop['kind']}")
            self.hop_plan = self.hop.make(self.plan, hop)

    def roundtrip(self, rgb, frames, prec: Precision = REFERENCE):
        """(B, 3, L, N) RGB of the absolute frames ``frames`` -> decoded RGB."""
        comp = self.modem.encode(self.plan, rgb, frames, prec)
        if self.hop is not None:
            comp = self.hop.roundtrip(self.hop_plan, comp, frames, prec)
        return self.modem.decode(self.plan, comp, frames, self.decoder, prec)
