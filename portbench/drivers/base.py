"""What every driver shares: the device, the traced stretch, and a single
process's gather."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import trace


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """One cell's traffic.  A driver sets up (``setup``), runs its unit of
    work (``unit``: one call, one job), measures a window (``window``),
    and compares the window's sampled answers with the reference
    (``compare``)."""

    #: the harness span around each traced unit
    span = "portbench.unit"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.tr = ctx.cell.traffic
        self.device = torch.device(ctx.device)
        self.rng = np.random.default_rng(ctx.seed)
        #: whether this process judges and prints (rank 0 of a mesh)
        self.rank0 = True

    def traced(self) -> dict:
        """This rank's record: ``trace_units`` units under the profiler on
        the host and the card, then as many recorded on the card alone
        (``trace.device_profiled``)."""
        rec: dict = {}
        with trace.profiled(self.ctx.scratch, rec, self.device):
            for _ in range(self.tr["trace_units"]):
                with torch.profiler.record_function(self.span):
                    self.unit()
        with trace.device_profiled(self.ctx.scratch, rec, self.device):
            for _ in range(self.tr["trace_units"]):
                self.unit()
        return rec

    def start_window(self) -> tuple[float, float]:
        """Synchronise; the set-up time from process start, and the window's
        start on the performance counter."""
        sync(self.device)
        return time.time() - self.ctx.t0, time.perf_counter()

    def gather(self, obj) -> list:
        return [obj]

    def close(self) -> None:
        pass
