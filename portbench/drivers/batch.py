"""Closed-loop batches of round trips, dispatched ahead: ``make_pipeline``'s
``roundtrip`` on a ring of distinct input batches made on the device, the
first frame advancing by the batch on every call.  The host does not
synchronise inside the window; the window closes with a synchronise, so
every call dispatched in it is counted, and the rate is the pixels of all
those calls over the whole window."""

from __future__ import annotations

import time

import torch

from portbench.drivers.base import Driver as Base
from portbench.drivers.base import sync
from portbench.reference import Reference
from portbench.scene import Scene


class Driver(Base):
    span = "portbench.call"

    def setup(self) -> None:
        from color_modem_tpu_torch.frame.pipeline import make_pipeline
        from color_modem_tpu_torch.modem.plan import make_plan
        from color_modem_tpu_torch.standards import ALL_STANDARDS

        cfg, tr = self.cfg, self.tr
        plan = make_plan(ALL_STANDARDS[cfg["standard"]](), cfg["samples"])
        self.rt = make_pipeline(plan, cfg["decoder"], "kernel", self.device)[2]
        self.batch = tr["batch"]
        scene = Scene(cfg["lines"], cfg["samples"], self.ctx.seed, self.device)
        self.ring = [scene.frames(i * self.batch, self.batch) for i in range(tr["ring"])]
        self.k = 0
        for _ in range(tr["warmup_calls"]):
            self.unit()
        sync(self.device)

    def unit(self):
        """One call: ring entry ``k mod ring``, first frame ``k * batch``."""
        k = self.k
        self.k += 1
        return k, self.rt(self.ring[k % len(self.ring)], k * self.batch)

    def window(self) -> dict:
        tr = self.tr
        picks = set(self.rng.choice(tr["sample_within"], tr["sample_calls"],
                                    replace=False).tolist())
        self.kept = {}
        setup_s, t0 = self.start_window()
        n, last = 0, None
        while time.perf_counter() - t0 < self.ctx.seconds:
            k, out = self.unit()
            if n in picks:
                self.kept[n] = (k, out)
            last = (k, out)
            n += 1
        sync(self.device)
        dt = time.perf_counter() - t0
        self.expected = sorted(picks) + ["last"]
        if last is not None:
            self.kept["last"] = last
        pixels = n * self.batch * self.cfg["lines"] * self.cfg["samples"]
        return {"end_to_end": {"mpix_s": pixels / dt / 1e6}, "setup_s": setup_s,
                "attempted": n, "failed": 0,
                "record": {"unit": "call", "units": tr["trace_units"],
                           "frames_per_unit": self.batch, "timed_s": dt, "timed_units": n,
                           "config": self.cfg}}

    def compare(self) -> tuple[dict, int]:
        """The widest gap between a sampled call's RGB and the reference's,
        over every frame of each sampled call and the window's last."""
        self.rt = None  # the program's state goes before the reference runs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = Reference(self.cfg)
        limit = self.ctx.cell.limits["rgb_max_gap"]
        gaps, failed = [], 0
        for key in self.expected:
            if key not in self.kept:
                failed += 1
                continue
            k, out = self.kept[key]
            rgb = self.ring[k % len(self.ring)]
            gap = 0.0
            for lo in range(0, self.batch, 4):
                frames = [k * self.batch + i for i in range(lo, min(lo + 4, self.batch))]
                r = ref.roundtrip(rgb[lo:lo + 4].to(torch.float64), frames)
                gap = max(gap, float((out[lo:lo + 4].to(torch.float64) - r).abs().max()))
            gaps.append(gap)
            failed += gap > limit
        return {"rgb_max_gap": max(gaps) if len(gaps) == len(self.expected) else None}, failed
