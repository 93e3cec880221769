"""Closed-loop runner jobs, back to back from one client: each job is one
``process_video`` call over the traffic's frame count, in its own output
directory, with the resume manifest on.  A job writes only its manifest
and its summary (a few kB); the directories are removed once the run is
over, so no deletion falls in the window.  Job
``j``'s frames are the scene's frames from ``j * frames`` on, so no two jobs
see the same frames; the job keys its phases on its own frame indices.

With ``"mesh": [F, L]`` the cell's command runs one rank per card
(``parallel/mesh.py::make_mesh`` over NCCL); every rank makes the same
calls, rank 0 decides when the window ends and tells the others before
each job.

The decoded frames reach the comparison through a tap on the runner's
content fingerprint (``frame/video.py::fingerprint``), which every chunk's
decoded frames pass through on the device: the tap keeps a few frames of
each chunk, drawn from the seed, by one ``index_select``, and lets the
fingerprint run as before.  Nothing is written for it.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np
import torch

from portbench.drivers.base import Driver as Base
from portbench.drivers.base import sync
from portbench.reference import Reference
from portbench.scene import Scene


class Tap:
    """Wraps the runner's ``fingerprint``: keeps ``x[positions]`` of each
    chunk of the current job."""

    def __init__(self, module, positions: torch.Tensor):
        self.module, self.orig, self.positions = module, module.fingerprint, positions
        self.chunks: list = []
        module.fingerprint = self

    def __call__(self, x):
        self.chunks.append(x.index_select(0, self.positions))
        return self.orig(x)

    def take(self) -> list:
        chunks, self.chunks = self.chunks, []
        return chunks

    def remove(self) -> None:
        self.module.fingerprint = self.orig


class Driver(Base):
    span = "portbench.job"

    def setup(self) -> None:
        import color_modem_tpu_torch.frame.video as video
        from color_modem_tpu_torch.modem.plan import make_plan
        from color_modem_tpu_torch.standards import ALL_STANDARDS

        cfg, tr = self.cfg, self.tr
        self.mesh = None
        if tr.get("mesh"):
            from color_modem_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(*tr["mesh"], backend=tr["backend"], device=self.device)
            self.device = self.mesh.device
        self.rank0 = self.mesh is None or torch.distributed.get_rank() == 0
        self.video = video
        self.plan = make_plan(ALL_STANDARDS[cfg["standard"]](), cfg["samples"])
        self.frames, self.chunk = tr["frames"], tr["chunk"]
        self.scene = Scene(cfg["lines"], cfg["samples"], self.ctx.seed, self.device)
        inner = self.rng.choice(np.arange(1, self.chunk - 1), tr["sample_frames"] - 2,
                                replace=False)
        self.positions = sorted({0, self.chunk - 1, *inner.tolist()})
        self.tap = Tap(video, torch.tensor(self.positions, device=self.device))
        self.jobs_dir = Path(self.ctx.scratch) / "jobs"
        if self.rank0:
            shutil.rmtree(self.jobs_dir, ignore_errors=True)
            self.jobs_dir.mkdir(parents=True)
        self.j = 0
        self.processed = 0
        for _ in range(tr["warmup_jobs"]):
            self.unit()
        sync(self.device)

    def unit(self) -> float:
        """One job; its wall time in seconds (rank 0's)."""
        j = self.j
        self.j += 1
        out_dir = self.jobs_dir / f"job{j}"

        def source(start, count, first=j * self.frames):
            return self.scene.frames(first + start, count)

        t = time.perf_counter()
        summary = self.video.process_video(
            self.plan, source, self.frames, str(out_dir), decoder=self.cfg["decoder"],
            chunk=self.chunk, rf=self.tr["hop"]["kind"] == "rf", mesh=self.mesh,
            device=self.device, lines=self.cfg["lines"])
        dt = time.perf_counter() - t
        self.caps = (j, self.tap.take())
        if self.rank0:
            self.processed += summary["frames_processed_this_run"]
        return dt

    def _go(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        torch.distributed.broadcast(t, src=0)
        return bool(t.item())

    def window(self) -> dict:
        tr = self.tr
        picks = set(self.rng.choice(tr["sample_within"], tr["sample_jobs"], replace=False).tolist())
        self.kept = {}
        self.processed = 0
        setup_s, t0 = self.start_window()
        times = []
        while self._go(time.perf_counter() - t0 < self.ctx.seconds):
            times.append(self.unit())
            if len(times) - 1 in picks:
                self.kept[len(times) - 1] = self.caps
        t_end = time.perf_counter() - t0
        self.kept["last"] = self.caps
        self.expected = sorted(picks) + ["last"]
        self.short = len(times) * self.frames - self.processed
        pixels = len(times) * self.frames * self.cfg["lines"] * self.cfg["samples"]
        return {"end_to_end": {"video_mpix_s": pixels / t_end / 1e6,
                               "job_p95_ms": float(np.percentile(times, 95)) * 1e3},
                "setup_s": setup_s, "attempted": len(times), "failed": 0,
                "record": {"unit": "job", "units": tr["trace_units"],
                           "chunks_per_unit": -(-self.frames // self.chunk),
                           "config": self.cfg}}

    def gather(self, obj) -> list:
        if self.mesh is None:
            return [obj]
        out = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(out, obj)
        return out

    def compare(self) -> tuple[dict, int]:
        """The widest gap between the tapped frames of the sampled jobs (and
        the window's last) and the reference's round trip of the same
        frames through the hop; and the frames the jobs did not process."""
        if not self.rank0:
            return {}, 0
        self.tap.remove()
        self.plan = None  # the program's state goes before the reference runs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = Reference(self.cfg, self.tr["hop"])
        limit = self.ctx.cell.limits["rgb_max_gap"]
        gaps, failed = [], 0
        for key in self.expected:
            j, chunks = self.kept.get(key, (None, []))
            if len(chunks) != -(-self.frames // self.chunk):
                failed += 1
                continue
            idx = [c * self.chunk + p for c in range(len(chunks)) for p in self.positions]
            out = torch.cat(chunks)
            gap = 0.0
            for lo in range(0, len(idx), 4):
                frames = idx[lo:lo + 4]
                rgb = torch.cat([self.scene.frames(j * self.frames + i, 1) for i in frames])
                r = ref.roundtrip(rgb.to(torch.float64), frames)
                gap = max(gap, float((out[lo:lo + 4].to(torch.float64) - r).abs().max()))
            gaps.append(gap)
            failed += gap > limit
        return {"rgb_max_gap": max(gaps) if len(gaps) == len(self.expected) else None,
                "frames_short": self.short}, failed

    def close(self) -> None:
        self.tap.remove()
        if self.rank0:
            shutil.rmtree(self.jobs_dir, ignore_errors=True)
        if self.mesh is not None:
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
