"""The benchmark's run of one cell: find the cell's files by name, set up,
measure, judge the outputs against the reference, print the result line.

Everything about one configuration, traffic mix or per-layer metric lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names its driver
``drivers/<driver>.py``), ``metrics/<metric>.py``, ``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may load: JAX and the JAX package (the
#: port's own name begins with the latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "color_modem_tpu")


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, entry: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration,
    traffic and limits, and the metrics it reports; ``entry``: the
    ``workloads`` entry of a cell the file does not list."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if entry is None and name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = entry or cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def driver_class(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}").Driver


def metric_reader(name: str):
    """``read(record)`` of ``metrics/<name>.py`` (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def scratch_dir() -> str:
    """Where a run puts what it writes: ``$TMPDIR/portbench``.  A run
    without ``TMPDIR`` refuses to start, so that two runs never share a
    fixed directory."""
    if not os.environ.get("TMPDIR"):
        raise RuntimeError("TMPDIR is not set: a run writes only under its own TMPDIR")
    d = os.path.join(os.environ["TMPDIR"], "portbench")
    os.makedirs(d, exist_ok=True)
    return d


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and its device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    scratch: str = field(default_factory=scratch_dir)


def judge(cell: Cell, readings: dict) -> tuple[bool, dict]:
    """Each compared number against its limit in ``limits/<cell>.json``;
    a number that is missing (an answer that never came) fails."""
    checks, ok = {}, True
    for name, limit in cell.limits.items():
        value = readings.get(name)
        good = value is not None and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def device_block(device, count: int, memory_peak: int) -> dict:
    import torch

    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": count, "memory_peak_bytes": int(memory_peak)}


def emit(result: dict, checks: dict) -> None:
    """The checks on standard error as its last lines, then the result line,
    with the checks under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        world: int = 1) -> dict | None:
    """Set up, (trace,) measure and judge one cell in this process.  Returns
    ``{"result": ..., "checks": ...}`` on rank 0 of a mesh (or alone), None
    on the other ranks."""
    import torch

    from portbench import trace as tr

    driver = driver_class(cell)(Context(cell, seed, seconds, trace, device, t0))
    driver.setup()
    record = driver.traced() if trace else None
    stats = driver.window()
    dev = driver.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    shared = driver.gather({"peak": peak, "record": record})
    readings, failed = driver.compare()
    driver.close()
    if not driver.rank0:
        return None
    ok, checks = judge(cell, readings)
    block = device_block(dev, world, max(s["peak"] for s in shared))
    result = {"correct": ok, "attempted": stats["attempted"],
              "failed": 0 if ok else max(failed, 1)}
    if trace:
        record = {**stats["record"], "ranks": [s["record"] for s in shared]}
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        ranks = [r["events"] for r in record["ranks"]]
        # busy and window from the stretch recorded on the card alone (none on
        # a CPU device: nothing busy over the traced stretch)
        got = [tr.device_busy(r) for r in record["ranks"]]
        if not all(got):
            got = [(0.0, (b - a) * 1e-6) for a, b in map(tr.segment, ranks)]
        block["busy_s"] = sum(b for b, _ in got) / len(got)
        block["window_s"] = sum(w for _, w in got) / len(got)
        result.update(metrics=metrics, device=block,
                      breakdown={"device_ops": tr.top_device_ops(ranks[0]),
                                 "idle_gaps": tr.idle_gaps(ranks[0])})
    else:
        metrics = {m["name"]: {"value": stats["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": stats["setup_s"], "unit": "s"}
        result.update(metrics=metrics, device=block)
    return {"result": result, "checks": checks}
