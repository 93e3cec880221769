"""Launch ranks as OS processes and run a list of sharded cases in them.

Port of ``color_modem_tpu/parallel/multihost.py``.  :func:`launch` starts
``N`` processes of ``python -m color_modem_tpu_torch.parallel.multihost
--worker`` with the torchrun environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``: a
localhost port the OS hands out) and one torch thread each, polls every
rank so a dead one surfaces in seconds with its id, exit code and log, and
reads back what the ranks wrote.  The rank body, :func:`worker_main`, runs
the cases of ``cases.json`` in the output directory: each case is one
sharded pipeline on one mesh, held on rank 0 against the same pipeline
unsharded.  :func:`dryrun_cases` is the case list of the JAX package's
multi-chip gate (``__graft_entry__.py::dryrun_multichip``).

From the shell, the launcher (on the CPU)::

    python -m color_modem_tpu_torch.parallel.multihost --num-processes 4 \\
        --backend gloo --device cpu --mesh 2x2 --outdir /tmp/ranks

prints one JSON line per case: the error against the unsharded pipeline
and the round trip's PSNR, and each rank's kernel launches and device.

Every rank writes ``rank<r>.json`` (per case: its launches, its device,
its round-trip and halo-exchange times when asked); rank 0 adds the
comparisons, and with ``"save": true`` the case's gathered outputs to
``<name>.npz``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

from color_modem_tpu_torch.kernels import launch_counts, reset_launches

FAIL_ENV = "CMTPU_TORCH_MULTIHOST_FAIL_RANK"
#: samples per line of every case
SAMPLES = 720

#: case kind -> the comparison bound against the unsharded pipeline (the
#: JAX gate's: QAM bit-identical; SECAM and MAC 1e-5, PALplus 1e-6, the RF
#: hop 2e-6, the satellite hop 1e-3, the sound hops' video and audio).
BOUNDS = {
    "qam": 0.0, "secam": 1e-5, "mac": 1e-5, "palplus": 1e-6,
    "rf-hop": 2e-6, "sat-hop": 1e-3, "rf-sound": (2e-5, 1e-5), "sat-audio": (1e-3, 1e-5),
}
#: the adaptive combs (combA, comb3dA) on a card: the JAX suite's 1e-6.
#: Their separation runs outside the decode kernel, as plain Toeplitz FIR
#: products (``dsp/apply.py::fir_same``) that cuBLAS sums in an order that
#: follows the product's row count, so a block's lines come out a few ulp
#: from the full frame's with no rank involved (``chip_smoke.py`` phase 4j
#: measures both).  On the CPU they are bit-identical, the QAM bound.
ADAPTIVE_CUDA_BOUND = 1e-6


def _case(kind: str, standard: str, decoder: str, mesh: tuple, frames: int,
          lines: int = 64, **kw) -> dict:
    name = f"{kind}:{standard}/{decoder}@{mesh[0]}x{mesh[1]}"
    return {"name": name, "kind": kind, "standard": standard, "decoder": decoder,
            "mesh": list(mesh), "frames": frames, "lines": lines, **kw}


def dryrun_cases(n: int, frame: int, lineblk: int) -> list[dict]:
    """The sharded-vs-unsharded case list of ``dryrun_multichip`` for ``n``
    ranks: every halo flavour across the default factoring ``(frame,
    lineblk)`` and the mesh extremes ``(n, 1)``, ``(1, n)``; the interlaced
    pipeline, MAC, PALplus and the four hops.  Geometry: ``n`` frames (``2n``
    for the temporal combs) of 64 x 720."""
    cases: list[dict] = []

    def add(kind, standard, decoder, mesh, fpd=1, **kw):
        c = _case(kind, standard, decoder, tuple(mesh), n * fpd, **kw)
        if all(c["name"] != d["name"] for d in cases):
            cases.append(c)

    default = (frame, lineblk)
    extremes = [(n, 1), (1, n)]
    add("pipeline", "ntsc", "comb3", default)
    for ms in [default] + extremes:
        add("pipeline", "secam", "notch", ms)
    add("pipeline", "secam", "interp", default)
    add("pipeline", "secam", "avg", default)
    for ms in [default] + extremes:
        add("pipeline", "pal", "delayline", ms)
    add("pipeline", "ntsc", "comb3", (1, n))
    add("pipeline", "pal", "comb3", (1, n))
    add("pipeline", "niir", "avg", default)
    if frame > 1 and lineblk > 1:
        add("pipeline", "ntsc", "comb3dA", default, fpd=2)
    add("pipeline", "ntsc", "comb3dA", (n, 1), fpd=2)
    add("pipeline", "ntsc", "comb3d", default, fpd=2)
    add("interlaced", "ntsc", "comb3", default)
    add("interlaced", "ntsc", "comb3d", default, fpd=2)
    for ms in [default] + [e for e in extremes if e != default]:
        add("mac", "d2", "-", ms)
    add("mac", "d", "-", default)
    add("palplus", "pal", "comb3", (n, 1))
    add("rf-hop", "ntsc", "comb3", default)
    add("sat-hop", "ntsc", "comb3", default)
    add("rf-sound", "ntsc", "comb3", default)
    add("sat-audio", "ntsc", "comb3", default)
    return cases


# --- inside a rank ---------------------------------------------------------------


def fixture(frames: int, lines: int, seed: int = 40, broadcast: bool = False) -> np.ndarray:
    """(frames, 3, lines, 720) float32: ``smooth_scene`` per frame from
    ``seed + f``, or ``smooth_scene(seed)`` broadcast to every frame."""
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    if broadcast:
        one = smooth_scene(lines, SAMPLES, seed=seed).astype(np.float32)
        return np.ascontiguousarray(np.broadcast_to(one, (frames,) + one.shape))
    return np.stack([smooth_scene(lines, SAMPLES, seed=seed + f) for f in range(frames)]
                    ).astype(np.float32)


def sound_fixture(fs: float, frames: int, lines: int) -> np.ndarray:
    """(frames, lines*720) two-tone soundtrack at the composite rate,
    consecutive frames of one stream."""
    t = np.arange(frames * lines * SAMPLES) / fs
    return (0.6 * np.sin(2 * np.pi * 700.0 * t) + 0.3 * np.sin(2 * np.pi * 4300.0 * t)
            ).astype(np.float32).reshape(frames, lines * SAMPLES)


def sat_audio_fixture(fs: float, frames: int, lines: int) -> np.ndarray:
    """(frames, 2, lines*720): two subcarrier tones per frame, a whole
    number of cycles per frame block (the per-frame circular FM)."""
    s = lines * SAMPLES
    t = np.arange(s) / fs
    return np.stack([np.stack([
        0.6 * np.sin(2 * np.pi * round((700.0 + 37 * b + 23 * k) * s / fs) * t * fs / s)
        for k in range(2)]) for b in range(frames)]).astype(np.float32)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _build(case: dict, mesh, backend: str) -> dict:
    """The case's sharded and unsharded callables and its global inputs.

    Returns ``{"x", "aud", "sharded": (enc, dec, rt), "unsharded": (enc,
    dec, rt), "comp_layout", "aud_layout"}``; ``rt`` takes ``(rgb, frame0)``
    or ``(rgb, aud, frame0)`` and the encode/decode pair is None where
    the JAX gate compares only the round trip."""
    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame import rf as rf_mod
    from color_modem_tpu_torch.frame import satellite as sat
    from color_modem_tpu_torch.frame.interlace import make_interlaced_pipeline
    from color_modem_tpu_torch.frame.pipeline import frame_line_index, make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.parallel import sharded as sh

    kind, dev = case["kind"], mesh.device
    b, lines = case["frames"], case["lines"]
    x = fixture(b, lines, seed=case.get("seed", 40), broadcast=case.get("broadcast", False))
    out = {"x": x, "aud": None, "comp_layout": "composite", "aud_layout": "frames"}
    if kind == "mac":
        from color_modem_tpu_torch.modem import mac

        plan = mac.make_mac_plan(SAMPLES, case["standard"])

        def g(frame0, bb):
            return frame_line_index(plan.cfg, frame0, bb, lines, dev)

        enc_u = lambda r, f0: mac.encode(plan, r, g(f0, r.shape[0]))  # noqa: E731
        dec_u = lambda s, f0: mac.decode(plan, s, g(f0, s.shape[0]))  # noqa: E731
        out["unsharded"] = (enc_u, dec_u, lambda r, f0: dec_u(enc_u(r, f0), f0))
        out["sharded"] = sh.make_sharded_mac_pipeline(plan, mesh)
        return out
    plan = make_plan(ALL_STANDARDS[case["standard"]](), SAMPLES)
    dec_name = case["decoder"]
    if kind == "pipeline":
        out["unsharded"] = make_pipeline(plan, dec_name, backend, dev)
        out["sharded"] = sh.make_sharded_pipeline(plan, mesh, dec_name, backend)
    elif kind == "interlaced":
        out["unsharded"] = make_interlaced_pipeline(plan, dec_name, backend, dev)
        out["sharded"] = sh.make_sharded_interlaced_pipeline(plan, mesh, dec_name, backend)
    elif kind == "palplus":
        from color_modem_tpu_torch.frame.palplus import make_palplus_pipeline

        out["unsharded"] = (None, None, make_palplus_pipeline(plan, dec_name, backend,
                                                               device=dev)[2])
        out["sharded"] = (None, None, sh.make_sharded_palplus_pipeline(
            plan, mesh, dec_name, backend)[2])
    elif kind in ("rf-hop", "sat-hop"):
        if kind == "rf-hop":
            rfp = rf_mod.make_rf_plan(plan)

            def hop(c, f0):
                return rf_mod.rf_roundtrip(rfp, c, f0)
        else:
            sp = sat.make_sat_plan(plan.fs, SAMPLES)

            def hop(c, f0):
                return sat.fm_demodulate(sp, sat.fm_modulate(sp, c))
        enc_u, dec_u, _ = make_pipeline(plan, dec_name, backend, dev)
        out["unsharded"] = (None, None, lambda r, f0: dec_u(hop(enc_u(r, f0), f0), f0))
        out["sharded"] = (None, None, sh.make_sharded_hop_pipeline(
            plan, mesh, hop, dec_name, backend)[2])
    elif kind == "rf-sound":
        rfp = rf_mod.make_rf_plan(plan)
        out["aud"] = sound_fixture(plan.fs, b, lines)
        enc_u, dec_u, _ = make_pipeline(plan, dec_name, backend, dev)

        def chain(r, a, f0):
            rf = rf_mod.rf_modulate(rfp, enc_u(r, f0), f0)
            rf = rf_mod.sound_on_rf(rfp, rf, f0, a, 0.0)
            return dec_u(rf_mod.rf_demodulate(rfp, rf, f0), f0), rf_mod.sound_from_rf(rfp, rf, f0)

        out["unsharded"] = (None, None, chain)
        out["sharded"] = (None, None, sh.make_sharded_rf_sound_pipeline(
            plan, mesh, rfp, dec_name, backend)[2])
    elif kind == "sat-audio":
        sp = sat.make_sat_plan(plan.fs, SAMPLES, audio_subs=2)
        out["aud"] = sat_audio_fixture(plan.fs, b, lines)

        def hop(c, a, f0):
            fm = sat.fm_modulate(sp, c, audio=a)
            return sat.fm_demodulate(sp, fm), sat.fm_demodulate_audio(sp, fm)

        enc_u, dec_u, _ = make_pipeline(plan, dec_name, backend, dev)

        def chain(r, a, f0):
            c, a_rx = hop(enc_u(r, f0), a, f0)
            return dec_u(c, f0), a_rx

        out["unsharded"] = (None, None, chain)
        out["sharded"] = (None, None, sh.make_sharded_hop_audio_pipeline(
            plan, mesh, hop, dec_name, backend)[2])
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    return out


def _bound(case: dict, device):
    """The case's bound against the unsharded pipeline on ``device``."""
    kind = case["kind"]
    if kind in ("pipeline", "interlaced"):
        if case["standard"] == "secam":
            return BOUNDS["secam"]
        if case["decoder"] in ("combA", "comb3dA") and device.type == "cuda":
            return ADAPTIVE_CUDA_BOUND
        return BOUNDS["qam"]
    return BOUNDS[kind]


def _time_ms(fn, dev, reps: int) -> list[float]:
    """Milliseconds per call of ``fn``, ``reps`` calls one at a time (CUDA
    events on a card, the host clock on the CPU)."""
    import torch

    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def run_case(case: dict, mesh, backend: str, outdir: pathlib.Path) -> dict:
    """One case on this rank: the sharded round trip (its launches counted
    alone), then the sharded encode and the sharded decode of the unsharded
    composite, gathered to rank 0 and held there against the unsharded
    pipeline.  Returns this rank's record."""
    import torch
    import torch.distributed as dist

    from color_modem_tpu_torch.parallel.mesh import gather_blocks, local_block

    if case["kind"] in _UNIT_CASES:
        return _UNIT_CASES[case["kind"]](case, mesh, backend, outdir)
    frame0 = case.get("frame0", 3)
    dev = mesh.device
    b = _build(case, mesh, backend)
    x, aud = b["x"], b["aud"]
    enc_s, dec_s, rt_s = b["sharded"]
    enc_u = b["unsharded"][0]
    blk = local_block(mesh, x, "rgb")
    args = (blk,) if aud is None else (blk, local_block(mesh, aud, "frames"))
    if rt_s is None:
        def rt_s(*a):
            return dec_s(enc_s(*a[:-1], a[-1]), a[-1])

    dist.barrier()
    _sync(dev)
    reset_launches()
    with torch.inference_mode():
        got = rt_s(*args, frame0)
        _sync(dev)
    rec = {**_record(case, mesh), "launches": launch_counts(), "block": list(blk.shape)}
    rt_blk, aud_rx = (got, None) if aud is None else got
    outs = {"rt": gather_blocks(mesh, rt_blk, "rgb")}
    if aud_rx is not None:
        outs["aud"] = gather_blocks(mesh, aud_rx, b["aud_layout"])
    comp_u = None
    if enc_s is not None:
        with torch.inference_mode():
            comp_u = enc_u(torch.as_tensor(x, device=dev), frame0)
            outs["enc"] = gather_blocks(mesh, enc_s(blk, frame0), b["comp_layout"])
            outs["dec"] = gather_blocks(
                mesh, dec_s(local_block(mesh, comp_u, b["comp_layout"]), frame0), "rgb")
    if case.get("sync_debug") and dev.type == "cuda":
        # the round trip again, with every host-blocking CUDA operation an
        # error, apart from the halo exchange's host staging (mesh.staging)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                rt_s(*args, frame0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rec["sync_debug"] = "no host-blocking operation"
    if case.get("time"):
        from color_modem_tpu_torch.parallel.halo import halo_extend
        from color_modem_tpu_torch.parallel.sharded import required_halo

        with torch.inference_mode():
            dist.barrier()
            rec["ms"] = _time_ms(lambda: rt_s(*args, frame0), dev, case["time"])
            comp_blk = enc_s(blk, frame0)
            h = required_halo(_plan_of(case), case["decoder"])
            dist.barrier()
            rec["halo_ms"] = _time_ms(lambda: halo_extend(comp_blk, h, mesh), dev, case["time"])
    if dist.get_rank() == 0:
        _compare(case, b, outs, comp_u, frame0, rec, outdir)
    return rec


def _plan_of(case: dict):
    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.modem.plan import make_plan

    return make_plan(ALL_STANDARDS[case["standard"]](), SAMPLES)


def _compare(case, b, outs, comp_u, frame0, rec, outdir) -> None:
    """Rank 0: the gathered outputs against the unsharded pipeline
    (``comp_u``: its composite, None where only the round trip is
    compared)."""
    import torch

    from color_modem_tpu_torch.utils.metrics import psnr

    dev = outs["rt"].device
    x = torch.as_tensor(b["x"], device=dev)
    _, dec_u, rt_u = b["unsharded"]
    with torch.inference_mode():
        if b["aud"] is None:
            want = rt_u(x, frame0)
        else:
            want, want_aud = rt_u(x, torch.as_tensor(b["aud"], device=dev), frame0)
        errs = {"rt": _err(outs["rt"], want)}
        if "aud" in outs:
            errs["aud"] = _err(outs["aud"], want_aud.reshape(outs["aud"].shape))
        if comp_u is not None:
            errs["enc"] = _err(outs["enc"], comp_u)
            errs["dec"] = _err(outs["dec"], dec_u(comp_u, frame0))
    rec["err"] = errs
    rec["bound"] = _bound(case, dev)
    rec["psnr"] = psnr(outs["rt"], x)
    rec["finite"] = bool(torch.isfinite(outs["rt"]).all())
    if case.get("save"):
        if comp_u is not None:
            outs = {**outs, "comp_u": comp_u}
        np.savez(outdir / _file(case), **{k: v.cpu().numpy() for k, v in outs.items()})


def _record(case: dict, mesh) -> dict:
    import torch.distributed as dist

    return {"name": case["name"], "rank": dist.get_rank(), "device": str(mesh.device)}


def _halo_case(case: dict, mesh, backend: str, outdir: pathlib.Path) -> dict:
    """Halo exchange alone on ``arange`` data of ``case["shape"]`` (B, L,
    N): every rank's extended block, stacked on rank 0 (``<name>.npz``);
    and, on the line axis, whether the mesh-position arithmetic of the
    extended block's row numbers equals the exchanged row numbers."""
    import torch

    from color_modem_tpu_torch.parallel.halo import halo_extend, halo_extend_frames, \
        halo_extend_lines
    from color_modem_tpu_torch.parallel.mesh import FLAT, local_block, ring_all_gather
    from color_modem_tpu_torch.parallel.sharded import _block_rows

    x = np.arange(int(np.prod(case["shape"])), dtype=np.float32).reshape(case["shape"])
    blk = local_block(mesh, x, "composite")
    h, edge = case["h"], case.get("edge", "reflect")
    rec = _record(case, mesh)
    if case["axis"] == "frame":
        ext = halo_extend_frames(blk, h, mesh)
    else:
        ext = halo_extend(blk, h, mesh, edge=edge)
        rows = _block_rows(mesh, blk.shape[-2])
        rec["rows_equal"] = bool(torch.equal(
            halo_extend_lines(rows, h, mesh, edge=edge), _block_rows(mesh, blk.shape[-2], h, edge)))
    stacked = ring_all_gather(mesh, FLAT, ext[None].contiguous(), dim=0)
    if rec["rank"] == 0:
        np.savez(outdir / _file(case), ext=stacked.cpu().numpy())
    return rec


def _corrupt_case(case: dict, mesh, backend: str, outdir: pathlib.Path) -> dict:
    """Fault injection: the sharded comb2 decode with every received top halo
    line scaled by 1.01; rank 0 records its distance from the unsharded
    decode, which a working equivalence check must see."""
    import torch

    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame.pipeline import decode_block, make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan, plan_on
    from color_modem_tpu_torch.parallel.halo import crop_halo, halo_extend
    from color_modem_tpu_torch.parallel.mesh import gather_blocks, local_block
    from color_modem_tpu_torch.parallel.sharded import _block_frames, _block_rows, _gline

    plan = plan_on(make_plan(ALL_STANDARDS[case["standard"]](), SAMPLES), mesh.device)
    x = fixture(case["frames"], case["lines"])
    enc_u, dec_u, _ = make_pipeline(plan, case["decoder"], backend, mesh.device)
    with torch.inference_mode():
        comp = enc_u(x, 0)
        blk = local_block(mesh, comp, "composite")
        b, l, _ = blk.shape
        cext = halo_extend(blk, 1, mesh)
        cext[..., 0, :] *= 1.01
        g = _gline(plan, _block_frames(mesh, 0, b), _block_rows(mesh, l, 1))
        bad = gather_blocks(mesh, crop_halo(decode_block(plan, cext, g, case["decoder"],
                                                         backend), 1))
    rec = _record(case, mesh)
    if bad is not None:
        rec["err"] = {"rt": _err(bad, dec_u(comp, 0))}
    return rec


def _video_case(case: dict, mesh, backend: str, outdir: pathlib.Path) -> dict:
    """``process_video(mesh=)`` with ``case["opts"]`` into ``<outdir>/<out>``
    on the synthetic source (``"source": "device"``: the device source),
    saving the frames unless ``"save": false``, on the mesh's device unless
    the options name another; ``"rf_audio": "tones"``
    sends :func:`sound_fixture` as the soundtrack; ``expect_error``: the
    run must refuse with a ValueError, whose message is recorded."""
    from color_modem_tpu_torch import ALL_STANDARDS
    from color_modem_tpu_torch.frame.video import (
        process_video,
        synthetic_device_source,
        synthetic_source,
    )
    from color_modem_tpu_torch.modem.plan import make_plan

    opts = dict(case["opts"])
    n, lines = opts.pop("n_frames"), opts.pop("lines")
    device = opts.pop("device", mesh.device)
    plan = make_plan(ALL_STANDARDS[case["standard"]](), SAMPLES)
    src = synthetic_device_source(lines, SAMPLES, seed=0, device=mesh.device) \
        if case.get("source") == "device" else synthetic_source(lines, SAMPLES)
    if "scramble" in opts:
        opts["scramble"] = tuple(opts["scramble"])
    if opts.get("rf_audio") == "tones":
        opts["rf_audio"] = sound_fixture(plan.fs, n, lines).reshape(-1)
    rec = _record(case, mesh)
    reset_launches()
    try:
        rec["summary"] = process_video(plan, src, n, str(outdir / case["out"]), mesh=mesh,
                                       backend=backend, device=device,
                                       save_outputs=case.get("save", True), **opts)
    except ValueError as e:
        if not case.get("expect_error"):
            raise
        rec["error"] = str(e)
    _sync(mesh.device)
    rec["launches"] = launch_counts()
    return rec


def _file(case: dict) -> str:
    return case["name"].replace("/", "_").replace(":", "_") + ".npz"


_UNIT_CASES = {"halo": _halo_case, "corrupt": _corrupt_case, "video": _video_case}


def worker_main(outdir: str, backend: str, device: str | None) -> None:
    """One rank: join the group, build each case's mesh (all ranks build
    the meshes in the same order), run the cases, write ``rank<r>.json``."""
    import torch

    torch.set_num_threads(1)
    from color_modem_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(backend)
    import torch.distributed as dist

    od = pathlib.Path(outdir)
    cases = json.loads((od / "cases.json").read_text())
    meshes, records = {}, []
    try:
        for case in cases:
            key = tuple(case["mesh"])
            if key not in meshes:
                meshes[key] = make_mesh(*key, backend=backend, device=device)
            t0 = time.perf_counter()
            rec = run_case(case, meshes[key], case.get("backend", "kernel"), od)
            rec["seconds"] = time.perf_counter() - t0
            records.append(rec)
        (od / f"rank{dist.get_rank()}.json").write_text(json.dumps(records))
    finally:
        dist.destroy_process_group()


# --- the launcher -------------------------------------------------------------------


class _WorkerFailed(Exception):
    """A rank exited nonzero; carries which one, its exit code and its log."""

    def __init__(self, rank: int, returncode: int, log: str):
        super().__init__(f"rank {rank} rc={returncode}")
        self.rank = rank
        self.returncode = returncode
        self.log = log


def _rank_env(env: dict, rank: int, n: int, port: int) -> dict:
    return {**env, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(n),
            "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
            "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _spawn_and_wait(n: int, argv: list[str], env: dict, repo: str,
                    timeout: float) -> list[str]:
    """Start ``n`` ranks of ``python -m ...multihost --worker argv`` on a
    fresh port and poll them all: a rank that dies (import error, bad
    environment, port race) surfaces within ~0.2 s, as :class:`_WorkerFailed`
    with its log, and the others are killed."""
    from color_modem_tpu_torch.parallel.mesh import free_port

    port = free_port()
    logs_dir = pathlib.Path(argv[argv.index("--outdir") + 1])
    procs, files = [], []
    for r in range(n):
        f = open(logs_dir / f"rank{r}.log", "w+")
        files.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "color_modem_tpu_torch.parallel.multihost", "--worker",
             *argv], env=_rank_env(env, r, n, port), cwd=repo, stdout=f,
            stderr=subprocess.STDOUT, text=True))
    logs: list[str | None] = [None] * n
    deadline = time.monotonic() + timeout
    try:
        pending = set(range(n))
        while pending:
            for r in sorted(pending):
                if procs[r].poll() is None:
                    continue
                files[r].seek(0)
                logs[r] = files[r].read()
                pending.discard(r)
                if procs[r].returncode != 0:
                    raise _WorkerFailed(r, procs[r].returncode, logs[r])
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} still running after "
                                       f"{timeout:.0f} s")
                time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    return logs


def launch(cases: list[dict], num_processes: int, *, backend: str = "gloo",
           device: str | None = None, outdir: str | None = None,
           timeout: float = 600.0) -> list[list[dict]]:
    """Run ``cases`` on ``num_processes`` ranks; returns each rank's records
    (``rank<r>.json``), rank 0's with the comparisons.

    ``device``: where the ranks compute (``"cpu"``, or None for
    ``cuda:LOCAL_RANK % device_count``).  On a card the kernels are built
    here, once, before the ranks start (they load the same build).
    """
    import tempfile

    od = pathlib.Path(outdir or tempfile.mkdtemp(prefix="cmtpu_torch_ranks_"))
    od.mkdir(parents=True, exist_ok=True)
    (od / "cases.json").write_text(json.dumps(cases))
    if device != "cpu":
        from color_modem_tpu_torch.kernels.build import build

        build()
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    argv = ["--outdir", str(od), "--backend", backend]
    if device is not None:
        argv += ["--device", device]
    # the port comes from a bind-then-close probe, so another process can
    # take it before rank 0 binds: a rank 0 that dies on the bind retries
    # on a fresh port; any other failure propagates at once
    for attempt in range(3):
        try:
            _spawn_and_wait(num_processes, argv, dict(os.environ), repo, timeout)
            break
        except _WorkerFailed as e:
            race = e.rank == 0 and "address already in use" in e.log.lower()
            if not (race and attempt < 2):
                raise RuntimeError(f"rank {e.rank} failed (rc={e.returncode}):\n{e.log}") \
                    from e
    return [json.loads((od / f"rank{r}.json").read_text()) for r in range(num_processes)]


def _cli() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank (the launcher passes this)")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cpu, or a card per rank (default)")
    ap.add_argument("--mesh", default=None, help="FxL (default: the ranks on the frame axis)")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args()
    if a.worker:
        # fault injection: a chosen rank dies at start-up, for the
        # launcher's failure detection
        if os.environ.get(FAIL_ENV) == os.environ.get("RANK"):
            print("fault injection: rank dying at start-up", flush=True)
            sys.exit(3)
        worker_main(a.outdir, a.backend, a.device)
        return
    n = a.num_processes
    fr, lb = (int(v) for v in a.mesh.split("x")) if a.mesh else (n, 1)
    recs = launch(dryrun_cases(n, fr, lb), n, backend=a.backend, device=a.device,
                  outdir=a.outdir, timeout=a.timeout)
    for k, r0 in enumerate(recs[0]):
        print(json.dumps({**{key: r0.get(key) for key in ("name", "err", "bound", "psnr")},
                          "launches": [recs[r][k]["launches"] for r in range(n)],
                          "devices": [recs[r][k]["device"] for r in range(n)]}))


if __name__ == "__main__":
    _cli()
