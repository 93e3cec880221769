"""Entry points: a one-card forward step and a multi-rank dry run.

The port's counterpart of the JAX package's ``__graft_entry__.py``:

``entry()``            — ``(step, (rgb,))``: the main path's forward step,
                         NTSC encode -> 3-line comb decode through the CUDA
                         kernels, and a ``(2, 3, 480, 720)`` float32 zero
                         batch on the same device to call it with.
``dryrun_multichip(n)`` — launches ``n`` gloo ranks
                         (``parallel/multihost.py``) on the cards, rank r
                         on ``cuda:r % device_count``, or on the CPU;
                         runs one sharded comb3 step and one comb3d step
                         across the frame ring on tiny shapes, then the
                         sharded-vs-unsharded case list of
                         ``multihost.dryrun_cases``, each held to its
                         bound.

    python -m color_modem_tpu_torch.entry --dryrun 4 [--device cpu]
"""

from __future__ import annotations

import numpy as np

#: the decoded picture of a step must beat this (garbage reads < 15 dB)
MIN_PSNR_DB = 20.0


def entry(device="cuda"):
    """Returns ``(step, (rgb,))``: ``step(rgb)`` is the NTSC comb3 round trip
    of a ``(B, 3, L, 720)`` batch at frame 0, on ``device``."""
    import torch

    from color_modem_tpu_torch.frame.pipeline import make_pipeline
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.standards import NTSC

    _, _, roundtrip = make_pipeline(make_plan(NTSC(), 720), "comb3", "kernel", device)

    def step(rgb):
        return roundtrip(rgb, 0)

    rgb = torch.zeros((2, 3, 480, 720), dtype=torch.float32, device=device)
    return step, (rgb,)


def mesh_factoring(n_devices: int) -> tuple[int, int]:
    """``(frame, lineblk)``: the line axis takes 4, 2 or 1 ranks, the frame
    axis the rest, as the JAX dry run factors its devices."""
    lineblk = next((c for c in (4, 2) if n_devices % c == 0), 1)
    return n_devices // lineblk, lineblk


def _check_case(r0: dict) -> None:
    bound = r0["bound"]
    video, audio = bound if isinstance(bound, list) else (bound, None)
    for key, err in r0["err"].items():
        limit = audio if key == "aud" else video
        if not err <= limit:
            raise AssertionError(f"{r0['name']} {key}: {err} against unsharded (> {limit})")


def dryrun_multichip(n_devices: int, device="cuda", outdir: str | None = None) -> list[dict]:
    """One sharded pipeline step over ``n_devices`` gloo ranks on tiny
    shapes, then the gate's case list; raises on a wrong shape, a PSNR
    under :data:`MIN_PSNR_DB` or a case outside its bound.  ``device``:
    ``"cuda"`` puts rank r on ``cuda:r % device_count`` (ranks that share
    a card exchange halos through the host), ``"cuda:k"`` every rank on
    card k, ``"cpu"`` the CPU.  Returns rank 0's records."""
    import tempfile

    from color_modem_tpu_torch.frame.pipeline import resolve_device
    from color_modem_tpu_torch.parallel import multihost as mh

    dev = resolve_device(device)
    # multihost.launch: None spreads the ranks over the cards
    where = None if dev.type == "cuda" and dev.index is None else str(dev)

    frame, lineblk = mesh_factoring(n_devices)
    mesh = (frame, lineblk)
    lines = 16 * lineblk  # tiny but evenly sharded
    steps = [
        dict(mh._case("pipeline", "ntsc", "comb3", mesh, frame, lines, seed=0),
             name="step:ntsc/comb3", save=True, frame0=0),
        # the temporal comb: its cross-frame stencil exchanges halos around
        # the frame ring (the other collective pattern)
        dict(mh._case("pipeline", "ntsc", "comb3d", mesh, 2 * frame, lines, seed=0,
                      broadcast=True), name="step:ntsc/comb3d", save=True, frame0=0),
    ]
    out = outdir or tempfile.mkdtemp(prefix="cmtpu_torch_dryrun_")
    recs = mh.launch(steps + mh.dryrun_cases(n_devices, frame, lineblk), n_devices,
                     backend="gloo", device=where, outdir=out)
    r0 = {r["name"]: r for r in recs[0]}
    for step in steps:
        got = np.load(f"{out}/{mh._file(step)}")["rt"]
        want = (step["frames"], 3, lines, mh.SAMPLES)
        if got.shape != want:
            raise AssertionError(f"{step['name']}: output shape {got.shape}, expected {want}")
        rec = r0[step["name"]]
        if not (rec["finite"] and rec["psnr"] > MIN_PSNR_DB):
            raise AssertionError(f"{step['name']}: round-trip PSNR {rec['psnr']:.1f} dB "
                                 "is garbage")
    for rec in recs[0]:
        _check_case(rec)
    print(f"dryrun_multichip ok: mesh={{'frame': {frame}, 'lineblk': {lineblk}}} "
          f"shape=({frame}, 3, {lines}, {mh.SAMPLES}) "
          f"psnr={r0['step:ntsc/comb3']['psnr']:.1f} dB "
          f"comb3d={r0['step:ntsc/comb3d']['psnr']:.1f} dB; "
          f"{len(recs[0]) - len(steps)} gate cases within their bounds; ranks on "
          f"{[r[0]['device'] for r in recs]}")
    return recs[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, default=4, metavar="N", help="ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r %% device_count), cuda:K, or cpu")
    a = ap.parse_args()
    dryrun_multichip(a.dryrun, a.device)
