"""Time the QAM or the SECAM kernels, the colour matrix or the comb stencil, of one or
more trees of this repository on one CUDA GPU, in turns, at the paths' shapes.

    python3 scripts/torch_kernel_ab.py [--family qam|secam|colour|comb] [--tree DIR ...]
                                       [--rounds 1]

QAM: NTSC 16x480x720, PAL 16x576x720 and PAL 4x576x1440 (259 taps).  SECAM: 16x576x720,
4x576x1440 and 1x576x2160, the plans of chip_smoke.py's phase 3b, and 16x576x1440, the
chip matrix's SECAM row.  Colour (``csrc/colour_matrix.cu``): the pass alone at the batch
cells' shapes, NTSC 64x3x480x720 and SECAM 16x3x576x720, the encoder's matrix and the
decoder's with its clamp, timed in turns (plain, kernel, kernel, plain) against the plain
version (a product, two ``addcmul_`` and, for the decoder, ``torch.clamp``), whose ms it
adds to the record.  Comb (``csrc/comb_stencil.cu``): the pass alone at the NTSC batch
cell's 64x480x720 (spacing 1) and PAL's 64x576x720 (spacing 2), 'comb3' and 'comb2', in
turns against the plain composition (``separate/comb.py::stencil_signal``: flips, two
``torch.cat``, a scale, subtractions and a division), bit for bit; a tree without the pass
has nothing to time.  Each tree (default:
this one) runs in its own process, which imports that tree's
``color_modem_tpu_torch`` and builds its kernels.  A round runs the trees
forward then backward (A, B, B, A for two trees).  Each process holds the
kernels against their plain versions (QAM 2e-5 encode, 5e-4 decode; SECAM
2e-4 encode, 5e-4 on the decoded RGB) and prints, per kernel and shape,
the CUDA-event median ms of 10 windows of
20 launches with their spread, the bound and the share of it reached, and
the host-clock us per call of the wrapper while 100 calls are queued (the
host's cost of a launch, checks and CUDA runtime calls included), and the
library yardstick of ``chip_smoke.py``'s phase 5, one grouped ``conv2d``
of the kernel's FIRs alone (TF32 off), timed the same way.  The
timer and the bound are this tree's ``color_modem_tpu_torch/kernels/measure.py``
(loaded by its path, so every tree is timed and bounded alike).  The last
line is a JSON object of every measurement.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: QAM: (standard, frames, lines, samples, decoder)
SHAPES = (("NTSC", 16, 480, 720, "comb3"), ("PAL", 16, 576, 720, "delayline"),
          ("PAL", 4, 576, 1440, "delayline"))
#: SECAM: (frames, samples) at 576 lines
SECAM_SHAPES = ((16, 720), (4, 1440), (16, 1440), (1, 2160))


def _measure():
    """This tree's ``kernels/measure.py``, whichever package is imported."""
    path = os.path.join(HERE, "color_modem_tpu_torch", "kernels", "measure.py")
    spec = importlib.util.spec_from_file_location("_kernel_ab_measure", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn) -> float:
    """The host-clock us per call of ``fn`` while 100 calls are queued."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fn()
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    return host_us


def _timed(measure, fn) -> tuple[list[float], float]:
    """CUDA-event windows of ``fn``, and the host-clock us per call while
    100 calls are queued."""
    return measure.time_ms(fn, windows=10), _host_us(fn)


def _record(w, host_us, bound, err, library=None) -> dict:
    med = statistics.median(w)
    rec = {"ms": med, "min": min(w), "max": max(w), "bound_ms": bound[0],
           "bound_by": bound[1], "share": bound[0] / med, "host_us": host_us,
           "max_abs_err": err}
    if library is not None:
        rec.update(conv2d_ms=statistics.median(library), conv2d_min=min(library),
                   conv2d_max=max(library))
    return rec


def _smoke():
    """This tree's ``chip_smoke.py`` (its yardsticks), loaded by its path."""
    path = os.path.join(HERE, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_kernel_ab_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def secam_worker() -> dict:
    """The SECAM kernels of the imported tree on the scene (decode) and on
    random chroma (encode), first frame odd."""
    import numpy as np
    import torch

    from color_modem_tpu_torch import SECAM
    from color_modem_tpu_torch.dsp.colorimetry import clamp01
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.kernels.colorimetry import colour_matrix
    from color_modem_tpu_torch.modem import secam
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.utils.testimages import smooth_scene

    measure = _measure()
    dev = torch.device("cuda:0")
    res = {}
    for frames, n in SECAM_SHAPES:
        plan = make_plan(SECAM(), n).to(dev)
        g = frame_line_index(plan, 3, frames, 576, dev)
        isr = sk.isr_col(g)
        rgb = torch.tensor(np.broadcast_to(smooth_scene(576, n, seed=0), (frames, 3, 576, n)),
                           dtype=torch.float32, device=dev)
        ycc = colour_matrix(plan.rgb_to_ycc, rgb).contiguous()
        rng = np.random.default_rng(n)
        ycc_rand = torch.cat([ycc[:, :1], torch.tensor(rng.uniform(-0.6, 0.6, (frames, 2, 576, n)),
                                                       dtype=torch.float32, device=dev)],
                             dim=1).contiguous()
        comp = sk.encode_lines_plain(plan, ycc, isr)

        def rgb_of(luma_v):
            dr, db = secam.pair(luma_v[1], g, "interp")
            return clamp01(colour_matrix(plan.ycc_to_rgb, torch.stack([luma_v[0], dr, db], 1)))

        e_enc = float((sk.encode_lines(plan, ycc_rand, isr)
                       - sk.encode_lines_plain(plan, ycc_rand, isr)).abs().max())
        e_dec = float((rgb_of(sk.demodulate_lines(plan, comp, isr))
                       - rgb_of(sk.demodulate_lines_plain(plan, comp, isr))).abs().max())
        if e_enc > 2e-4 or e_dec > 5e-4:
            raise AssertionError(f"SECAM {n}: kernel vs plain {e_enc}, {e_dec}")
        yard = _smoke().secam_library_calls(plan, ycc_rand, comp, isr)
        for name, fn, err in (
                ("secam_encode", lambda: sk.encode_lines(plan, ycc_rand, isr), e_enc),
                ("secam_decode", lambda: sk.demodulate_lines(plan, comp, isr), e_dec)):
            w, host_us = _timed(measure, fn)
            res[f"{name} {frames}x576x{n}"] = _record(
                w, host_us, measure.kernel_bound(plan, name, frames * 576), err,
                measure.time_ms(yard[name], windows=10))
    return res


#: the colour matrix: (standard, frames, lines) of the two batch cells, 720 samples
COLOUR_SHAPES = (("NTSC", 64, 480), ("SECAM", 16, 576))


def colour_worker() -> dict:
    """The imported tree's colour-matrix pass against its plain version on
    RGB uniform in [0, 1] (the encoder's matrix) and on that RGB's
    components (the decoder's, clamped), 10 windows of each side."""
    import torch

    import color_modem_tpu_torch as cmt
    from color_modem_tpu_torch.dsp.colorimetry import apply_mat3
    from color_modem_tpu_torch.kernels import colorimetry as ck
    from color_modem_tpu_torch.modem.plan import make_plan

    measure = _measure()
    dev = torch.device("cuda:0")
    res = {}
    for std, frames, lines in COLOUR_SHAPES:
        plan = make_plan(getattr(cmt, std)(), 720).to(dev)
        gen = torch.Generator(device=dev).manual_seed(frames)
        rgb = torch.rand((frames, 3, lines, 720), generator=gen, device=dev)
        ycc = apply_mat3(plan.rgb_to_ycc, rgb)
        for name, mat, x, clamp in (("colour_matrix", plan.rgb_to_ycc, rgb, False),
                                    ("colour_matrix_clamp", plan.ycc_to_rgb, ycc, True)):
            def kernel():
                return ck.colour_matrix(mat, x, clamp)

            def plain():
                return apply_mat3(mat, x, clamp)

            err = float((kernel() - plain()).abs().max())
            if err > 1e-6:
                raise AssertionError(f"{name} {std}: kernel vs plain {err}")
            p1, k1, k2, p2 = (measure.time_ms(f, windows=5) for f in (plain, kernel, kernel, plain))
            rec = _record(k1 + k2, _host_us(kernel), measure.colour_matrix_bound(x.numel()), err)
            plain_ms = p1 + p2
            rec.update(plain_ms=statistics.median(plain_ms), plain_min=min(plain_ms),
                       plain_max=max(plain_ms))
            res[f"{name} {std} {frames}x3x{lines}x720"] = rec
    return res


#: the comb stencil: (standard, frames, lines) of the NTSC batch cell and PAL's, 720 samples
COMB_SHAPES = (("NTSC", 64, 480), ("PAL", 64, 576))


def comb_worker() -> dict:
    """The imported tree's comb-stencil pass against the plain composition
    on a composite uniform in [-0.45, 1.45], 10 windows of each side, each
    form at the standard's spacing; nothing where the tree has no pass."""
    from functools import partial

    import torch

    import color_modem_tpu_torch as cmt
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal
    from color_modem_tpu_torch.standards.decoders import comb_spacing

    try:
        from color_modem_tpu_torch.kernels import comb
    except ImportError:
        return {}
    measure = _measure()
    dev = torch.device("cuda:0")
    res = {}
    for std, frames, lines in COMB_SHAPES:
        plan = make_plan(getattr(cmt, std)(), 720)
        p = comb_spacing(plan.cfg)
        gen = torch.Generator(device=dev).manual_seed(lines)
        x = 1.9 * torch.rand((frames, lines, 720), generator=gen, device=dev) - 0.45
        for decoder in ("comb3", "comb2"):
            kernel = partial(comb.comb_stencil, x, p, decoder)
            plain = partial(stencil_signal, plan, x, decoder)
            if not torch.equal(kernel().view(torch.int32), plain().view(torch.int32)):
                raise AssertionError(f"{decoder} {std}: the pass is not the plain composition")
            p1, k1, k2, p2 = (measure.time_ms(f, windows=5) for f in (plain, kernel, kernel, plain))
            rec = _record(k1 + k2, _host_us(kernel), measure.comb_stencil_bound(x.numel()), 0.0)
            plain_ms = p1 + p2
            rec.update(plain_ms=statistics.median(plain_ms), plain_min=min(plain_ms),
                       plain_max=max(plain_ms))
            res[f"comb_stencil {decoder} {std} {frames}x{lines}x720 p={p}"] = rec
    return res


def worker(tree: str, family: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import color_modem_tpu_torch as cmt
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import qam as qk
    from color_modem_tpu_torch.kernels.build import load_library
    from color_modem_tpu_torch.modem.plan import make_plan
    from color_modem_tpu_torch.separate.comb import stencil_signal

    assert os.path.dirname(os.path.abspath(cmt.__file__)) == os.path.join(
        os.path.abspath(tree), "color_modem_tpu_torch"), cmt.__file__
    measure = _measure()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_library()
    if family == "colour":
        print(json.dumps({"tree": tree, "results": colour_worker()}))
        return
    if family == "comb":
        print(json.dumps({"tree": tree, "results": comb_worker()}))
        return
    if family == "secam":
        print(json.dumps({"tree": tree, "results": secam_worker()}))
        return
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    res = {}
    for std, frames, lines, n, decoder in SHAPES:
        plan = make_plan(getattr(cmt, std)(), n).to(dev)
        ycc = torch.tensor(np.stack([rng.uniform(0.0, 1.0, (frames, lines, n)),
                                     rng.uniform(-0.6, 0.6, (frames, lines, n)),
                                     rng.uniform(-0.6, 0.6, (frames, lines, n))], axis=1),
                           dtype=torch.float32, device=dev)
        cols = qk.phase_cols(plan, frame_line_index(plan, 0, frames, lines, dev))
        comp = qk.encode_lines(plan, ycc, cols)
        sep = stencil_signal(plan, comp, decoder)
        e_enc = float((comp - qk.encode_lines_plain(plan, ycc, cols)).abs().max())
        e_dec = float((qk.decode_lines(plan, sep, comp, cols)
                       - qk.decode_lines_plain(plan, sep, comp, cols)).abs().max())
        if e_enc > 2e-5 or e_dec > 5e-4:
            raise AssertionError(f"{std}: kernel vs plain {e_enc}, {e_dec}")
        yard = _smoke().qam_library_calls(plan, ycc, sep, comp, cols)
        for name, fn in (("qam_encode", lambda: qk.encode_lines(plan, ycc, cols)),
                         ("qam_decode", lambda: qk.decode_lines(plan, sep, comp, cols))):
            w, host_us = _timed(measure, fn)
            res[f"{name} {std} {frames}x{lines}x{n}"] = _record(
                w, host_us, measure.kernel_bound(plan, name, frames * lines),
                e_enc if name == "qam_encode" else e_dec,
                measure.time_ms(yard[name], windows=10))
    print(json.dumps({"tree": tree, "results": res}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--family", choices=("qam", "secam", "colour", "comb"), default="qam")
    ap.add_argument("--tree", nargs="+", default=[HERE])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.family)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for _ in range(args.rounds):
        for tree in list(args.tree) + list(reversed(args.tree)):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                                  "--family", args.family],
                                 check=True, capture_output=True, text=True, timeout=600)
            run = json.loads(out.stdout.strip().splitlines()[-1])
            runs.append(run)
            for key, r in run["results"].items():
                yard = (f", conv2d {r['conv2d_ms']:.4f} ms [{r['conv2d_min']:.4f}, "
                        f"{r['conv2d_max']:.4f}]" if "conv2d_ms" in r else "")
                if "plain_ms" in r:
                    yard += (f", plain {r['plain_ms']:.4f} ms [{r['plain_min']:.4f}, "
                             f"{r['plain_max']:.4f}]")
                print(f"{tree} {key} on {card}: {r['ms']:.4f} ms [{r['min']:.4f}, "
                      f"{r['max']:.4f}], bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                      f"{100 * r['share']:.1f}% of it, host {r['host_us']:.2f} us per call, "
                      f"max|err| {r['max_abs_err']:.3e}{yard}")
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
