"""Variants of the two SECAM kernels, timed in turns on one CUDA GPU, and a
per-stage cycle profile of the pipelined kernels.

    python3 scripts/torch_secam_variants.py [--variants NAME ...] [--profile]

No profiler splits a kernel on the card's machine (``ncu`` does not run
there), so a kernel's time is taken apart by variants that each drop or
change one thing: each is a copy of this tree's ``color_modem_tpu_torch``
under ``ab_trees/variants/<name>/`` (git-ignored) with one textual patch
of ``csrc/`` (:data:`VARIANTS`), built by its own process.  The trees
(this one first, ``.``) run forward then backward, each a median of 10
CUDA-event windows of 20 launches of ``encode_lines`` and
``demodulate_lines`` at 16x576x720 on random chroma; variants that drop
work give wrong outputs and are not checked.

``--profile`` builds an instrumented copy (``ab_trees/variants/profile``)
whose pipelined kernels add the SM clock's cycles since the last mark to
one of 8 counters per warp at each handoff (:data:`PROFILE_MARKS`), and
prints, for one launch at 16x576x720, the mean kcycles per counter over
the warps of each role (row warps, FIR groups).

The last line is a JSON object of every measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "ab_trees", "variants")
DEC, ENC, FIR = "csrc/secam_decode.cu", "csrc/secam_encode.cu", "csrc/band_fir.cuh"


def _warps(row: int, a: int, b: int, enc_row: int, enc_fir: int) -> list:
    return [(DEC, "constexpr int kRowWarps = 4, kWarpsA = 7, kWarpsB = 5;",
             f"constexpr int kRowWarps = {row}, kWarpsA = {a}, kWarpsB = {b};"),
            (ENC, "constexpr int kRowWarps = 4, kFirWarps = 12;",
             f"constexpr int kRowWarps = {enc_row}, kFirWarps = {enc_fir};")]


def _steps(ks: int) -> list:
    return [(DEC, "constexpr int kWOne = 4, kSOne = 8;", f"constexpr int kWOne = 4, kSOne = {ks};"),
            (ENC, "constexpr int kW = 4, kS = 8;", f"constexpr int kW = 4, kS = {ks};")]


def _skip(path: str, call: str) -> tuple:
    return (path, f"      {call}", f"      if (0) {call}")


#: name -> [(source, text, replacement)]
VARIANTS = {
    # the products removed: mma.sync's operands kept live, no tensor-core work
    "nomma": [(FIR, 'asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "',
               'asm("// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "')],
    # the decoder's first (takeoff/notch, mix) or second (diff, deemph, demod)
    # group runs no FIR, its handoffs stay
    "noA": [_skip(DEC, "stage_band<bf::SharedTables>("),
            _skip(DEC, "stage_mix<bf::SharedTables>(")],
    "noB": [_skip(DEC, "stage_diff<bf::SharedTables>("),
            _skip(DEC, "stage_deemph<bf::SharedTables>("),
            _skip(DEC, "stage_demod<bf::SharedTables>(")],
    # the encoder's phase scan and cosf removed
    "noscan": [(ENC, "        scan_row(c, c, ramp_s, n);", "")],
    # no tap-table loads (A from constants)
    "notables": [(FIR, "wa[a][k] = Tab::ld(tr[a] + 8 * sb + 4 * k);",
                  "wa[a][k] = make_float2(1e-3f * (k + sb), 1e-7f * k);")],
    # no mix-row loads in the decoder's mix stage
    "nomix": [(DEC, "    i = (2.0f * t) * Tab::ld(cs + p);\n    q = (-2.0f * t) * Tab::ld(sn + p);",
               "    i = (2.0f * t) * (1e-3f * p);\n    q = (-2.0f * t) * (2e-3f * p);")],
    # blocks of 4 or 2 steps in the 4-tile FIRs
    "ks4": _steps(4),
    "ks2": _steps(2),
    # other warp splits: 20 warps (96 registers at entry; the decoder's FIR
    # warps take what its row warps give up: 104), 8/4 and 6/6 groups
    "w20": _warps(4, 8, 8, 4, 16) + [(DEC, "kRowRegs = 56, kFirRegs = 152;",
                                      "kRowRegs = 56, kFirRegs = 104;")],
    "a8b4": _warps(4, 8, 4, 2, 14),
    "a6b6": _warps(4, 6, 6, 3, 13),
    # plain stores from the staging rows (the path of rows not aligned to
    # 16 bytes) in place of the pipelined kernels' bulk stores
    "nobulk": [(DEC, "    const bool bulk_out = n % 4 == 0 && ap::aligned16(luma_out) && ap::aligned16(v_out);",
                "    const bool bulk_out = false;"),
               (ENC, "    const bool bulk_out = n % 4 == 0 && ap::aligned16(out);",
                "    const bool bulk_out = false;")],
}

_PT = "{ unsigned _t = clock(); pc[i] += _t - pt0; pt0 = _t; }"
_COUNTERS = ('''namespace {

constexpr int kRows = 8;  // lines per tile: the N of mma.m16n8k8''', '''__device__ unsigned {sym}[264 * 16 * 8];
#define PT(i) {pt}
extern "C" int {fn}(unsigned* dst, int count) {{ return cudaMemcpyFromSymbol(dst, {sym}, 4 * count); }}
namespace {{

constexpr int kRows = 8;  // lines per tile: the N of mma.m16n8k8''')
_START = ('''    ap::fence_init();
  }
  __syncthreads();
''', '''    ap::fence_init();
  }
  __syncthreads();
  unsigned pc[8] = {}, pt0 = clock();
''')

#: the instrumented copy: (source, text, replacement); counters per role:
#: decode row 0 wait / 1 build; first group 0 wait ext, 1 takeoff/notch,
#: 2 sync, 3 luma out + wait i/q free, 4 mix, 5 sync; second group 0 wait
#: i/q, 1 diff, 2 sync, 3 deemph, 4 sync, 5 demod, 6 v out; encode row 0
#: wait d free, 1 stage d, 2 wait df, 3 scan, 4 wait Y free, 5 stage Y; FIR
#: 0 wait d, 1 comp_lpf, 2 held halo, 3 preemph, 4 waits, 5 anti-cloche, 6
#: out; 7 the rest
PROFILE_MARKS = [
    (DEC, _COUNTERS[0], _COUNTERS[1].format(sym="g_prof_dec", fn="secam_prof_dec", pt=_PT)),
    (DEC, _START[0], _START[1]),
    (DEC, "ap::wait(&bars[kEEmpty], (k & 1) ^ 1);\n", "PT(7); ap::wait(&bars[kEEmpty], (k & 1) ^ 1); PT(0);\n"),
    (DEC, "ap::arrive(&bars[kEFull]);\n", "ap::arrive(&bars[kEFull]); PT(1);\n"),
    (DEC, "ap::wait(&bars[kEFull], k & 1);\n", "PT(7); ap::wait(&bars[kEFull], k & 1); PT(0);\n"),
    (DEC, "ap::arrive(&bars[kEEmpty]);\n", "PT(1); ap::arrive(&bars[kEEmpty]);\n"),
    (DEC, "ap::group_sync(1, kThreadsA);\n", "ap::group_sync(1, kThreadsA); PT(2);\n"),
    (DEC, "ap::wait(&bars[kIQEmpty], (k & 1) ^ 1);\n", "ap::wait(&bars[kIQEmpty], (k & 1) ^ 1); PT(3);\n"),
    (DEC, "ap::arrive(&bars[kIQFull]);\n", "PT(4); ap::arrive(&bars[kIQFull]);\n"),
    (DEC, "ap::group_sync(1, kThreadsA);  // T and the luma rows are rewritten next\n",
     "ap::group_sync(1, kThreadsA); PT(5);\n"),
    (DEC, "ap::wait(&bars[kIQFull], k & 1);\n", "PT(7); ap::wait(&bars[kIQFull], k & 1); PT(0);\n"),
    (DEC, "ap::arrive(&bars[kIQEmpty]);\n        ap::group_sync(2, kThreadsB);\n",
     "PT(1); ap::arrive(&bars[kIQEmpty]);\n        ap::group_sync(2, kThreadsB); PT(2);\n"),
    (DEC, "ap::group_sync(2, kThreadsB);  // V is read: it takes the v rows\n",
     "PT(3); ap::group_sync(2, kThreadsB); PT(4);\n"),
    (DEC, "                                      });\n        if (bulk_out) ap::fence_async();\n",
     "                                      });\n        PT(5); if (bulk_out) ap::fence_async();\n"),
    (DEC, "v_out + static_cast<long long>(line0) * n, rows, n);\n",
     "v_out + static_cast<long long>(line0) * n, rows, n); PT(6);\n"),
    (DEC, "      if (bulk_out && t == 0) ap::bulk_wait();\n    }\n  }\n}",
     "      if (bulk_out && t == 0) ap::bulk_wait();\n    }\n  }\n"
     "  if (lane == 0) for (int i = 0; i < 8; ++i) g_prof_dec[(blockIdx.x * 16 + warp) * 8 + i] = pc[i];\n}"),
    (ENC, _COUNTERS[0], _COUNTERS[1].format(sym="g_prof_enc", fn="secam_prof_enc", pt=_PT)),
    (ENC, _START[0], _START[1]),
    (ENC, "      ap::wait(&bars[kDEmpty], (k & 1) ^ 1);\n",
     "      PT(7); ap::wait(&bars[kDEmpty], (k & 1) ^ 1); PT(0);\n"),
    (ENC, "      ap::arrive(&bars[kDFull]);\n    };",
     "      ap::arrive(&bars[kDFull]); PT(1);\n    };"),
    (ENC, "      ap::wait(&bars[kFFull + (k & 1)], (k >> 1) & 1);\n",
     "      PT(7); ap::wait(&bars[kFFull + (k & 1)], (k >> 1) & 1); PT(2);\n"),
    (ENC, "      ap::arrive(&bars[kCReady + (k & 1)]);\n",
     "      ap::arrive(&bars[kCReady + (k & 1)]); PT(3);\n"),
    (ENC, "      ap::wait(&bars[kYEmpty], (k & 1) ^ 1);\n",
     "      PT(7); ap::wait(&bars[kYEmpty], (k & 1) ^ 1); PT(4);\n"),
    (ENC, "      ap::arrive(&bars[kYFull]);\n    };",
     "      ap::arrive(&bars[kYFull]); PT(5);\n    };"),
    (ENC, "      ap::group_sync(1, kFirThreads);  // dl is rewritten\n      ap::wait(&bars[kDFull], k & 1);\n",
     "      PT(7); ap::group_sync(1, kFirThreads);  // dl is rewritten\n      ap::wait(&bars[kDFull], k & 1); PT(0);\n"),
    (ENC, "      ap::arrive(&bars[kDEmpty]);\n", "      PT(1); ap::arrive(&bars[kDEmpty]);\n"),
    (ENC, "        fill_edges(row, L.h_pre, row[L.h_pre], L.h_pre + n, L.w_pre, row[L.h_pre + n - 1]);\n      }\n      ap::group_sync(1, kFirThreads);\n",
     "        fill_edges(row, L.h_pre, row[L.h_pre], L.h_pre + n, L.w_pre, row[L.h_pre + n - 1]);\n      }\n      ap::group_sync(1, kFirThreads); PT(2);\n"),
    (ENC, "      ap::arrive(&bars[kFFull + (k & 1)]);\n",
     "      PT(3); ap::arrive(&bars[kFFull + (k & 1)]);\n"),
    (ENC, "      ap::wait(&bars[kYFull], k & 1);\n",
     "      ap::wait(&bars[kYFull], k & 1); PT(4);\n"),
    (ENC, "      if (bulk_out) ap::fence_async();\n      ap::group_sync(1, kFirThreads);\n",
     "      PT(5); if (bulk_out) ap::fence_async();\n      ap::group_sync(1, kFirThreads);\n"),
    (ENC, "        if (t == 0) ap::arrive(&bars[kYEmpty]);\n      }\n    };",
     "        if (t == 0) ap::arrive(&bars[kYEmpty]);\n      }\n      PT(6);\n    };"),
    (ENC, "    if (bulk_out && t == 0) ap::bulk_wait();\n  }\n}",
     "    if (bulk_out && t == 0) ap::bulk_wait();\n  }\n"
     "  if (lane == 0) for (int i = 0; i < 8; ++i) g_prof_enc[(blockIdx.x * 16 + warp) * 8 + i] = pc[i];\n}"),
]


def make_tree(name: str, patches: list) -> str:
    """A copy of this tree's package under ab_trees/variants/<name> with
    ``patches`` applied; each text must occur in its source exactly once."""
    dst = os.path.join(OUT, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "color_modem_tpu_torch"),
                    os.path.join(dst, "color_modem_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, old, new in patches:
        path = os.path.join(dst, "color_modem_tpu_torch", rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {rel} has {text.count(old)} of {old[:60]!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def _setup(dev):
    import numpy as np
    import torch

    from color_modem_tpu_torch import SECAM
    from color_modem_tpu_torch.frame.pipeline import frame_line_index
    from color_modem_tpu_torch.kernels import secam as sk
    from color_modem_tpu_torch.modem.plan import make_plan

    plan = make_plan(SECAM(), 720).to(dev)
    isr = sk.isr_col(frame_line_index(plan, 3, 16, 576, dev))
    ycc = torch.tensor(np.random.default_rng(0).uniform(-0.6, 0.6, (16, 3, 576, 720)),
                       dtype=torch.float32, device=dev)
    comp = sk.encode_lines_plain(plan, ycc, isr)
    return {"encode": lambda: sk.encode_lines(plan, ycc, isr),
            "decode": lambda: sk.demodulate_lines(plan, comp, isr)}


def worker(tree: str, profile: bool) -> None:
    sys.path.insert(0, tree)
    import torch

    from color_modem_tpu_torch.kernels.build import load_library

    lib = load_library()
    calls = _setup(torch.device("cuda:0"))
    if not profile:
        sys.path.insert(0, os.path.join(HERE, "color_modem_tpu_torch", "kernels"))
        import measure

        print(json.dumps({k: statistics.median(measure.time_ms(fn, windows=10))
                          for k, fn in calls.items()}))
        return
    import numpy as np

    res = {}
    roles = {"decode": (("row", 0, 4), ("first group", 4, 11), ("second group", 11, 16)),
             "encode": (("row", 0, 4), ("FIR", 4, 16))}
    for name, fn in calls.items():
        read = getattr(lib, "secam_prof_" + name[:3])
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        counts = np.zeros(264 * 16 * 8, np.uint32)
        if read(counts.ctypes.data, counts.size) != 0:
            raise RuntimeError("cudaMemcpyFromSymbol failed")
        per_warp = counts.reshape(264, 16, 8)[: torch.cuda.get_device_properties(0)
                                              .multi_processor_count].astype(np.float64)
        res[name] = {role: [round(v / 1e3, 1) for v in per_warp[:, w0:w1].mean(axis=(0, 1))]
                     for role, w0, w1 in roles[name]}
    print(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.profile)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_secam_variants: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()

    def run(tree, profile=False):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", tree]
        out = subprocess.run(cmd + (["--profile"] if profile else []), check=True,
                             capture_output=True, text=True, timeout=180)
        return json.loads(out.stdout.strip().splitlines()[-1])

    record = {"card": card, "times": [], "profile": None}
    trees = [HERE] + [make_tree(v, VARIANTS[v]) for v in args.variants]
    for tree in trees + trees[::-1]:
        t = run(tree)
        record["times"].append({"tree": os.path.basename(tree) or ".", **t})
        print(f"{os.path.relpath(tree, HERE)} on {card}: encode {t['encode']:.4f} ms, "
              f"decode {t['decode']:.4f} ms", flush=True)
    if args.profile:
        record["profile"] = run(make_tree("profile", PROFILE_MARKS), profile=True)
        for name, roles in record["profile"].items():
            for role, kc in roles.items():
                print(f"{name} {role}: kcycles per warp by counter " +
                      " ".join(f"{i}:{v}" for i, v in enumerate(kc)))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
