"""The benchmark of color_modem_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).  Exits non-zero, printing no
result, without enough CUDA cards, or where a module of JAX or of the JAX
package was loaded.  A cell on several cards starts one process per card
(NCCL, rank 0 prints).  See ``portbench/README.md``.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
#: every build and kernel cache at a fixed place inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
#: a mesh cell's ranks are ended after this long (a checkout's first run
#: builds the kernels, and may take up to 1200 s in all)
RANKS_DEADLINE_S = 1150
#: a library that could load JAX by itself must not
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
#: one host thread for the CPU libraries: the host's share of the runner's
#: work then runs alike in every process (the port's own rank launcher
#: does the same)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def refuse_forbidden(harness) -> None:
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        sys.exit(3)


def launch_ranks(args, cell, harness) -> int:
    """One process per card; relay rank 0's output; every rank must end."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        logs = harness.scratch_dir()
    except RuntimeError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    procs, files = [], []
    for rank in range(cell.chips):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(cell.chips),
                   LOCAL_WORLD_SIZE=str(cell.chips), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PORTBENCH_T0=repr(T0))
        out = open(os.path.join(logs, f"rank{rank}.out"), "w+")
        err = open(os.path.join(logs, f"rank{rank}.err"), "w+")
        files.append((out, err))
        cmd = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), "--rank", str(rank)]
        procs.append(subprocess.Popen(cmd, stdout=out, stderr=err, env=env))
    codes = [None] * len(procs)
    try:
        while any(c is None for c in codes) and time.time() < T0 + RANKS_DEADLINE_S:
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            if any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        codes = [p.returncode for p in procs]
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        for f in (out, err):
            f.close()
            os.unlink(f.name)
    refuse_forbidden(harness)
    if any(codes):
        for rank, (o, e) in enumerate(texts):
            print(f"--- rank {rank} exit {codes[rank]}\n{e[-4000:]}", file=sys.stderr)
        return 1
    sys.stderr.write(texts[0][1])
    sys.stderr.flush()
    sys.stdout.write(texts[0][0])
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        return launch_ranks(args, cell, harness)
    rank = args.rank or 0
    t0 = float(os.environ.get("PORTBENCH_T0", T0))
    try:
        harness.scratch_dir()
    except RuntimeError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", rank), t0, world=cell.chips)
    refuse_forbidden(harness)
    if out is not None:
        harness.emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
