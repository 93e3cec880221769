"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and load it with
``ctypes``.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds: one ``nvcc -c`` per source, all started together, then one link.
It goes to ``color_modem_tpu_torch/build/`` (git-ignored), named by a hash
of the sources and flags: an edited source builds anew, an unchanged one
loads what is there.  There is no fallback: without ``nvcc`` or with a
failing build, :func:`load_library` raises.

``load_library(poison=True)`` builds a second library from the same
sources with ``-DCMT_POISON`` (:data:`POISON_FLAGS`), under its own name:
each kernel then fills its shared memory with a NaN before its first
staging, for ``kernels/sanitize.py``.  It is built on its first use only;
the main library's flags, name and kernels are those of a build without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: no --use_fast_math: the kernels need IEEE sincosf, cosf and division
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: what the sanitizer's build adds (the kernels' ``#ifdef CMT_POISON`` blocks)
POISON_FLAGS = ("-DCMT_POISON",)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U32, _U64 = ctypes.c_uint32, ctypes.c_uint64
#: C signatures of the launch functions; each returns its cudaError_t
SIGNATURES = {
    # ycc, cols, ramp_cos, ramp_sin, tiles1, tiles2, out,
    # n_lines, lines_per_group, n, ntaps, a_ref, stream
    "qam_encode": (_P,) * 7 + (_I,) * 4 + (_F, _P),
    # sep, comp, cols, ramp_cos, ramp_sin, bpf_tiles, tiles1, tiles2, out,
    # n_lines, lines_per_group, n, ntaps, stream
    "qam_decode": (_P,) * 9 + (_I,) * 4 + (_P,),
    # ycc, isr, ramp, and the band tiles of comp_lpf, preemph, anticloche, out,
    # n_lines, lines_per_group, n, nt_lpf, nt_pre, nt_anti,
    # f0r_c, f0b_c, devr_c, devb_c, stream
    "secam_encode": (_P,) * 7 + (_I,) * 6 + (_F,) * 4 + (_P,),
    # comp, isr, margin_carrier, mixcos, mixsin, and the band tiles of
    # bell_takeoff, luma_notch, mix_lpf, diff, deemph, demod_lpf, luma_out, v_out,
    # n_lines, n, margin, luma_est, nt_band, nt_mix, nt_diff, nt_de, nt_dm,
    # fc, fs/2pi, f0r, f0b, devr, devb, stream
    "secam_decode": (_P,) * 13 + (_I,) * 9 + (_F,) * 6 + (_P,),
    # x, taps, out, n_lines, n, ntaps, held, stream
    "fir_check": (_P,) * 3 + (_I,) * 4 + (_P,),
    # x, tiles, out, n_lines, n, ntaps, stream
    "band_fir_check": (_P,) * 3 + (_I,) * 3 + (_P,),
    # out, k0, k1, words, stream
    "threefry_bits": (_P, _U32, _U32, _U64, _P),
    # x (may be NULL), out, k0, k1, fold, g0, sigma, words per item, items, stream
    "threefry_add_normal": (_P, _P, _U32, _U32, _I, _U32, _F, _U64, _I, _P),
    # x, mat, out, groups, samples per plane, clamp, stream
    "colour_matrix": (_P, _P, _P, _I, _U64, _I, _P),
    # x, mat, out, groups, lines, samples, stream
    "delayline_matrix": (_P, _P, _P, _I, _I, _I, _P),
    # x, out, groups, lines, samples, spacing, form, stream
    "comb_stencil": (_P, _P, _I, _I, _I, _I, _I, _P),
}

#: launches of each entry point of :data:`SIGNATURES` in this process by
#: :func:`launch_counted` (the wrappers' launches, not their plain versions)
LAUNCHES = dict.fromkeys(SIGNATURES, 0)


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA kernels cannot be built"
    )


def _sources(flags: tuple = NVCC_FLAGS) -> tuple[list[Path], str]:
    """The .cu files to compile, and a digest of every source and flag."""
    files = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return [f for f in files if f.suffix == ".cu"], h.hexdigest()[:16]


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build(poison: bool = False) -> Path:
    """Compile the library (with ``poison``, the sanitizer's) unless a build
    of these exact sources and flags exists."""
    flags = NVCC_FLAGS + POISON_FLAGS if poison else NVCC_FLAGS
    cu_files, digest = _sources(flags)
    kind = "poison_" if poison else ""
    out = BUILD_DIR / f"libcolor_modem_kernels_{kind}{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    # private names, then an atomic rename: concurrent builders never load a
    # half-written library
    tag = f"{kind}{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{f.stem}.{tag}.o" for f in cu_files]
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    compiles = [[nvcc, *flags, "-c", "-o", str(o), str(f)]
                for f, o in zip(cu_files, objs)]
    try:
        with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
            results = list(pool.map(_run, compiles))
        link = [nvcc, *flags, "-shared", "-o", str(tmp), *map(str, objs)]
        failed = [(c, r) for c, r in zip(compiles, results) if r.returncode != 0]
        if not failed:
            res = _run(link)
            if res.returncode != 0:
                failed = [(link, res)]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({r.returncode}) {' '.join(c)}\n{r.stderr}" for c, r in failed
            ))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


@lru_cache(maxsize=None)
def load_library(poison: bool = False) -> ctypes.CDLL:
    """Build if needed, load, and declare every launch function's C types;
    ``poison``: the sanitizer's build (module docstring)."""
    from color_modem_tpu_torch.utils.tracing import span

    with span("cm.build.library"):
        lib = ctypes.CDLL(str(build(poison)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return lib


def launch(lib: ctypes.CDLL, name: str, dev, args) -> None:
    """Call the launch function ``name`` of ``lib`` with ``args`` (the
    tensors' pointers, then the scalars) on ``dev``'s current stream; raise
    on the ``cudaError_t`` it returns."""
    import torch

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def launch_counted(name: str, dev, call: tuple, *outputs) -> None:
    """A wrapper's launch: launch ``name`` of the main library with the
    arguments ``call`` (tensors, None for a null pointer, then scalars),
    add one to ``LAUNCHES[name]``, and hand its ``outputs`` to the float
    checks (``utils/debug.py::note_kernel``)."""
    from color_modem_tpu_torch.utils.debug import note_kernel

    tensors, scalars = call
    launch(load_library(), name, dev,
           [*(None if t is None else t.data_ptr() for t in tensors), *scalars])
    LAUNCHES[name] += 1
    note_kernel(name, *outputs)
