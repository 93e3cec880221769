"""The tensor-core ceilings of the banded FIRs on one CUDA GPU: the issue
rates of ``mma.sync.m16n8k8`` TF32 (the kernels' instruction,
``csrc/band_fir.cuh``) and of ``wgmma.mma_async.m64nNk8.f32.tf32.tf32``
(Hopper's warpgroup product, the alternative weighed in that header's
note) with nothing else in the loop.

    python3 scripts/torch_mma_ceiling.py

``mma.sync``: a kernel of 256 threads keeps 4, 8 or 16 independent
accumulators per warp, at one and two blocks per SM.  ``wgmma``: blocks of
one warpgroup issue groups of 8 products into one accumulator (two groups
in flight), for N in 8, 16, 32, 64, 128 and 256, with A from registers
("rs") or from shared memory ("ss"; B always from shared memory, both
without swizzle), at one and two warpgroups per SM.  The script prints
products per microsecond per SM, TFLOP/s and the share of the card's 495
TFLOP/s, and, for ``wgmma``, what ``ptxas`` said of each kernel's
products (a serialisation warning means they did not run asynchronously).
The CUDA source is written to a temporary directory and built there with
the flags of ``kernels/build.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from color_modem_tpu_torch.kernels.build import NVCC_FLAGS, find_nvcc  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NACC>
__global__ void __launch_bounds__(256, 2) mma_loop(float* out, int iters) {
  float acc[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 7, b1 = threadIdx.x * 13;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) mma_tf32(acc[k], a, b0, b1);
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NACC; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ inline uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

@WGMMA@

extern "C" int mma_ceiling(float* out, int blocks, int iters, int nacc) {
  if (nacc == 4) mma_loop<4><<<blocks, 256>>>(out, iters);
  else if (nacc == 8) mma_loop<8><<<blocks, 256>>>(out, iters);
  else mma_loop<16><<<blocks, 256>>>(out, iters);
  return cudaGetLastError();
}
"""


#: the wgmma widths of the sweep
WG_NS = (8, 16, 32, 64, 128, 256)
#: products per group; two groups stay in flight
WG_GROUP = 8


def wgmma_source() -> str:
    """One kernel per (N, A operand): wg_<N>_<rs|ss>, and their launcher."""
    parts = []
    for n in WG_NS:
        nd = n // 2
        outs = ", ".join(f"%{i}" for i in range(nd))
        cons = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
        for mode in ("rs", "ss"):
            if mode == "rs":
                a_ops = "{" + ", ".join(f"%{nd + i}" for i in range(4)) + "}"
                b_op = f"%{nd + 4}"
                ins = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db)'
            else:
                a_ops, b_op, ins = f"%{nd}", f"%{nd + 1}", '"l"(da), "l"(db)'
            parts.append(f"""
__global__ void __launch_bounds__(128, 2) wg_{n}_{mode}(float* out, int iters) {{
  __shared__ __align__(1024) float a_s[64 * 8];
  __shared__ __align__(1024) float b_s[{n} * 8];
  for (int i = threadIdx.x; i < 64 * 8; i += 128) a_s[i] = 1e-3f * (i % 7);
  for (int i = threadIdx.x; i < {n} * 8; i += 128) b_s[i] = 1e-3f * (i % 5);
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncthreads();
  float d[{nd}];
#pragma unroll
  for (int i = 0; i < {nd}; ++i) d[i] = 0.0f;
  const uint64_t da = wg_desc(a_s, 128, 256), db = wg_desc(b_s, 128, 256);
  const uint32_t a[4] = {{__float_as_uint(1e-3f * threadIdx.x), __float_as_uint(2e-3f),
                          __float_as_uint(3e-3f), __float_as_uint(4e-3f)}};
  (void)da;
  (void)a;
  for (int it = 0; it < iters; ++it) {{
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < {WG_GROUP}; ++k)
      asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, 1, 0;\\n"
                   "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
                   "{{{outs}}}, {a_ops}, {b_op}, p, 1, 1;\\n}}\\n"
                   : {cons}
                   : {ins});
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
  }}
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < {nd}; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}}
""")
    cases = "\n".join(
        f"  if (n == {n} && rs == {int(mode == 'rs')}) wg_{n}_{mode}<<<blocks, 128>>>(out, iters);"
        for n in WG_NS for mode in ("rs", "ss"))
    parts.append(f"""
extern "C" int wgmma_ceiling(float* out, int blocks, int iters, int n, int rs) {{
{cases}
  return cudaGetLastError();
}}
""")
    return "".join(parts)


def _event_ms(launch) -> float:
    import torch

    assert launch() == 0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    assert launch() == 0
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_mma_ceiling: needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "mma.so")
        with open(src, "w") as f:
            f.write(SOURCE.replace("@WGMMA@", wgmma_source()))
        built = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                                lib_path, src], capture_output=True, text=True)
        if built.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{built.stderr}")
        for line in built.stderr.splitlines():
            if "wgmma" in line.lower() and ("warn" in line.lower() or "serializ" in line.lower()):
                print("ptxas: " + line.strip())
        lib = ctypes.CDLL(lib_path)
        lib.mma_ceiling.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.wgmma_ceiling.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
        out = torch.empty(2 * sms * 256, device="cuda")
        iters = 4000
        for nacc in (4, 8, 16):
            for per_sm in (1, 2):
                blocks = per_sm * sms
                ms = _event_ms(lambda: lib.mma_ceiling(out.data_ptr(), blocks, iters, nacc))
                n = blocks * 8 * iters * nacc
                print(f"mma.sync.m16n8k8 tf32 on {card}: {nacc} accumulators per warp, "
                      f"{per_sm} block(s) of 8 warps per SM: {n / ms / 1e3 / sms:.1f} per us "
                      f"per SM, {n * 2048 / ms / 1e9:.1f} TFLOP/s, "
                      f"{100 * n * 2048 / ms / 1e9 / 495:.1f}% of 495")
        rows = []
        for nw in WG_NS:
            # about 2M tensor-core cycles per launch whatever N
            wg_iters = 512000 // nw
            for mode in ("rs", "ss"):
                for per_sm in (1, 2):
                    blocks = per_sm * sms
                    ms = _event_ms(lambda: lib.wgmma_ceiling(out.data_ptr(), blocks, wg_iters,
                                                             nw, int(mode == "rs")))
                    n = blocks * wg_iters * WG_GROUP
                    tflops = n * 2 * 64 * nw * 8 / ms / 1e9
                    rows.append({"n": nw, "a": mode, "warpgroups_per_sm": per_sm,
                                 "per_us_per_sm": n / ms / 1e3 / sms, "tflops": tflops})
                    print(f"wgmma.m64n{nw}k8 tf32, A from {'registers' if mode == 'rs' else 'shared'}"
                          f" on {card}: {per_sm} warpgroup(s) per SM: {n / ms / 1e3 / sms:.1f} "
                          f"per us per SM, {tflops:.1f} TFLOP/s, {100 * tflops / 495:.1f}% of 495")
        print(json.dumps({"card": card, "wgmma": rows}))


if __name__ == "__main__":
    main()
