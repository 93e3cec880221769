"""The tensor-core ceiling of the QAM kernels' FIR on one CUDA GPU: the
issue rate of ``mma.sync.m16n8k8`` TF32 (the instruction of
``csrc/band_fir.cuh``) with nothing else in the loop.

    python3 scripts/torch_mma_ceiling.py

A kernel of 256 threads keeps 4, 8 or 16 independent accumulators per warp
and issues nothing but the product, at one and two blocks per SM; the
script prints the products per microsecond per SM and the TFLOP/s.  The
CUDA source is written to a temporary directory and built there with the
flags of ``kernels/build.py``.
"""

from __future__ import annotations

import ctypes
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

extern "C" int mma_ceiling(float* out, int blocks, int iters, int nacc) {
  if (nacc == 4) mma_loop<4><<<blocks, 256>>>(out, iters);
  else if (nacc == 8) mma_loop<8><<<blocks, 256>>>(out, iters);
  else mma_loop<16><<<blocks, 256>>>(out, iters);
  return cudaGetLastError();
}
"""


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
            f.write(SOURCE)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.mma_ceiling.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        out = torch.empty(2 * sms * 256, device="cuda")
        iters = 4000
        for nacc in (4, 8, 16):
            for per_sm in (1, 2):
                blocks = per_sm * sms
                assert lib.mma_ceiling(out.data_ptr(), blocks, iters, nacc) == 0
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                assert lib.mma_ceiling(out.data_ptr(), blocks, iters, nacc) == 0
                stop.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(stop)
                n = blocks * 8 * iters * nacc
                print(f"mma.sync.m16n8k8 tf32 on {card}: {nacc} accumulators per warp, "
                      f"{per_sm} block(s) of 8 warps per SM: {n / ms / 1e3 / sms:.1f} per us "
                      f"per SM, {n * 2048 / ms / 1e9:.1f} TFLOP/s")


if __name__ == "__main__":
    main()
