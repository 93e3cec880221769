// QAM encode: composite = Y + chroma, with both chroma low-passes on the
// tensor cores (band_fir.cuh).
//
// Replaces the Pallas kernels color_modem_tpu/kernels/qam.py::_encode_kernel
// and _encode_kernel_shared (the same function with c1_lpf == c2_lpf; the
// two tile arrays cover both).
//
// Per line: c1 and c2 each through their own 'same' low-pass; carrier
// sin/cos = one sincosf of (phi0 + theta) by angle addition against the
// float64-built ramp rows; chroma = c1f*sin + vs*c2f*cos; NIIR reference
// lines take a_ref*sin instead; out = y + chroma.
//
// What bounds it on an H100: at 7680 lines x 720 samples x 129 taps one call
// reads three planes and writes one, 88.5 MB, 0.0264 ms at 3.35 TB/s; its
// two FIRs are 2.85 GFLOP, 0.0173 ms at 165 TFLOP/s (TF32 in three passes).
// The bytes bound it.  The TPU did each FIR as a dense 768x768 Toeplitz
// matmul in three bf16 passes (kernels/common.py::dot3), 5-6x the FLOPs;
// here the product is banded: 8x8 Toeplitz tiles, 5% above the direct FIR.
//
// Design: a tile is 16 lines x one span of the line (3 x 240 samples at 720
// with 129 taps, so that two stages of both planes fit two blocks per SM).
// Persistent blocks, two per SM, stage the next tile's c1 and c2 with their
// zero halos by cp.async while each warp computes groups of four output
// tiles of both filters of this one; the mix and the luma add run on the
// accumulator registers, and y is read from device memory there.
//
// nvcc -Xptxas -v, sm_90a (scripts/torch_ptxas_stats.py): 116 registers, no
// spills, a 32-byte stack frame (sincosf's slow path); 99,328 bytes of
// dynamic shared memory at 720 samples and 129 taps.

#include "band_fir.cuh"
#include "fir.cuh"

namespace {

// two stages (the tile being filtered and the next one) of two planes
__host__ __device__ inline size_t encode_smem(int span, int ntaps) {
  return sizeof(float) * bf::kRows * 4 *
         static_cast<size_t>(bf::pitch_of(bf::plane_chunks(span / 8, bf::n_steps(ntaps))));
}

__global__ void __launch_bounds__(bf::kThreads, bf::kBlocksPerSm)
qam_encode_kernel(const float* __restrict__ ycc, const float* __restrict__ cols,
                  const float* __restrict__ rc, const float* __restrict__ rs,
                  const float4* __restrict__ t1, const float4* __restrict__ t2,
                  float* __restrict__ out, int n_lines, int lines_per_group, int n,
                  int ntaps, float a_ref, int span, int vec) {
  extern __shared__ float4 smem4[];
#ifdef CMT_POISON
  bf::poison_shared(smem4, bf::dynamic_smem_bytes());
  __syncthreads();
#endif
  const int steps = bf::n_steps(ntaps), half = (ntaps - 1) / 2;
  const int pitch = bf::pitch_of(bf::plane_chunks(span / 8, steps));
  const int plane = bf::kRows * pitch;
  // stage k: c1 at k & 1, c2 one plane further
  auto stage_buf = [&](int k) {
    return reinterpret_cast<float*>(smem4) + (k & 1) * 2 * plane;
  };
  const int lpg = lines_per_group;
  const bf::TileGrid grid(n_lines, n, span);
  auto load = [&](int tile, float* xs) {
    int line0, p0;
    grid.at(tile, span, line0, p0);
    const int base = p0 - half;
    bf::stage(xs, pitch, base,
              [=](int line) { return ycc + cm::plane_row(line, 1, lpg, n); }, line0,
              n_lines, n, vec);
    bf::stage(xs + plane, pitch, base,
              [=](int line) { return ycc + cm::plane_row(line, 2, lpg, n); }, line0,
              n_lines, n, vec);
  };
  if ((int)blockIdx.x < grid.total) load(blockIdx.x, stage_buf(0));
  bf::cp_async_commit();

  for (int tile = blockIdx.x, k = 0; tile < grid.total; tile += gridDim.x, ++k) {
    if (tile + gridDim.x < grid.total) load(tile + gridDim.x, stage_buf(k + 1));
    bf::cp_async_commit();
    int line0, p0;
    grid.at(tile, span, line0, p0);
    const int end = min(p0 + span, n), nt = (end - p0 + 7) / 8;

    // the lane's two lines (accumulator rows g and g + 8), addressed once
    float s0[2], c0[2], vs[2], ref[2];
    bool live[2];
    const float* y_row[2];
    float* out_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int line = line0 + ((threadIdx.x & 31) >> 2) + 8 * h;
      live[h] = line < n_lines;
      s0[h] = c0[h] = vs[h] = ref[h] = 0.0f;
      y_row[h] = ycc;
      out_row[h] = out;
      if (live[h]) {
        sincosf(cols[line * 3 + 0], &s0[h], &c0[h]);
        vs[h] = cols[line * 3 + 1];
        ref[h] = cols[line * 3 + 2];
        y_row[h] = ycc + cm::plane_row(line, 0, lpg, n);
        out_row[h] = out + (long long)line * n;
      }
    }
    bf::cp_async_wait<1>();
    __syncthreads();

    const float* x1 = stage_buf(k);
    for (int gi = threadIdx.x >> 5; gi * bf::kW < nt; gi += bf::kWarps) {
      const int t0 = gi * bf::kW;
      float a1[bf::kW][4], a2[bf::kW][4];
      bf::fir_group(x1, pitch, t0, t1, steps, a1);
      bf::fir_group(x1 + plane, pitch, t0, t2, steps, a2);
#pragma unroll
      for (int w = 0; w < bf::kW; ++w) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live[h]) continue;
          const int pos = p0 + 8 * t0 + bf::acc_col(w, 0);
          const float2 y = bf::load2(y_row[h], pos, p0, end);
          float o[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float sn, cs;
            cm::carrier(s0[h], c0[h], rc, rs, min(pos + j, end - 1), sn, cs);
            float chroma = a1[w][2 * h + j] * sn + vs[h] * a2[w][2 * h + j] * cs;
            chroma = ref[h] * (a_ref * sn) + (1.0f - ref[h]) * chroma;
            o[j] = (j ? y.y : y.x) + chroma;
          }
          bf::store2(out_row[h], pos, p0, end, o[0], o[1]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
}

}  // namespace

// ycc: (G, 3, L, N) with G*L = n_lines; cols: (n_lines, 3) [phi0+theta,
// vsign, refmask]; rc, rs: (N,); tiles1, tiles2: (S, 32, 4) band tiles of
// c1_lpf and c2_lpf (ntaps taps each); out: (n_lines, N).
extern "C" cudaError_t qam_encode(const float* ycc, const float* cols,
                                  const float* rc, const float* rs,
                                  const float* tiles1, const float* tiles2,
                                  float* out, int n_lines, int lines_per_group,
                                  int n, int ntaps, float a_ref,
                                  cudaStream_t stream) {
  if (n_lines <= 0) return cudaSuccess;
  if (lines_per_group <= 0 || n <= 0 || !cm::odd_taps(ntaps))
    return cudaErrorInvalidValue;
  size_t smem = 0;
  const int span = bf::choose_span(n, [=](int s) { return encode_smem(s, ntaps); }, smem);
  if (span == 0) return cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(ycc) % 16 == 0;
  static size_t opted[bf::kMaxDevices] = {};
  int blocks = 0;
  const cudaError_t err =
      bf::launch_blocks(qam_encode_kernel, smem, bf::TileGrid(n_lines, n, span).total, opted, blocks);
  if (err != cudaSuccess) return err;
  qam_encode_kernel<<<blocks, bf::kThreads, smem, stream>>>(
      ycc, cols, rc, rs, reinterpret_cast<const float4*>(tiles1),
      reinterpret_cast<const float4*>(tiles2), out, n_lines, lines_per_group, n, ntaps,
      a_ref, span, vec);
  return cudaGetLastError();
}
