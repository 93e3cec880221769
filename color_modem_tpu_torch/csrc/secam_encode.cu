// SECAM FM encode: composite = Y + anti-cloche(FM carrier), one block per line.
//
// Replaces the Pallas kernel color_modem_tpu/kernels/secam.py::encode
// (inner `kernel`, pallas_call at :149).
//
// Per line, nothing leaving shared memory between stages:
//   d     = isr ? D'R : D'B                         (staged with a HELD halo)
//   dl    = d (*) comp_lpf                          (held edge)
//   dpre  = dl (*) preemph                          (dl re-staged, held halo)
//   df    = f0c + devc * dpre                       (rad/sample, about f_center)
//   dphi  = inclusive_scan(df) - df/2               (midpoint rule)
//   c     = cosf(carrier_ramp + dphi)               (staged with a ZERO halo)
//   out   = y + c (*) anticloche
// The two held FIRs run one after the other: that is
// fir_same_held(fir_same_held(d, comp_lpf), preemph), and not one held FIR of
// the composed taps, which differs at the edges.
//
// The scan: each thread sums a contiguous chunk of ceil(N/256) increments,
// the chunk totals are scanned across the block (warp __shfl_up_sync scans,
// one carry per warp through shared memory), and each thread walks its chunk
// again from its exclusive prefix.  Any N is covered.  The TPU kernel used a
// Kogge-Stone lane scan only because Mosaic had no cumsum.  dphi reaches
// about +-250 rad, so the cosine is IEEE cosf (no --use_fast_math).
//
// What bounds it on an H100: at 9216 lines x 720 samples the three FIRs are
// 129 + 257 + 193 = 579 taps, about 7.7 GFLOP of fp32 FMA, against about
// 80 MB of device memory (Y and the line's own chroma plane read, one plane
// written): FP32 SIMT work, as for the QAM kernels.  The TPU folded comp_lpf
// and preemph into one dense Toeplitz product in three bf16 passes; here each
// FIR is a direct banded fp32 sum out of shared memory (fir.cuh).  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W: 0.267 ms at 16x576x720, about 43% of
// the fp32 peak (PERF.md).

#include <algorithm>

#include "fir.cuh"

namespace {

constexpr int kThreads = cm::kThreadsWide;
constexpr int kWarps = kThreads / 32;

// Exclusive prefix sum of `v` over the block's threads in thread order.
__device__ inline float block_exclusive_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_tot[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < kWarps) warp_tot[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  return (warp > 0 ? warp_tot[warp - 1] : 0.0f) + (incl - v);
}

__global__ void __launch_bounds__(kThreads)
secam_encode_kernel(const float* __restrict__ ycc, const float* __restrict__ isr_col,
                    const float* __restrict__ ramp, const float* __restrict__ t_lpf,
                    const float* __restrict__ t_pre, const float* __restrict__ t_anti,
                    float* __restrict__ out, int lines_per_group, int n, int nt_lpf,
                    int nt_pre, int nt_anti, float f0r_c, float f0b_c, float devr_c,
                    float devb_c) {
  extern __shared__ float smem[];
  __shared__ float warp_tot[kWarps];
  const int h_lpf = (nt_lpf - 1) / 2, h_pre = (nt_pre - 1) / 2;
  const int h_anti = (nt_anti - 1) / 2;
  const int len_a = max(cm::staged_len(n, h_lpf), cm::staged_len(n, h_anti));
  const int len_b = cm::staged_len(n, h_pre);
  float* xa = smem;                    // d (held), then the carrier (zero halo)
  float* xb = xa + len_a;              // d (*) comp_lpf (held)
  float* df = xb + len_b;              // phase increments
  float* tl = df + cm::round4(n);
  float* tp = tl + cm::round4(nt_lpf);
  float* ta = tp + cm::round4(nt_pre);

  const long long line = blockIdx.x;
  const bool isr = isr_col[line] != 0.0f;
  cm::stage_line_held(xa, ycc + cm::plane_row(line, isr ? 1 : 2, lines_per_group, n),
                      n, h_lpf, len_a);
  cm::stage_taps(tl, t_lpf, nt_lpf);
  cm::stage_taps(tp, t_pre, nt_pre);
  cm::stage_taps(ta, t_anti, nt_anti);
  __syncthreads();

  const int groups = cm::n_groups(n);
  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float acc[cm::kOut];
    cm::fir_window(xa, tl, nt_lpf, j0, acc);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r)
      if (j0 + r < n) xb[j0 + r + h_pre] = acc[r];
  }
  __syncthreads();
  // held halo of the intermediate, from its own edge samples
  for (int i = threadIdx.x; i < len_b; i += blockDim.x) {
    if (i < h_pre) xb[i] = xb[h_pre];
    else if (i >= n + h_pre) xb[i] = xb[n - 1 + h_pre];
  }
  __syncthreads();

  const float f0c = isr ? f0r_c : f0b_c, devc = isr ? devr_c : devb_c;
  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float acc[cm::kOut];
    cm::fir_window(xb, tp, nt_pre, j0, acc);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r)
      if (j0 + r < n) df[j0 + r] = f0c + devc * acc[r];
  }
  cm::zero_halo(xa, n, h_anti, len_a);  // xa is read no more until the carrier
  __syncthreads();

  const int chunk = (n + kThreads - 1) / kThreads;
  const int b = min(static_cast<int>(threadIdx.x) * chunk, n);
  const int e = min(b + chunk, n);
  float s = 0.0f;
  for (int k = b; k < e; ++k) s += df[k];
  float run = block_exclusive_scan(s, warp_tot);
  for (int k = b; k < e; ++k) {
    const float v = df[k];
    run += v;
    xa[k + h_anti] = cosf(ramp[k] + (run - 0.5f * v));
  }
  __syncthreads();

  const float* y = ycc + cm::plane_row(line, 0, lines_per_group, n);
  float* o = out + line * n;
  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float acc[cm::kOut];
    cm::fir_window(xa, ta, nt_anti, j0, acc);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r) {
      const int j = j0 + r;
      if (j < n) o[j] = y[j] + acc[r];
    }
  }
}

}  // namespace

// ycc: (G, 3, L, N) with G*L = n_lines; isr: (n_lines,) 1.0 on D'R lines,
// 0.0 on D'B lines; ramp: (N,) carrier phase base; t_lpf, t_pre, t_anti:
// comp_lpf, preemph, anticloche taps; out: (n_lines, N).  f0r_c, f0b_c:
// (f0 - f_center) * 2pi/fs; devr_c, devb_c: dev * 2pi/fs.
extern "C" cudaError_t secam_encode(const float* ycc, const float* isr,
                                    const float* ramp, const float* t_lpf,
                                    const float* t_pre, const float* t_anti,
                                    float* out, int n_lines, int lines_per_group,
                                    int n, int nt_lpf, int nt_pre, int nt_anti,
                                    float f0r_c, float f0b_c, float devr_c,
                                    float devb_c, cudaStream_t stream) {
  if (n_lines <= 0) return cudaSuccess;
  if (lines_per_group <= 0 || n <= 0 || !cm::odd_taps(nt_lpf) ||
      !cm::odd_taps(nt_pre) || !cm::odd_taps(nt_anti))
    return cudaErrorInvalidValue;
  const int h_lpf = (nt_lpf - 1) / 2, h_pre = (nt_pre - 1) / 2;
  const int h_anti = (nt_anti - 1) / 2;
  // about 12.8 KB at 720 samples, 25.6 KB at 1440
  const size_t smem =
      (static_cast<size_t>(std::max(cm::staged_len(n, h_lpf), cm::staged_len(n, h_anti))) +
       cm::staged_len(n, h_pre) + cm::round4(n) + cm::round4(nt_lpf) +
       cm::round4(nt_pre) + cm::round4(nt_anti)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        secam_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  secam_encode_kernel<<<n_lines, kThreads, smem, stream>>>(
      ycc, isr, ramp, t_lpf, t_pre, t_anti, out, lines_per_group, n, nt_lpf, nt_pre,
      nt_anti, f0r_c, f0b_c, devr_c, devb_c);
  return cudaGetLastError();
}
