// Shared pieces of the kernels (the tap-count check, plane offsets, the
// QAM carrier), and the direct SIMT 'same' FIR with its line staging that
// csrc/fir_check.cu runs: the card tests pin the zero and held edges that
// the SECAM kernels' staging must match with it.
//
// A line of N samples is staged in shared memory with a halo of
// half = (T-1)/2 samples on each side, so the FIR needs no bounds checks.
// A zero halo treats samples outside the line as zero, like
// np.convolve(mode='same'); a held halo repeats the edge sample, like
// np.convolve on np.pad(mode='edge') (the SECAM baseband filters).
// The taps are staged reversed and zero-padded to a multiple of 4.  Each
// thread computes kOut = 4 neighbouring outputs; per 4 taps it reads one
// float4 of samples (conflict-free: a warp's 32 float4s are 4 full
// wavefronts) and one broadcast float4 of taps for 16 FMAs.
#pragma once

#include <cuda_runtime.h>

namespace cm {

constexpr int kThreads = 192;  // 6 warps; 180 groups of 4 cover a 720-sample line
constexpr int kOut = 4;        // outputs per thread per group (one float4)

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline bool odd_taps(int t) { return t > 0 && t % 2 == 1; }
__host__ __device__ inline int n_groups(int n) { return (n + kOut - 1) / kOut; }

// Staged line length: the groups' span, both halos, and the float4 slack the
// last group's window reads as zeros; a multiple of 4 so that the arrays
// after it stay 16-byte aligned.
__host__ __device__ inline int staged_len(int n, int half) {
  return round4(n_groups(n) * kOut + 2 * half + 4);
}

// xs[i] = x[i - half] inside the line, 0 elsewhere, for i < len.
__device__ inline void stage_line(float* xs, const float* __restrict__ x, int n,
                                  int half, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int s = i - half;
    xs[i] = (s >= 0 && s < n) ? x[s] : 0.0f;
  }
}

// xs[i] = x[clamp(i - half, 0, n - 1)] for i < len: the held edge.
__device__ inline void stage_line_held(float* xs, const float* __restrict__ x,
                                       int n, int half, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    xs[i] = x[min(max(i - half, 0), n - 1)];
}

// tr[m] = taps[ntaps - 1 - m] for m < ntaps, 0 up to round4(ntaps).
__device__ inline void stage_taps(float* tr, const float* __restrict__ taps,
                                  int ntaps) {
  for (int i = threadIdx.x; i < round4(ntaps); i += blockDim.x)
    tr[i] = i < ntaps ? taps[ntaps - 1 - i] : 0.0f;
}

// acc[r] = sum_k taps[k] * x[j0 + r + half - k] for r < 4, with xs and tr
// staged as above: in m = 2*half - k, acc[r] = sum_m tr[m] * xs[j0 + r + m].
// j0 is a multiple of 4, so every float4 read is aligned.
__device__ inline void fir_window(const float* xs, const float* tr, int ntaps,
                                  int j0, float (&acc)[kOut]) {
  float4 cur = *reinterpret_cast<const float4*>(xs + j0);
#pragma unroll
  for (int r = 0; r < kOut; ++r) acc[r] = 0.0f;
  const int ntaps4 = round4(ntaps);
  for (int m = 0; m < ntaps4; m += 4) {
    const float4 nxt = *reinterpret_cast<const float4*>(xs + j0 + m + 4);
    const float4 t4 = *reinterpret_cast<const float4*>(tr + m);
    const float w[8] = {cur.x, cur.y, cur.z, cur.w, nxt.x, nxt.y, nxt.z, nxt.w};
    const float t[4] = {t4.x, t4.y, t4.z, t4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int r = 0; r < kOut; ++r) acc[r] = fmaf(t[u], w[r + u], acc[r]);
    }
    cur = nxt;
  }
}

// Carrier sin/cos at sample j by angle addition: one sincosf per line
// (s0, c0 of the line phase) against the host-built cos/sin ramp rows.
__device__ inline void carrier(float s0, float c0, const float* __restrict__ rc,
                               const float* __restrict__ rs, int j, float& sn,
                               float& cs) {
  const float a = rc[j], b = rs[j];
  sn = s0 * a + c0 * b;
  cs = c0 * a - s0 * b;
}

// Offset of component c of flat line `line` in a (G, 3, L, N) array.
__device__ inline long long plane_row(long long line, int c, int lines_per_group,
                                      int n) {
  const long long g = line / lines_per_group, l = line % lines_per_group;
  return ((g * 3 + c) * lines_per_group + l) * n;
}

}  // namespace cm
