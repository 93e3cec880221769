// SECAM FM decode: blanking extension, band split and quadrature
// discriminator, one block per line.
//
// Replaces the Pallas kernel color_modem_tpu/kernels/secam.py::demodulate_lines
// (inner `kernel`, pallas_call at :271), and the blanking extension the JAX
// package runs before it (modem/secam.py::extend_blanking).
//
// Per line, at the extended width N + 2M, nothing leaving shared memory
// between stages (every staged array has a ZERO halo):
//   ext     = [lum_l + margin_carrier[isr] | comp | lum_r]
//             (lum_l, lum_r: means of the first and last K samples)
//   takeoff = ext (*) bell_takeoff,  band = ext (*) luma_notch
//   luma    = ext - band                               -> luma_out, cropped
//   a = 2*takeoff*mixcos,  b = -2*takeoff*mixsin       (host-built rows)
//   i = a (*) mix_lpf,  q = b (*) mix_lpf
//   di = i (*) diff,  dq = q (*) diff                  (i, q re-staged)
//   f = fc + (i*dq - q*di) / max(i^2 + q^2, 1e-9) * fs/2pi
//   v = (f - f0) / dev  (*) deemph  (*) demod_lpf     -> v_out, cropped
// Re-staging i and q with zero halos truncates them at N + 2M exactly as the
// unpadded 'same' convolutions do (the TPU's _compose_same).  The division
// and the discriminator are IEEE (no --use_fast_math).
//
// What bounds it on an H100: at 9216 lines the FIRs (193, 193, 129 twice,
// 31 twice and 257 taps over 816 samples, the 129-tap demod_lpf over the
// cropped 720) are about 16.2 GFLOP of fp32 FMA against about 80 MB of
// device memory (one plane read, two written): FP32 SIMT work.  Building the extended line in shared memory
// keeps the (lines, N + 2M) tensor out of device memory.  Shared memory is
// about 22.5 KB at 720 samples and 45 KB at 1440 (the buffers are reused
// between stages); above the default 48 KB, from about 1800 samples, the
// launch opts in to more.  Measured on an NVIDIA H100 80GB HBM3 at 700 W:
// 0.529 ms at 16x576x720, about 46% of the fp32 peak (PERF.md).

#include "fir.cuh"

namespace {

constexpr int kThreads = cm::kThreadsWide;

// Sum of x[0..k) by one warp.
__device__ inline float warp_sum(const float* __restrict__ x, int k) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = lane; i < k; i += 32) s += x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

struct Layout {
  int h_band, h_mix, h_diff, h_de, h_dm;
  int len_a, len_b, len_c, len_d;

  __host__ __device__ Layout(int n_ext, int nt_band, int nt_mix, int nt_diff,
                             int nt_de, int nt_dm)
      : h_band((nt_band - 1) / 2), h_mix((nt_mix - 1) / 2), h_diff((nt_diff - 1) / 2),
        h_de((nt_de - 1) / 2), h_dm((nt_dm - 1) / 2) {
    const int ea = cm::staged_len(n_ext, h_band), va = cm::staged_len(n_ext, h_de);
    const int eb = cm::staged_len(n_ext, h_mix), vb = cm::staged_len(n_ext, h_dm);
    len_a = ea > va ? ea : va;  // ext, then v
    len_b = eb > vb ? eb : vb;  // the a arm, then v (*) deemph
    len_c = eb;                 // the b arm
    len_d = cm::staged_len(n_ext, h_diff);  // i, and q after it
  }
  // floats of dynamic shared memory, the taps included
  __host__ __device__ int floats(int nt_band, int nt_mix, int nt_diff, int nt_de,
                                 int nt_dm) const {
    return len_a + len_b + len_c + 2 * len_d + 2 * cm::round4(nt_band) +
           cm::round4(nt_mix) + cm::round4(nt_diff) + cm::round4(nt_de) +
           cm::round4(nt_dm);
  }
};

__global__ void __launch_bounds__(kThreads)
secam_decode_kernel(const float* __restrict__ comp, const float* __restrict__ isr_col,
                    const float* __restrict__ margin_carrier,
                    const float* __restrict__ mixcos, const float* __restrict__ mixsin,
                    const float* __restrict__ t_bell, const float* __restrict__ t_notch,
                    const float* __restrict__ t_mix, const float* __restrict__ t_diff,
                    const float* __restrict__ t_de, const float* __restrict__ t_dm,
                    float* __restrict__ luma_out, float* __restrict__ v_out, int n,
                    int margin, int luma_est, int nt_band, int nt_mix, int nt_diff,
                    int nt_de, int nt_dm, float fc, float inv2pi, float f0r, float f0b,
                    float devr, float devb) {
  extern __shared__ float smem[];
  __shared__ float lum[2];
  const int n_ext = n + 2 * margin;
  const Layout lay(n_ext, nt_band, nt_mix, nt_diff, nt_de, nt_dm);
  float* xa = smem;              // ext, then v
  float* xb = xa + lay.len_a;    // a = 2*takeoff*mixcos, then v (*) deemph
  float* xc = xb + lay.len_b;    // b = -2*takeoff*mixsin
  float* xi = xc + lay.len_c;    // i
  float* xq = xi + lay.len_d;    // q
  float* tb = xq + lay.len_d;
  float* tn = tb + cm::round4(nt_band);
  float* tm = tn + cm::round4(nt_band);
  float* td = tm + cm::round4(nt_mix);
  float* te = td + cm::round4(nt_diff);
  float* tl = te + cm::round4(nt_de);

  const long long line = blockIdx.x;
  const bool isr = isr_col[line] != 0.0f;
  const float* c = comp + line * n;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    const float s = warp_sum(c, luma_est);
    if ((threadIdx.x & 31) == 0) lum[0] = s / static_cast<float>(luma_est);
  } else if (warp == 1) {
    const float s = warp_sum(c + n - luma_est, luma_est);
    if ((threadIdx.x & 31) == 0) lum[1] = s / static_cast<float>(luma_est);
  }
  for (int i = threadIdx.x; i < lay.len_b; i += blockDim.x) xb[i] = 0.0f;
  for (int i = threadIdx.x; i < lay.len_c; i += blockDim.x) xc[i] = 0.0f;
  for (int i = threadIdx.x; i < 2 * lay.len_d; i += blockDim.x) xi[i] = 0.0f;
  cm::stage_taps(tb, t_bell, nt_band);
  cm::stage_taps(tn, t_notch, nt_band);
  cm::stage_taps(tm, t_mix, nt_mix);
  cm::stage_taps(td, t_diff, nt_diff);
  cm::stage_taps(te, t_de, nt_de);
  cm::stage_taps(tl, t_dm, nt_dm);
  __syncthreads();

  // the extended line, zero halo
  const float* mc = margin_carrier + (isr ? margin : 0);
  for (int i = threadIdx.x; i < lay.len_a; i += blockDim.x) {
    const int s = i - lay.h_band;
    float e = 0.0f;
    if (s >= 0 && s < margin) e = lum[0] + mc[s];
    else if (s >= margin && s < margin + n) e = c[s - margin];
    else if (s >= margin + n && s < n_ext) e = lum[1];
    xa[i] = e;
  }
  __syncthreads();

  const int groups = cm::n_groups(n_ext);
  float* lo = luma_out + line * n;
  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float tk[cm::kOut], band[cm::kOut];
    cm::fir_window(xa, tb, nt_band, j0, tk);
    cm::fir_window(xa, tn, nt_band, j0, band);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r) {
      const int j = j0 + r;
      if (j >= n_ext) break;
      if (j >= margin && j < margin + n) lo[j - margin] = xa[j + lay.h_band] - band[r];
      xb[j + lay.h_mix] = 2.0f * tk[r] * mixcos[j];
      xc[j + lay.h_mix] = -2.0f * tk[r] * mixsin[j];
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float ai[cm::kOut], aq[cm::kOut];
    cm::fir_window(xb, tm, nt_mix, j0, ai);
    cm::fir_window(xc, tm, nt_mix, j0, aq);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r) {
      const int j = j0 + r;
      if (j >= n_ext) break;
      xi[j + lay.h_diff] = ai[r];
      xq[j + lay.h_diff] = aq[r];
    }
  }
  cm::zero_halo(xa, n_ext, lay.h_de, lay.len_a);  // xa is read no more until v
  __syncthreads();

  const float f0 = isr ? f0r : f0b, dev = isr ? devr : devb;
  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float di[cm::kOut], dq[cm::kOut];
    cm::fir_window(xi, td, nt_diff, j0, di);
    cm::fir_window(xq, td, nt_diff, j0, dq);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r) {
      const int j = j0 + r;
      if (j >= n_ext) break;
      const float iv = xi[j + lay.h_diff], qv = xq[j + lay.h_diff];
      const float a2 = fmaxf(iv * iv + qv * qv, 1e-9f);
      const float f = fc + (iv * dq[r] - qv * di[r]) / a2 * inv2pi;
      xa[j + lay.h_de] = (f - f0) / dev;
    }
  }
  cm::zero_halo(xb, n_ext, lay.h_dm, lay.len_b);  // xb is read no more until then
  __syncthreads();

  for (int q = threadIdx.x; q < groups; q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float acc[cm::kOut];
    cm::fir_window(xa, te, nt_de, j0, acc);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r) {
      const int j = j0 + r;
      if (j >= n_ext) break;
      xb[j + lay.h_dm] = acc[r];
    }
  }
  __syncthreads();

  // only the cropped window [M, M + N) is written; its groups start at the
  // group holding sample M
  float* vo = v_out + line * n;
  for (int q = margin / cm::kOut + threadIdx.x; q < cm::n_groups(margin + n);
       q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float acc[cm::kOut];
    cm::fir_window(xb, tl, nt_dm, j0, acc);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r) {
      const int j = j0 + r;
      if (j >= margin && j < margin + n) vo[j - margin] = acc[r];
    }
  }
}

}  // namespace

// comp: (n_lines, N); isr: (n_lines,) 1.0 on D'R lines, 0.0 on D'B lines;
// margin_carrier: (2, M) [B, R]; mixcos, mixsin: (N + 2M,); t_bell,
// t_notch: bell_takeoff, luma_notch taps (nt_band each); t_mix, t_diff,
// t_de, t_dm: mix_lpf, diff, deemph, demod_lpf taps; luma_out, v_out:
// (n_lines, N).  inv2pi = fs / 2pi; f0r, f0b, devr, devb in Hz.
extern "C" cudaError_t secam_decode(
    const float* comp, const float* isr, const float* margin_carrier,
    const float* mixcos, const float* mixsin, const float* t_bell,
    const float* t_notch, const float* t_mix, const float* t_diff, const float* t_de,
    const float* t_dm, float* luma_out, float* v_out, int n_lines, int n, int margin,
    int luma_est, int nt_band, int nt_mix, int nt_diff, int nt_de, int nt_dm, float fc,
    float inv2pi, float f0r, float f0b, float devr, float devb, cudaStream_t stream) {
  if (n_lines <= 0) return cudaSuccess;
  if (n <= 0 || margin < 0 || luma_est <= 0 || luma_est > n ||
      !cm::odd_taps(nt_band) || !cm::odd_taps(nt_mix) || !cm::odd_taps(nt_diff) ||
      !cm::odd_taps(nt_de) || !cm::odd_taps(nt_dm))
    return cudaErrorInvalidValue;
  const Layout lay(n + 2 * margin, nt_band, nt_mix, nt_diff, nt_de, nt_dm);
  const size_t smem =
      static_cast<size_t>(lay.floats(nt_band, nt_mix, nt_diff, nt_de, nt_dm)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        secam_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  secam_decode_kernel<<<n_lines, kThreads, smem, stream>>>(
      comp, isr, margin_carrier, mixcos, mixsin, t_bell, t_notch, t_mix, t_diff, t_de,
      t_dm, luma_out, v_out, n, margin, luma_est, nt_band, nt_mix, nt_diff, nt_de, nt_dm,
      fc, inv2pi, f0r, f0b, devr, devb);
  return cudaGetLastError();
}
