// SECAM FM decode: blanking extension, band split and quadrature
// discriminator, every FIR on the tensor cores (band_fir.cuh's fir16).
//
// Replaces the Pallas kernel color_modem_tpu/kernels/secam.py::demodulate_lines
// (inner `kernel`, pallas_call at :271), and the blanking extension the JAX
// package runs before it (modem/secam.py::extend_blanking).
//
// Per line, at the extended width N + 2M, nothing leaving shared memory
// between stages (every FIR reads zeros outside [0, N + 2M)):
//   ext     = [lum_l + margin_carrier[isr] | comp | lum_r]
//             (lum_l, lum_r: means of the first and last K samples)
//   takeoff = ext (*) bell_takeoff,  band = ext (*) luma_notch
//   luma    = ext - band                               -> luma_out, cropped
//   i = (2*takeoff*mixcos) (*) mix_lpf,  q = (-2*takeoff*mixsin) (*) mix_lpf
//   di = i (*) diff,  dq = q (*) diff
//   f = fc + (i*dq - q*di) / max(i^2 + q^2, 1e-9) * fs/2pi
//   v = (f - f0) / dev  (*) deemph  (*) demod_lpf      -> v_out, cropped
// Each intermediate is zero outside the extended line, as the unpadded
// 'same' convolutions are (the TPU's _compose_same).  The division and the
// discriminator are IEEE (no --use_fast_math).
//
// What bounds it on an H100: at 9216 lines x 720 samples the FIRs (193 and
// 193 taps, 129 twice, 31 twice and 257 over the 816-sample extended line,
// the 129-tap demod_lpf over the cropped 720) are 16.20 GFLOP against
// 79.6 MB of device memory (one plane read, two written): 0.0982 ms at the
// 165 TFLOP/s of TF32 in three passes, 0.0238 ms at 3.35 TB/s.  The
// operations bound it, and no fp32 SIMT design can reach half that bound
// (at 67 TFLOP/s the FIRs alone take 0.242 ms).
//
// Design: one tile = 8 lines x one span of the line, the lines the N = 8
// columns of mma.m16n8k8 and 16 outputs its rows (band_fir.cuh's fir16),
// three TF32 passes, A read from the host-built tables of the reversed
// taps, B by ldmatrix from shared-memory planes this kernel wrote.
// Shared memory is the hard part: a plane of 16 lines x the 816-sample
// line with the de-emphasis halo is 70 KB, and the chain needs three live
// planes, about 300 KB.  So a tile holds 8 lines in three planes of 8 rows
// (105 KB at 720 samples, two blocks of 8 warps per SM; 212 KB at 1440, one
// block of 16 warps, so that as many warps hide each other's latency): ext ->
// takeoff -> (i over ext, q) -> v over the takeoff -> v (*) deemph over i;
// the mix with the host's cos/sin rows is applied as the takeoff loads as
// B, so one takeoff plane stands for the two mixed arms; the third plane
// first holds the tile's composite rows, copied by cp.async while the
// previous tile's last two stages run, and each warp builds its row of the
// extended line from them.  A line too wide even for that (2160 samples)
// is cut into spans that each recompute the halo of the whole chain
// (the stage ranges below).  A plane's column 0 is sample lo - h of the
// stage that reads it.  bell_takeoff and luma_notch share their B
// fragments, i and q the mix_lpf tables, di and dq the diff table.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): 0.46 ms at
// 16x576x720, 21% of the bound, against 0.53 ms for the fp32 SIMT kernel
// it replaces (-14%); 0.47 ms at 4x576x1440, level with it.  The products
// run near the mma.sync ceiling; the rest is latency between them.
// nvcc -Xptxas -v, sm_90a: 126 registers, no spills, no stack.

#include "band_fir.cuh"
#include "fir.cuh"

namespace {

constexpr int kRows = 8;  // lines per tile: the N of mma.m16n8k8
// (kW, kS) of each stage: output tiles per warp group, steps per block
constexpr int kWBand = 4, kSBand = 2;  // takeoff + notch: two tile sets, one B
constexpr int kWMix = 2, kSMix = 4;    // i + q: one tile set, two B (mixed on load)
constexpr int kWDiff = 2, kSDiff = 4;  // di + dq: one tile set, two planes
constexpr int kWOne = 4, kSOne = 8;    // deemph, demod_lpf

// The stages, in order: 0 takeoff/notch, 1 i/q, 2 discriminator (diff),
// 3 deemph, 4 demod_lpf.  Stage k's outputs cover [lo[k], hi[k]) of the
// extended line: each stage computes what the next one reads, clipped to
// the line.
struct Geom {
  int n, m, n_ext, span, n_spans, pitch;
  int h[5], steps[5];  // half-width and 16x8 steps of each stage's FIR

  __host__ __device__ void ranges(int p0, int (&lo)[5], int (&hi)[5]) const {
    lo[4] = m + p0;
    hi[4] = m + (p0 + span < n ? p0 + span : n);
    for (int k = 3; k >= 0; --k) {
      lo[k] = lo[k + 1] - h[k + 1] > 0 ? lo[k + 1] - h[k + 1] : 0;
      hi[k] = hi[k + 1] + h[k + 1] < n_ext ? hi[k + 1] + h[k + 1] : n_ext;
    }
  }
};

__host__ __device__ inline int tiles16(int len) { return (len + 15) / 16; }

__host__ __device__ constexpr int stage_kw(int k) {
  return k == 0 ? kWBand : k == 1 ? kWMix : k == 2 ? kWDiff : kWOne;
}

// Floats per plane row for `span`: the widest column count any stage of any
// span reads, padded to pitch % 32 == 4.
inline int pitch_for(Geom g) {
  int cols = 0;
  for (int p0 = 0; p0 < g.n; p0 += g.span) {
    int lo[5], hi[5];
    g.ranges(p0, lo, hi);
    for (int k = 0; k < 5; ++k) {
      const int c = bf::plane16_cols(tiles16(hi[k] - lo[k]), stage_kw(k), g.steps[k]);
      cols = c > cols ? c : cols;
    }
  }
  cols = cols > bf::round_up(g.n, 8) ? cols : bf::round_up(g.n, 8);  // plane 2 holds a row
  return bf::pitch_of(cols / 8);
}

__host__ __device__ inline size_t decode_smem(int pitch) {
  return sizeof(float) * 3 * kRows * static_cast<size_t>(pitch);
}

// Sum of x[0..k) by one warp.
__device__ inline float warp_sum(const float* __restrict__ x, int k) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = lane; i < k; i += 32) s += x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Zero columns [0, a) and [b, w) of the warp's row of a plane (warp w: row
// w): the edges of a stage's input outside the samples its producer writes.
__device__ inline void zero_outside(float* p, int pitch, int a, int b, int w) {
  if ((threadIdx.x >> 5) >= kRows) return;
  const int lane = threadIdx.x & 31;
  float* row = p + (threadIdx.x >> 5) * pitch;
  for (int k = lane; k < a; k += 32) row[k] = 0.0f;
  for (int k = b + lane; k < w; k += 32) row[k] = 0.0f;
}

// B for i and q: the takeoff plane at the lane's columns, times 2*cos and
// -2*sin of the mix ramp at those samples (the plain version's order).
struct MixB {
  bf::PlaneB t;
  int pos0;  // sample of the lane's column q of chunk 0
  int n_ext;
  const float* __restrict__ cs;
  const float* __restrict__ sn;
  __device__ void mix(float t, int col, float& i, float& q) const {
    int p = pos0 + col;
    p = p < 0 ? 0 : (p < n_ext ? p : n_ext - 1);
    i = (2.0f * t) * __ldg(cs + p);
    q = (-2.0f * t) * __ldg(sn + p);
  }
  __device__ void pair(int c, float (&v)[2][2][2]) const {
    float r[1][2][2];
    t.pair(c, r);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 2; ++k) mix(r[0][h][k], 8 * (c + h) + 4 * k, v[0][h][k], v[1][h][k]);
  }
  __device__ void one(int c, float (&v)[2][2]) const {
    float r[1][2];
    t.one(c, r);
#pragma unroll
    for (int k = 0; k < 2; ++k) mix(r[0][k], 8 * c + 4 * k, v[0][k], v[1][k]);
  }
};

// B for di and dq: the i and q planes at the lane's columns.
struct TwoPlanesB {
  bf::PlaneB a, b;
  __device__ void pair(int c, float (&v)[2][2][2]) const {
    float r[1][2][2];
    a.pair(c, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) v[0][h][0] = r[0][h][0], v[0][h][1] = r[0][h][1];
    b.pair(c, r);
#pragma unroll
    for (int h = 0; h < 2; ++h) v[1][h][0] = r[0][h][0], v[1][h][1] = r[0][h][1];
  }
  __device__ void one(int c, float (&v)[2][2]) const {
    float r[1][2];
    a.one(c, r);
    v[0][0] = r[0][0], v[0][1] = r[0][1];
    b.one(c, r);
    v[1][0] = r[0][0], v[1][1] = r[0][1];
  }
};

// NW warps: 8 where two blocks fit an SM, else 16 (one block); the row
// tasks (staging, the extended line, plane edges) take warps 0-7, one row
// each, and the FIRs all of them.
template <int NW>
__global__ void __launch_bounds__(32 * NW, 16 / NW)
secam_decode_kernel(const float* __restrict__ comp, const float* __restrict__ isr_col,
                    const float* __restrict__ margin_carrier,
                    const float* __restrict__ mixcos, const float* __restrict__ mixsin,
                    const float2* __restrict__ t_bell, const float2* __restrict__ t_notch,
                    const float2* __restrict__ t_mix, const float2* __restrict__ t_diff,
                    const float2* __restrict__ t_de, const float2* __restrict__ t_dm,
                    float* __restrict__ luma_out, float* __restrict__ v_out, int n_lines,
                    int luma_est, Geom geo, float fc, float inv2pi, float f0r, float f0b,
                    float devr, float devb) {
  extern __shared__ float4 smem4[];
  __shared__ int is_r[kRows];
#ifdef CMT_POISON
  bf::poison_shared(smem4, bf::dynamic_smem_bytes());
  bf::poison_shared(is_r, sizeof(is_r));
  __syncthreads();
#endif
  const int pitch = geo.pitch, n = geo.n, m = geo.m, n_ext = geo.n_ext;
  float* p0 = reinterpret_cast<float*>(smem4);  // ext, then i, then v (*) deemph
  float* p1 = p0 + kRows * pitch;               // takeoff, then v
  float* p2 = p1 + kRows * pitch;               // the composite rows, then q
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int total = (n_lines + kRows - 1) / kRows * geo.n_spans;

  // warp w copies the composite of row w of a tile into plane 2, and reads
  // its parity
  bool row_r = false;
  auto stage = [&](int tile) {
    const int line = tile / geo.n_spans * kRows + warp;
    const bool ok = warp < kRows && line < n_lines;
    if (warp < kRows)
      bf::warp_copy_row(p2 + warp * pitch, comp + static_cast<long long>(ok ? line : 0) * n,
                        n, ok);
    bf::cp_async_commit();
    row_r = ok && isr_col[line] != 0.0f;
  };
  if (static_cast<int>(blockIdx.x) < total) stage(blockIdx.x);

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int line0 = tile / geo.n_spans * kRows;
    int lo[5], hi[5];
    geo.ranges(tile % geo.n_spans * geo.span, lo, hi);
    const int org_e = lo[0] - geo.h[0], org_t = lo[1] - geo.h[1];
    const int org_iq = lo[2] - geo.h[2], org_v = lo[3] - geo.h[3];
    const int org_d = lo[4] - geo.h[4];
    int w_in[5];  // columns each stage reads from its input plane
#pragma unroll
    for (int k = 0; k < 5; ++k)
      w_in[k] = bf::plane16_cols(tiles16(hi[k] - lo[k]), stage_kw(k), geo.steps[k]);

    // stage 1: warp w builds row w of the extended line in plane 0 from
    // the composite row staged in plane 2: the blanking means, the margin
    // carrier of the row's parity
    bf::cp_async_wait<0>();
    __syncwarp();
    if (warp < kRows) {
      const bool ok = line0 + warp < n_lines;
      const float* c = p2 + warp * pitch;
      const float lum_l = warp_sum(c, luma_est) / static_cast<float>(luma_est);
      const float lum_r = warp_sum(c + n - luma_est, luma_est) / static_cast<float>(luma_est);
      const float* mc = margin_carrier + (row_r ? m : 0);
      float* row = p0 + warp * pitch;
      for (int col = lane; col < w_in[0]; col += 32) {
        const int pos = org_e + col;
        float e = 0.0f;
        if (ok && pos >= 0 && pos < n_ext) {
          if (pos < m) e = lum_l + __ldg(mc + pos);
          else if (pos < m + n) e = c[pos - m];
          else e = lum_r;
        }
        row[col] = e;
      }
      if (lane == 0) is_r[warp] = row_r;
    }
    __syncthreads();

    // the lane's two lines (accumulator rows 2q and 2q + 1)
    bool live[2];
    float f0[2], dv[2];
    float *luma_row[2], *v_row[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int line = line0 + 2 * q + k;
      live[k] = line < n_lines;
      f0[k] = is_r[2 * q + k] ? f0r : f0b;
      dv[k] = is_r[2 * q + k] ? devr : devb;
      luma_row[k] = luma_out + static_cast<long long>(live[k] ? line : 0) * n;
      v_row[k] = v_out + static_cast<long long>(live[k] ? line : 0) * n;
    }

    // stage 2: takeoff -> p1 (origin org_t), luma -> device memory
    zero_outside(p1, pitch, lo[0] - org_t, hi[0] - org_t, w_in[1]);
    {
      const float2* const at[2] = {t_bell, t_notch};
      const bf::PlaneB ldb(p0, pitch);
      const int nt = tiles16(hi[0] - lo[0]);
      for (int gi = warp; gi * kWBand < nt; gi += NW) {
        const int t0 = gi * kWBand;
        float acc[2][kWBand][4];
        bf::fir16<kWBand, kSBand, 2, 1>(t0, at, geo.steps[0], ldb, acc);
#pragma unroll
        for (int w = 0; w < kWBand; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = lo[0] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
            if (j >= hi[0]) continue;
            p1[row * pitch + j - org_t] = acc[0][w][e];
            if (j >= lo[4] && j < hi[4] && live[e & 1])
              luma_row[e & 1][j - m] = p0[row * pitch + j - org_e] - acc[1][w][e];
          }
      }
    }
    __syncthreads();

    // stage 3: i -> p0, q -> p2 (origin org_iq)
    zero_outside(p0, pitch, lo[1] - org_iq, hi[1] - org_iq, w_in[2]);
    zero_outside(p2, pitch, lo[1] - org_iq, hi[1] - org_iq, w_in[2]);
    {
      const float2* const at[1] = {t_mix};
      const MixB ldb{bf::PlaneB(p1, pitch), org_t + q, n_ext, mixcos, mixsin};
      const int nt = tiles16(hi[1] - lo[1]);
      for (int gi = warp; gi * kWMix < nt; gi += NW) {
        const int t0 = gi * kWMix;
        float acc[2][kWMix][4];
        bf::fir16<kWMix, kSMix, 1, 2>(t0, at, geo.steps[1], ldb, acc);
#pragma unroll
        for (int w = 0; w < kWMix; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = lo[1] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
            if (j >= hi[1]) continue;
            p0[row * pitch + j - org_iq] = acc[0][w][e];
            p2[row * pitch + j - org_iq] = acc[1][w][e];
          }
      }
    }
    __syncthreads();

    // stage 4: di, dq and the discriminator: v -> p1 (origin org_v)
    zero_outside(p1, pitch, lo[2] - org_v, hi[2] - org_v, w_in[3]);
    {
      const float2* const at[1] = {t_diff};
      const TwoPlanesB ldb{bf::PlaneB(p0, pitch), bf::PlaneB(p2, pitch)};
      const int nt = tiles16(hi[2] - lo[2]);
      for (int gi = warp; gi * kWDiff < nt; gi += NW) {
        const int t0 = gi * kWDiff;
        float acc[2][kWDiff][4];
        bf::fir16<kWDiff, kSDiff, 1, 2>(t0, at, geo.steps[2], ldb, acc);
#pragma unroll
        for (int w = 0; w < kWDiff; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = lo[2] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
            if (j >= hi[2]) continue;
            const float iv = p0[row * pitch + j - org_iq], qv = p2[row * pitch + j - org_iq];
            const float a2 = fmaxf(iv * iv + qv * qv, 1e-9f);
            const float f = fc + (iv * acc[1][w][e] - qv * acc[0][w][e]) / a2 * inv2pi;
            p1[row * pitch + j - org_v] = (f - f0[e & 1]) / dv[e & 1];
          }
      }
    }
    __syncthreads();

    // plane 2 is read: the next tile's composite lands in it meanwhile
    if (tile + static_cast<int>(gridDim.x) < total) stage(tile + gridDim.x);

    // stage 5: v (*) deemph -> p0 (origin org_d)
    zero_outside(p0, pitch, lo[3] - org_d, hi[3] - org_d, w_in[4]);
    {
      const float2* const at[1] = {t_de};
      const bf::PlaneB ldb(p1, pitch);
      const int nt = tiles16(hi[3] - lo[3]);
      for (int gi = warp; gi * kWOne < nt; gi += NW) {
        const int t0 = gi * kWOne;
        float acc[1][kWOne][4];
        bf::fir16<kWOne, kSOne, 1, 1>(t0, at, geo.steps[3], ldb, acc);
#pragma unroll
        for (int w = 0; w < kWOne; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = lo[3] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
            if (j < hi[3]) p0[row * pitch + j - org_d] = acc[0][w][e];
          }
      }
    }
    __syncthreads();

    // stage 6: demod_lpf over the span -> device memory
    {
      const float2* const at[1] = {t_dm};
      const bf::PlaneB ldb(p0, pitch);
      const int nt = tiles16(hi[4] - lo[4]);
      for (int gi = warp; gi * kWOne < nt; gi += NW) {
        const int t0 = gi * kWOne;
        float acc[1][kWOne][4];
        bf::fir16<kWOne, kSOne, 1, 1>(t0, at, geo.steps[4], ldb, acc);
#pragma unroll
        for (int w = 0; w < kWOne; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = lo[4] + 16 * (t0 + w) + bf::acc16_out(e);
            if (j < hi[4] && live[e & 1]) v_row[e & 1][j - m] = acc[0][w][e];
          }
      }
    }
    __syncthreads();  // p0 and is_r are rewritten by the next tile
  }
}

}  // namespace

// comp: (n_lines, N); isr: (n_lines,) 1.0 on D'R lines, 0.0 on D'B lines;
// margin_carrier: (2, M) [B, R]; mixcos, mixsin: (N + 2M,); t_bell,
// t_notch, t_mix, t_diff, t_de, t_dm: (8S + 24, 2) band tables
// (kernels/tiles.py::band_tiles16) of bell_takeoff, luma_notch (nt_band
// taps each), mix_lpf, diff, deemph, demod_lpf; luma_out, v_out: (n_lines,
// N).  inv2pi = fs / 2pi; f0r, f0b, devr, devb in Hz.
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
  Geom geo{};
  geo.n = n;
  geo.m = margin;
  geo.n_ext = n + 2 * margin;
  const int taps[5] = {nt_band, nt_mix, nt_diff, nt_de, nt_dm};
  for (int k = 0; k < 5; ++k) {
    geo.h[k] = (taps[k] - 1) / 2;
    geo.steps[k] = bf::n_steps16(taps[k]);
  }
  // the whole line where its planes fit a block, else the widest of
  // n / 2, n / 3, ... that fits
  size_t smem = 0;
  for (int parts = 1;; ++parts) {
    geo.span = (n + parts - 1) / parts;
    geo.n_spans = (n + geo.span - 1) / geo.span;
    geo.pitch = pitch_for(geo);
    smem = decode_smem(geo.pitch);
    if (smem <= bf::kSmemMax) break;
    if (geo.span == 1) return cudaErrorInvalidValue;
  }
  const int total = (n_lines + kRows - 1) / kRows * geo.n_spans;
  auto launch = [&](auto kernel, int warps, size_t (&opted)[bf::kMaxDevices]) {
    int blocks = 0;
    const cudaError_t err =
        bf::launch_blocks(kernel, smem, total, opted, blocks, 16 / warps);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, 32 * warps, smem, stream>>>(
        comp, isr, margin_carrier, mixcos, mixsin, reinterpret_cast<const float2*>(t_bell),
        reinterpret_cast<const float2*>(t_notch), reinterpret_cast<const float2*>(t_mix),
        reinterpret_cast<const float2*>(t_diff), reinterpret_cast<const float2*>(t_de),
        reinterpret_cast<const float2*>(t_dm), luma_out, v_out, n_lines, luma_est, geo, fc,
        inv2pi, f0r, f0b, devr, devb);
    return cudaGetLastError();
  };
  static size_t opted8[bf::kMaxDevices] = {}, opted16[bf::kMaxDevices] = {};
  return smem <= bf::kSmemBudget ? launch(secam_decode_kernel<8>, 8, opted8)
                                 : launch(secam_decode_kernel<16>, 16, opted16);
}
