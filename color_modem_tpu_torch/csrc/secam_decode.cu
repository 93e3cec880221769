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
// The products: one tile = 8 lines x one span of the line, the lines the
// N = 8 columns of mma.m16n8k8 and 16 outputs its rows (band_fir.cuh's
// fir16), three TF32 passes, A read from the host-built tables of the
// reversed taps, B by ldmatrix from shared-memory planes this kernel wrote;
// the mix with the host's cos/sin rows is applied as the takeoff loads as
// B, so one takeoff plane stands for the two mixed arms.  bell_takeoff and
// luma_notch share their B fragments, i and q the mix_lpf tables, di and
// dq the diff table.  A plane's column 0 is sample lo - h of the stage
// that reads it.  8112 + 5616 + 1872 + 5304 + 2592 = 23,496 mma.sync per
// tile at 720 samples (band, mix, diff, deemph, demod).
//
// Two schedules of the same stages:
//
// The pipelined kernel (whole lines whose planes fit one block: 720 and
// 722 samples), one persistent block of 16 warps per SM, so that 16x576x720
// (1152 tiles) gives the busiest SM 9 tiles, the ceiling of the mean 8.73
// (two blocks per SM gave one SM 10).  Two tiles are in flight on separate
// warps, handed over by mbarriers (async_pipe.cuh) instead of block-wide
// barriers:
//   warps 0-3   stage tile t + 1: they copy its 8 composite rows by
//               cp.async straight into the ext plane and write the
//               blanking margins (the means read from device memory) and
//               the zeros around them;
//   warps 4-10  takeoff/notch (luma into staging rows, then bulk stores)
//               and the mix of tile t + 1: 13,728 products a tile;
//   warps 11-15 diff + discriminator, deemph and demod of tile t: 9,768
//               products a tile and the discriminator's divisions; v is
//               staged in the v plane, free once deemph has read it.
// Six planes of 8 rows, each as wide as its reader needs (ext, takeoff, i,
// q, v, v (*) deemph), the luma staging rows, the six tap tables and the
// mix rows: 217 KB at 720 samples.  ext full/empty pass between the row
// warps and the first group, i/q full/empty between the two groups; inside
// a group a named barrier orders its own stages.  Luma and v leave by
// bulk stores (cp.async.bulk) where rows are 16-byte aligned, by plain
// stores from the same staging rows where not (722 samples): plain stores
// throughout cost 6% at 720, bulk loads in place of cp.async gained
// nothing (scripts/torch_secam_variants.py), so the loads stay cp.async.
// The zeros around each plane's span are written once per launch: every
// tile has the same ranges.
//
// The serial kernel (wider lines: the six planes of a 1440-sample line
// need 427 KB): three planes of 8 rows, ext -> takeoff -> (i over ext, q)
// -> v over the takeoff -> v (*) deemph over i, all warps on each stage
// between block-wide barriers, the third plane first holding the tile's
// composite rows copied by cp.async while the previous tile's last two
// stages run; 212 KB at 1440, one block of 16 warps per SM.  A line too
// wide even for that (2160 samples) is cut into spans that each recompute
// the halo of the whole chain (the stage ranges below).  Every plane row
// holds at least a whole line, so above 2279 samples no span fits and the
// launch raises.  A thread-block cluster schedule for such lines (each CTA
// the pipelined kernel on a slice of the line, the halos written into the
// neighbours' planes through distributed shared memory) was built and
// measured: 0.36 ms in place of 1.25 at 1x576x2160, 1.75 in place of 1.38
// at 16x576x1440 (PERF.md section 6); no workload sends 2160-sample lines,
// so it is not kept.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (scripts/torch_kernel_ab.py,
// median of 10 windows of 20 launches; PERF.md section 6): the pipelined
// kernel 0.3936-0.3973 ms at 16x576x720, 24.7-24.9% of the bound, against
// 0.4615-0.4728 ms for the serial schedule there with two blocks of 8
// warps per SM (-15%); the serial kernel 0.47-0.48 ms at 4x576x1440,
// 1.3789-1.3864 ms at 16x576x1440 (28.4-28.6% of the bound) and 1.25-1.26
// ms at 1x576x2160 (14 spans, 4.4% of the bound).  Each FIR
// warp starts one product per about 30 cycles (three to an SM
// sub-partition: one per 10 cycles, against about 6.4 at mma.sync's
// measured ceiling); the second group alone takes 0.35 ms of the 0.40
// (scripts/torch_secam_variants.py).  The tap tables and mix rows in
// shared memory took about 4% off, setmaxnreg (the row warps' registers
// to the FIR warps: 56 and 152 a thread) about 5%.
// nvcc -Xptxas -v, sm_90a: 128 registers at entry (pipelined), 126
// (serial), no spills, no stack.

#include "async_pipe.cuh"
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

// One span's stage ranges, each stage's input origin (org[k] = lo[k] -
// h[k]: column 0 of the plane stage k reads) and the columns it reads.
struct Span {
  int lo[5], hi[5], org[5], w_in[5];
  __host__ __device__ Span(const Geom& g, int p0) {
    g.ranges(p0, lo, hi);
    for (int k = 0; k < 5; ++k) {
      org[k] = lo[k] - g.h[k];
      w_in[k] = bf::plane16_cols(tiles16(hi[k] - lo[k]), stage_kw(k), g.steps[k]);
    }
  }
};

// Floats per plane row for `span` (the serial kernel): the widest column
// count any stage of any span reads, padded to pitch % 32 == 4.
inline int pitch_for(Geom g) {
  int cols = 0;
  for (int p0 = 0; p0 < g.n; p0 += g.span) {
    const Span s(g, p0);
    for (int k = 0; k < 5; ++k) cols = s.w_in[k] > cols ? s.w_in[k] : cols;
  }
  cols = cols > bf::round_up(g.n, 8) ? cols : bf::round_up(g.n, 8);  // plane 2 holds a row
  return bf::pitch_of(cols / 8);
}

__host__ __device__ inline size_t decode_smem(int pitch) {
  return sizeof(float) * 3 * kRows * static_cast<size_t>(pitch);
}

// The pipelined kernel's shared memory, in floats: six planes of 8 rows,
// each as wide as the columns its reader reads and its writer writes, the
// luma staging rows (v is staged in the v plane, free once deemph has read
// it), the six tap tables and the mix rows.
struct PipeLayout {
  int pe, pt, pi, pv, pd, ps;       // row pitches
  int e, t, i, q, v, d, ls;         // offsets of the planes
  int tab[6], tab_len[6];           // offsets and floats of the tables
  int cs, sn, total;
  int cv;  // v's staging column in the v plane (inside the span diff rewrites)
};

inline PipeLayout pipe_layout(const Geom& g) {
  const Span s(g, 0);
  auto wider = [](int a, int b) { return a > b ? a : b; };
  PipeLayout L{};
  L.pe = ap::pitch8(s.w_in[0]);
  L.pt = ap::pitch8(wider(s.w_in[1], s.hi[0] - s.org[1]));
  L.pi = ap::pitch8(wider(s.w_in[2], s.hi[1] - s.org[2]));
  L.pv = ap::pitch8(wider(s.w_in[3], s.hi[2] - s.org[3]));
  L.pd = ap::pitch8(wider(s.w_in[4], s.hi[3] - s.org[4]));
  L.ps = bf::round_up(g.n, 4);
  L.e = 0;
  L.t = L.e + kRows * L.pe;
  L.i = L.t + kRows * L.pt;
  L.q = L.i + kRows * L.pi;
  L.v = L.q + kRows * L.pi;
  L.d = L.v + kRows * L.pv;
  L.ls = L.d + kRows * L.pd;
  int at = L.ls + kRows * L.ps;
  const int steps[6] = {g.steps[0], g.steps[0], g.steps[1], g.steps[2], g.steps[3], g.steps[4]};
  for (int k = 0; k < 6; ++k) {
    L.tab[k] = at;
    L.tab_len[k] = 2 * (8 * steps[k] + 24);  // kernels/tiles.py::band_tiles16
    at += L.tab_len[k];
  }
  L.cs = at;
  L.sn = L.cs + bf::round_up(g.n_ext, 4);
  L.total = L.sn + bf::round_up(g.n_ext, 4);
  L.cv = bf::round_up(s.lo[2] - s.org[3], 4);
  return L;
}

// The whole line's geometry: n samples, margin, the five stages' taps.
inline Geom line_geom(int n, int margin, const int (&taps)[5]) {
  Geom geo{};
  geo.n = n;
  geo.m = margin;
  geo.n_ext = n + 2 * margin;
  for (int k = 0; k < 5; ++k) {
    geo.h[k] = (taps[k] - 1) / 2;
    geo.steps[k] = bf::n_steps16(taps[k]);
  }
  geo.span = n;
  geo.n_spans = 1;
  return geo;
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
// -2*sin of the mix ramp at those samples (the plain version's order); Tab:
// where the mix rows lie.
template <class Tab>
struct MixB {
  bf::PlaneB t;
  int pos0;  // sample of the lane's column q of chunk 0
  int n_ext;
  const float* __restrict__ cs;
  const float* __restrict__ sn;
  __device__ void mix(float t, int col, float& i, float& q) const {
    int p = pos0 + col;
    p = p < 0 ? 0 : (p < n_ext ? p : n_ext - 1);
    i = (2.0f * t) * Tab::ld(cs + p);
    q = (-2.0f * t) * Tab::ld(sn + p);
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

// --- the stages, run by warps gw, gw + G, ... of a group of G warps -------

// The FIR tables, in stage order.
struct Tables {
  const float2 *bell, *notch, *mix, *diff, *de, *dm;
};

// ext (*) bell_takeoff -> T (origin org[1]); luma(row, e, j, ext - band)
// for the cropped samples j in [lo[4], hi[4]).
template <class Tab, class Luma>
__device__ inline void stage_band(int gw, int G, const Geom& g, const Span& s, const float* E,
                                  int pe, float* T, int pt, const Tables& tb, Luma luma) {
  const float2* const at[2] = {tb.bell, tb.notch};
  const bf::PlaneB ldb(E, pe);
  const int nt = tiles16(s.hi[0] - s.lo[0]);
  for (int gi = gw; gi * kWBand < nt; gi += G) {
    const int t0 = gi * kWBand;
    float acc[2][kWBand][4];
    bf::fir16<kWBand, kSBand, 2, 1, Tab>(t0, at, g.steps[0], ldb, acc);
#pragma unroll
    for (int w = 0; w < kWBand; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = s.lo[0] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
        if (j >= s.hi[0]) continue;
        T[row * pt + j - s.org[1]] = acc[0][w][e];
        if (j >= s.lo[4] && j < s.hi[4]) luma(row, e, j, E[row * pe + j - s.org[0]] - acc[1][w][e]);
      }
  }
}

// i -> I, q -> Q (origin org[2]) from the takeoff plane T.
template <class Tab>
__device__ inline void stage_mix(int gw, int G, const Geom& g, const Span& s, const float* T,
                                 int pt, float* I, float* Q, int pi, const float* mixcos,
                                 const float* mixsin, const Tables& tb) {
  const float2* const at[1] = {tb.mix};
  const MixB<Tab> ldb{bf::PlaneB(T, pt), s.org[1] + static_cast<int>(threadIdx.x & 3), g.n_ext,
                         mixcos, mixsin};
  const int nt = tiles16(s.hi[1] - s.lo[1]);
  for (int gi = gw; gi * kWMix < nt; gi += G) {
    const int t0 = gi * kWMix;
    float acc[2][kWMix][4];
    bf::fir16<kWMix, kSMix, 1, 2, Tab>(t0, at, g.steps[1], ldb, acc);
#pragma unroll
    for (int w = 0; w < kWMix; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = s.lo[1] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
        if (j >= s.hi[1]) continue;
        I[row * pi + j - s.org[2]] = acc[0][w][e];
        Q[row * pi + j - s.org[2]] = acc[1][w][e];
      }
  }
}

// di, dq and the discriminator -> V (origin org[3]); f0, dv: the rest
// frequency and deviation of the lane's rows 2q and 2q + 1.
template <class Tab>
__device__ inline void stage_diff(int gw, int G, const Geom& g, const Span& s, const float* I,
                                  const float* Q, int pi, float* V, int pv, const Tables& tb,
                                  float fc, float inv2pi, const float (&f0)[2],
                                  const float (&dv)[2]) {
  const float2* const at[1] = {tb.diff};
  const TwoPlanesB ldb{bf::PlaneB(I, pi), bf::PlaneB(Q, pi)};
  const int nt = tiles16(s.hi[2] - s.lo[2]);
  for (int gi = gw; gi * kWDiff < nt; gi += G) {
    const int t0 = gi * kWDiff;
    float acc[2][kWDiff][4];
    bf::fir16<kWDiff, kSDiff, 1, 2, Tab>(t0, at, g.steps[2], ldb, acc);
#pragma unroll
    for (int w = 0; w < kWDiff; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = s.lo[2] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
        if (j >= s.hi[2]) continue;
        const float iv = I[row * pi + j - s.org[2]], qv = Q[row * pi + j - s.org[2]];
        const float a2 = fmaxf(iv * iv + qv * qv, 1e-9f);
        const float f = fc + (iv * acc[1][w][e] - qv * acc[0][w][e]) / a2 * inv2pi;
        V[row * pv + j - s.org[3]] = (f - f0[e & 1]) / dv[e & 1];
      }
  }
}

// v (*) deemph -> D (origin org[4]).
template <class Tab>
__device__ inline void stage_deemph(int gw, int G, const Geom& g, const Span& s, const float* V,
                                    int pv, float* D, int pd, const Tables& tb) {
  const float2* const at[1] = {tb.de};
  const bf::PlaneB ldb(V, pv);
  const int nt = tiles16(s.hi[3] - s.lo[3]);
  for (int gi = gw; gi * kWOne < nt; gi += G) {
    const int t0 = gi * kWOne;
    float acc[1][kWOne][4];
    bf::fir16<kWOne, kSOne, 1, 1, Tab>(t0, at, g.steps[3], ldb, acc);
#pragma unroll
    for (int w = 0; w < kWOne; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = s.lo[3] + 16 * (t0 + w) + bf::acc16_out(e), row = bf::acc16_row(e);
        if (j < s.hi[3]) D[row * pd + j - s.org[4]] = acc[0][w][e];
      }
  }
}

// demod_lpf over the span: out(row, e, j, v) for j in [lo[4], hi[4]).
template <class Tab, class Out>
__device__ inline void stage_demod(int gw, int G, const Geom& g, const Span& s, const float* D,
                                   int pd, const Tables& tb, Out out) {
  const float2* const at[1] = {tb.dm};
  const bf::PlaneB ldb(D, pd);
  const int nt = tiles16(s.hi[4] - s.lo[4]);
  for (int gi = gw; gi * kWOne < nt; gi += G) {
    const int t0 = gi * kWOne;
    float acc[1][kWOne][4];
    bf::fir16<kWOne, kSOne, 1, 1, Tab>(t0, at, g.steps[4], ldb, acc);
#pragma unroll
    for (int w = 0; w < kWOne; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = s.lo[4] + 16 * (t0 + w) + bf::acc16_out(e);
        if (j < s.hi[4]) out(bf::acc16_row(e), e, j, acc[0][w][e]);
      }
  }
}

// --- the serial kernel -----------------------------------------------------

// One block of 16 warps per SM; the row tasks (staging, the extended line,
// plane edges) take warps 0-7, one row each, and the FIRs all of them.
constexpr int NW = 16;
__global__ void __launch_bounds__(32 * NW, 1)
secam_decode_kernel(const float* __restrict__ comp, const float* __restrict__ isr_col,
                    const float* __restrict__ margin_carrier,
                    const float* __restrict__ mixcos, const float* __restrict__ mixsin,
                    Tables tb, float* __restrict__ luma_out, float* __restrict__ v_out,
                    int n_lines, int luma_est, Geom geo, float fc, float inv2pi, float f0r,
                    float f0b, float devr, float devb) {
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
    const Span s(geo, tile % geo.n_spans * geo.span);

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
      for (int col = lane; col < s.w_in[0]; col += 32) {
        const int pos = s.org[0] + col;
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
    auto to_rows = [&](float* const (&rows)[2]) {
      return [&, rows](int, int e, int j, float v) {
        if (live[e & 1]) rows[e & 1][j - m] = v;
      };
    };

    // stage 2: takeoff -> p1 (origin org[1]), luma -> device memory
    zero_outside(p1, pitch, s.lo[0] - s.org[1], s.hi[0] - s.org[1], s.w_in[1]);
    stage_band<bf::GlobalTables>(warp, NW, geo, s, p0, pitch, p1, pitch, tb, to_rows(luma_row));
    __syncthreads();

    // stage 3: i -> p0, q -> p2 (origin org[2])
    zero_outside(p0, pitch, s.lo[1] - s.org[2], s.hi[1] - s.org[2], s.w_in[2]);
    zero_outside(p2, pitch, s.lo[1] - s.org[2], s.hi[1] - s.org[2], s.w_in[2]);
    stage_mix<bf::GlobalTables>(warp, NW, geo, s, p1, pitch, p0, p2, pitch, mixcos, mixsin, tb);
    __syncthreads();

    // stage 4: di, dq and the discriminator: v -> p1 (origin org[3])
    zero_outside(p1, pitch, s.lo[2] - s.org[3], s.hi[2] - s.org[3], s.w_in[3]);
    stage_diff<bf::GlobalTables>(warp, NW, geo, s, p0, p2, pitch, p1, pitch, tb, fc, inv2pi, f0,
                                 dv);
    __syncthreads();

    // plane 2 is read: the next tile's composite lands in it meanwhile
    if (tile + static_cast<int>(gridDim.x) < total) stage(tile + gridDim.x);

    // stage 5: v (*) deemph -> p0 (origin org[4])
    zero_outside(p0, pitch, s.lo[3] - s.org[4], s.hi[3] - s.org[4], s.w_in[4]);
    stage_deemph<bf::GlobalTables>(warp, NW, geo, s, p1, pitch, p0, pitch, tb);
    __syncthreads();

    // stage 6: demod_lpf over the span -> device memory
    stage_demod<bf::GlobalTables>(warp, NW, geo, s, p0, pitch, tb, to_rows(v_row));
    __syncthreads();  // p0 and is_r are rewritten by the next tile
  }
}

// --- the pipelined kernel --------------------------------------------------

constexpr int kRowWarps = 4, kWarpsA = 7, kWarpsB = 5;
constexpr int kPipeWarps = kRowWarps + kWarpsA + kWarpsB;
constexpr int kThreadsA = 32 * kWarpsA, kThreadsB = 32 * kWarpsB;
// setmaxnreg: the row warps give up registers, the FIR warps take them.
// A warp that asks for more than the others gave up waits forever, so
// what the FIR warps take is at most what the row warps give, counted from
// the registers the launch bounds leave a thread (128 for 16 warps).
constexpr int kRowRegs = 56, kFirRegs = 152;
constexpr int kEntryRegs = 65536 / (32 * kPipeWarps) / 8 * 8;
static_assert(kRowWarps % 4 == 0, "setmaxnreg moves registers between whole warpgroups");
static_assert(kRowWarps * (kEntryRegs - kRowRegs) >=
                  (kWarpsA + kWarpsB) * (kFirRegs - kEntryRegs),
              "setmaxnreg: the FIR warps would ask for registers no warp gave up");
enum { kEFull, kEEmpty, kIQFull, kIQEmpty, kBars };

// rows [0, rows) of `src` (pitch ps) -> device rows line0.. of `dst` (n
// floats each): bulk stores by thread t == 0 of the group (its bulk
// group committed), or plain stores by all `threads` of it.
__device__ inline void store_rows(int t, int threads, bool bulk, const float* src, int ps,
                                  float* dst, int rows, int n) {
  if (bulk) {
    if (t == 0) {
      for (int r = 0; r < rows; ++r)
        ap::bulk_store(dst + static_cast<long long>(r) * n, src + r * ps, 4 * n);
      ap::bulk_commit();
    }
    return;
  }
  for (int i = t; i < rows * n; i += threads) dst[i] = src[i / n * ps + i % n];
}

__global__ void __launch_bounds__(32 * kPipeWarps, 1)
secam_decode_pipe(const float* __restrict__ comp, const float* __restrict__ isr_col,
                  const float* __restrict__ margin_carrier, const float* __restrict__ mixcos,
                  const float* __restrict__ mixsin, Tables tb, float* __restrict__ luma_out,
                  float* __restrict__ v_out, int n_lines, int luma_est, Geom geo, PipeLayout L,
                  int bulk_out, float fc, float inv2pi, float f0r, float f0b,
                  float devr, float devb) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[kBars];
#ifdef CMT_POISON
  bf::poison_shared(smem4, bf::dynamic_smem_bytes());
  __syncthreads();
#endif
  float* sm = reinterpret_cast<float*>(smem4);
  float *E = sm + L.e, *T = sm + L.t, *I = sm + L.i, *Q = sm + L.q;
  float *V = sm + L.v, *D = sm + L.d, *LS = sm + L.ls;
  const int n = geo.n, m = geo.m;
  const Span s(geo, 0);
  const int c_comp = m - s.org[0];  // ext column of composite sample 0
  const int total = (n_lines + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // every tile has the same ranges: the zeros around them, once
  zero_outside(T, L.pt, s.lo[0] - s.org[1], s.hi[0] - s.org[1], s.w_in[1]);
  zero_outside(I, L.pi, s.lo[1] - s.org[2], s.hi[1] - s.org[2], s.w_in[2]);
  zero_outside(Q, L.pi, s.lo[1] - s.org[2], s.hi[1] - s.org[2], s.w_in[2]);
  zero_outside(V, L.pv, s.lo[2] - s.org[3], s.hi[2] - s.org[3], s.w_in[3]);
  zero_outside(D, L.pd, s.lo[3] - s.org[4], s.hi[3] - s.org[4], s.w_in[4]);
  // the tap tables and the mix rows, read by every tile
  const float2* const tg[6] = {tb.bell, tb.notch, tb.mix, tb.diff, tb.de, tb.dm};
  for (int k = 0; k < 6; ++k)
    for (int i = threadIdx.x; i < L.tab_len[k]; i += blockDim.x)
      sm[L.tab[k] + i] = reinterpret_cast<const float*>(tg[k])[i];
  for (int i = threadIdx.x; i < geo.n_ext; i += blockDim.x) {
    sm[L.cs + i] = mixcos[i];
    sm[L.sn + i] = mixsin[i];
  }
  const Tables ts{reinterpret_cast<const float2*>(sm + L.tab[0]),
                  reinterpret_cast<const float2*>(sm + L.tab[1]),
                  reinterpret_cast<const float2*>(sm + L.tab[2]),
                  reinterpret_cast<const float2*>(sm + L.tab[3]),
                  reinterpret_cast<const float2*>(sm + L.tab[4]),
                  reinterpret_cast<const float2*>(sm + L.tab[5])};
  if (threadIdx.x == 0) {
    ap::init(&bars[kEFull], 32 * kRowWarps);
    ap::init(&bars[kEEmpty], kThreadsA);
    ap::init(&bars[kIQFull], kThreadsA);
    ap::init(&bars[kIQEmpty], kThreadsB);
    ap::fence_init();
  }
  __syncthreads();

  if (warp < kRowWarps) {
    // the row warps' registers go to the FIR warps (4 x 56 + 12 x 152
    // a thread fill the register file)
    ap::regs_down<kRowRegs>();
    // the ext plane of each tile: composite rows by cp.async, margins and
    // zeros by the four warps
    int k = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
      const int line0 = tile * kRows;
      const int rows = n_lines - line0 < kRows ? n_lines - line0 : kRows;
      ap::wait(&bars[kEEmpty], (k & 1) ^ 1);
      for (int r = warp; r < kRows; r += kRowWarps) {
        const bool ok = r < rows;
        const float* c = comp + static_cast<long long>(ok ? line0 + r : 0) * n;
        float* row = E + r * L.pe;
        float lum_l = 0.0f, lum_r = 0.0f;
        const float* mc = margin_carrier;
        if (ok) {
          lum_l = warp_sum(c, luma_est) / static_cast<float>(luma_est);
          lum_r = warp_sum(c + n - luma_est, luma_est) / static_cast<float>(luma_est);
          if (isr_col[line0 + r] != 0.0f) mc += m;
        }
        for (int col = lane; col < s.w_in[0]; col += 32) {
          if (ok && col >= c_comp && col < c_comp + n) continue;  // the copy's
          const int pos = s.org[0] + col;
          float e = 0.0f;
          if (ok && pos >= 0 && pos < geo.n_ext) e = pos < m ? lum_l + __ldg(mc + pos) : lum_r;
          row[col] = e;
        }
        if (ok) bf::warp_copy_row(row + c_comp, c, n, true);
      }
      bf::cp_async_commit();
      bf::cp_async_wait<0>();
      ap::arrive(&bars[kEFull]);
    }
  } else {
    ap::regs_up<kFirRegs>();
    if (warp < kRowWarps + kWarpsA) {
      // takeoff/notch and the mix of each tile
      const int gw = warp - kRowWarps, t = threadIdx.x - 32 * kRowWarps;
      int k = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
        const int line0 = tile * kRows;
        const int rows = n_lines - line0 < kRows ? n_lines - line0 : kRows;
        ap::wait(&bars[kEFull], k & 1);
        stage_band<bf::SharedTables>(gw, kWarpsA, geo, s, E, L.pe, T, L.pt, ts,
                                     [&](int row, int, int j, float v) {
                                       LS[row * L.ps + j - s.lo[4]] = v;
                                     });
        ap::arrive(&bars[kEEmpty]);
        if (bulk_out) ap::fence_async();
        ap::group_sync(1, kThreadsA);
        store_rows(t, kThreadsA, bulk_out, LS, L.ps, luma_out + static_cast<long long>(line0) * n,
                   rows, n);
        ap::wait(&bars[kIQEmpty], (k & 1) ^ 1);
        stage_mix<bf::SharedTables>(gw, kWarpsA, geo, s, T, L.pt, I, Q, L.pi, sm + L.cs, sm + L.sn,
                                    ts);
        ap::arrive(&bars[kIQFull]);
        if (bulk_out && t == 0) ap::bulk_wait_read();
        ap::group_sync(1, kThreadsA);  // T and the luma rows are rewritten next
      }
      if (bulk_out && t == 0) ap::bulk_wait();
    } else {
      // diff + discriminator, deemph and demod of each tile
      const int gw = warp - kRowWarps - kWarpsA, t = threadIdx.x - 32 * (kRowWarps + kWarpsA);
      const int q = lane & 3;
      int k = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++k) {
        const int line0 = tile * kRows;
        const int rows = n_lines - line0 < kRows ? n_lines - line0 : kRows;
        float f0[2], dv[2];
  #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool red = 2 * q + r < rows && isr_col[line0 + 2 * q + r] != 0.0f;
          f0[r] = red ? f0r : f0b;
          dv[r] = red ? devr : devb;
        }
        if (bulk_out && t == 0) ap::bulk_wait_read();
        ap::group_sync(2, kThreadsB);  // the previous tile's v rows have left V
        ap::wait(&bars[kIQFull], k & 1);
        stage_diff<bf::SharedTables>(gw, kWarpsB, geo, s, I, Q, L.pi, V, L.pv, ts, fc, inv2pi, f0,
                                     dv);
        ap::arrive(&bars[kIQEmpty]);
        ap::group_sync(2, kThreadsB);
        stage_deemph<bf::SharedTables>(gw, kWarpsB, geo, s, V, L.pv, D, L.pd, ts);
        ap::group_sync(2, kThreadsB);  // V is read: it takes the v rows
        stage_demod<bf::SharedTables>(gw, kWarpsB, geo, s, D, L.pd, ts,
                                      [&](int row, int, int j, float v) {
                                        V[row * L.pv + L.cv + j - s.lo[4]] = v;
                                      });
        if (bulk_out) ap::fence_async();
        ap::group_sync(2, kThreadsB);
        store_rows(t, kThreadsB, bulk_out, V + L.cv, L.pv,
                   v_out + static_cast<long long>(line0) * n, rows, n);
      }
      if (bulk_out && t == 0) ap::bulk_wait();
    }
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
  const int taps[5] = {nt_band, nt_mix, nt_diff, nt_de, nt_dm};
  Geom geo = line_geom(n, margin, taps);
  const Tables tb{reinterpret_cast<const float2*>(t_bell), reinterpret_cast<const float2*>(t_notch),
                  reinterpret_cast<const float2*>(t_mix), reinterpret_cast<const float2*>(t_diff),
                  reinterpret_cast<const float2*>(t_de), reinterpret_cast<const float2*>(t_dm)};

  // the pipelined kernel where the whole line's six planes fit a block
  const PipeLayout L = pipe_layout(geo);
  const size_t pipe_smem = sizeof(float) * static_cast<size_t>(L.total);
  if (pipe_smem <= bf::kSmemMax) {
    static size_t opted_pipe[bf::kMaxDevices] = {};
    int blocks = 0;
    const int total = (n_lines + kRows - 1) / kRows;
    cudaError_t err =
        bf::launch_blocks(secam_decode_pipe, pipe_smem, total, opted_pipe, blocks, 1);
    if (err != cudaSuccess) return err;
    const bool bulk_out = n % 4 == 0 && ap::aligned16(luma_out) && ap::aligned16(v_out);
    secam_decode_pipe<<<blocks, 32 * kPipeWarps, pipe_smem, stream>>>(
        comp, isr, margin_carrier, mixcos, mixsin, tb, luma_out, v_out, n_lines, luma_est, geo,
        L, bulk_out, fc, inv2pi, f0r, f0b, devr, devb);
    return cudaGetLastError();
  }

  // else the serial kernel: the whole line where its three planes fit a
  // block, else the widest of n / 2, n / 3, ... that fits
  size_t smem = 0;
  for (int parts = 1;; ++parts) {
    geo.span = (n + parts - 1) / parts;
    geo.n_spans = (n + geo.span - 1) / geo.span;
    geo.pitch = pitch_for(geo);
    smem = decode_smem(geo.pitch);
    if (smem <= bf::kSmemMax) break;
    if (geo.span == 1) return cudaErrorInvalidValue;
  }
  static size_t opted[bf::kMaxDevices] = {};
  int blocks = 0;
  const int total = (n_lines + kRows - 1) / kRows * geo.n_spans;
  const cudaError_t err = bf::launch_blocks(secam_decode_kernel, smem, total, opted, blocks, 1);
  if (err != cudaSuccess) return err;
  secam_decode_kernel<<<blocks, 32 * NW, smem, stream>>>(comp, isr, margin_carrier, mixcos, mixsin,
                                                        tb, luma_out, v_out, n_lines, luma_est,
                                                        geo, fc, inv2pi, f0r, f0b, devr, devb);
  return cudaGetLastError();
}

// The pipelined decoder's shared-memory layout for a line of n samples (the
// taps as secam_decode takes them), in floats: out[0..5] the row pitches of
// the ext, takeoff, i/q, v and v (*) deemph planes and of the luma rows,
// out[6..12] their offsets (e, t, i, q, v, d, ls), out[13] v's staging
// column, out[14] the total.  secam_decode runs the pipelined kernel where
// 4 * out[14] <= 227 KB.  Launches nothing: the card tests hold the CPU
// tests' model of the layout (tests/test_torch_secam_tiles.py) to it.
extern "C" int secam_decode_pipe_layout(int n, int margin, int nt_band, int nt_mix, int nt_diff,
                                        int nt_de, int nt_dm, int* out) {
  if (n <= 0 || margin < 0) return cudaErrorInvalidValue;
  const int taps[5] = {nt_band, nt_mix, nt_diff, nt_de, nt_dm};
  const PipeLayout L = pipe_layout(line_geom(n, margin, taps));
  const int v[15] = {L.pe, L.pt, L.pi, L.pv, L.pd, L.ps, L.e,     L.t,
                     L.i,  L.q,  L.v,  L.d,  L.ls, L.cv, L.total};
  for (int k = 0; k < 15; ++k) out[k] = v[k];
  return cudaSuccess;
}
