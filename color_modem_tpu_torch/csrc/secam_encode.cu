// SECAM FM encode: composite = Y + anti-cloche(FM carrier), every FIR on the
// tensor cores (band_fir.cuh's fir16).
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
// the composed taps, which differs at the edges.  dphi reaches about +-250
// rad, so the cosine is IEEE cosf (no --use_fast_math).
//
// What bounds it on an H100: at 9216 lines x 720 samples the three FIRs are
// 129 + 257 + 193 = 579 taps, 7.68 GFLOP, against 79.6 MB of device memory
// (Y and the line's own chroma plane read, one plane written): 0.0466 ms at
// the 165 TFLOP/s of TF32 in three passes, 0.0238 ms at 3.35 TB/s.  The
// operations bound it; at the fp32 SIMT peak the FIRs alone take 0.115 ms.
//
// The products: one tile = 8 whole lines, the lines the N = 8 columns of
// mma.m16n8k8 and 16 outputs its rows (band_fir.cuh's fir16), three TF32
// passes, A read from the host-built tables of the reversed taps; 2592 +
// 4896 + 3744 = 11,232 mma.sync per tile at 720 samples.  A line is never
// split: the phase scan needs all of it.  The scan: warp w scans row w,
// each lane a contiguous chunk of ceil(N/32) increments, a shuffle scan of
// the chunk sums, then the chunk again from its exclusive prefix.
//
// Two schedules of the same stages:
//
// The pipelined kernel (lines whose planes fit one block: 720 and 722
// samples), one persistent block of 16 warps per SM, so that 16x576x720
// (1152 tiles) gives the busiest SM 9 tiles, the ceiling of the mean 8.73
// (two blocks per SM gave one SM 10).  The FIR warps never wait for the
// scan and the row tasks, which run on their own warps:
//   warps 0-3   stage tile t + 1: they copy the 8 D'R/D'B rows (each
//               line's own plane) by cp.async into the middle of the d
//               plane and write its held edges from the rows' end samples
//               in device memory; Y by cp.async into the output staging
//               rows; the phase scan and cosf of tile t, in place in its
//               df plane;
//   warps 4-15  comp_lpf and preemph of tile t + 1 and the anti-cloche of
//               tile t (out = y + FIR written over the staged Y, then bulk
//               stores), with dl's held halo between the first two.
// Planes of 8 rows, each as wide as its reader needs: d, dl, two
// df/carrier planes (the zero halo written once per launch) and Y, the
// ramp and the three tap tables: 151 KB at 720 samples.  Handoffs by
// mbarriers (async_pipe.cuh): d full/empty, Y full/empty, df full and
// carrier ready per df plane; a named barrier orders the FIR warps' own
// stages.  The output leaves by bulk stores (cp.async.bulk) where rows are
// 16-byte aligned, by plain stores from the same staging rows where not
// (722 samples): plain stores (and Y by cp.async) cost 5% at 720, bulk
// loads of d in place of cp.async gained nothing
// (scripts/torch_secam_variants.py), so the loads stay cp.async.
//
// The serial kernel (wider lines: 1440 needs 294 KB pipelined): two planes
// of 8 rows (d, then df; dl, then the carrier), all warps on each FIR
// stage between block-wide barriers, the row tasks on warps 0-7, one row
// each, the next tile's rows copied by cp.async during the last stage.
// Above 2514 samples its planes do not fit a block and the launch raises.
// A thread-block cluster schedule (each CTA the pipelined kernel on a
// slice of the line, the phase totals chained from slice to slice) was
// built and measured: 0.12 ms in place of 0.15 at 1x576x2160, +2.5% at
// 16x576x1440 (PERF.md section 6); no workload sends 2160-sample lines,
// so it is not kept.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (scripts/torch_kernel_ab.py,
// median of 10 windows of 20 launches; PERF.md section 6): the pipelined
// kernel 0.1806-0.1834 ms at 16x576x720, 25.4-25.8% of the bound, against
// 0.2053-0.2066 ms for the serial schedule there with two blocks of 8
// warps per SM (-12%); the serial kernel 0.21 ms at 4x576x1440,
// 0.6193-0.6211 ms at 16x576x1440 (30.1-30.2% of the bound) and 0.15 ms at
// 1x576x2160.  Each FIR warp starts one product per about 30 cycles
// (three to an SM sub-partition: one per 10 cycles, against about 6.4 at
// mma.sync's measured ceiling); the tap tables in shared memory took about
// 4% off the first pipelined version.  The scan, on its own warps, is
// hidden (0.1756 ms without it; scripts/torch_secam_variants.py).
// nvcc -Xptxas -v, sm_90a: pipelined 98 registers, serial 126, no spills,
// a 32-byte stack frame (cosf's slow path).

#include "async_pipe.cuh"
#include "band_fir.cuh"
#include "fir.cuh"

namespace {

constexpr int kRows = 8;  // lines per tile: the N of mma.m16n8k8
constexpr int kW = 4, kS = 8;  // output tiles per warp group, steps per block

__host__ __device__ inline int tiles16(int n) { return (n + 15) / 16; }

// Floats per plane row of the serial kernel: the widest of the three FIRs'
// inputs, and N.
inline int encode_pitch(int n, int nt_lpf, int nt_pre, int nt_anti) {
  const int taps[3] = {nt_lpf, nt_pre, nt_anti};
  int cols = n;
  for (int k = 0; k < 3; ++k) {
    const int c = bf::plane16_cols(tiles16(n), kW, bf::n_steps16(taps[k]));
    cols = c > cols ? c : cols;
  }
  return bf::pitch_of(bf::round_up(cols, 8) / 8);
}

// One FIR over the plane `in` (column 0 = sample -h of the line) by warps
// gw, gw + G, ... of a group of G: out(row, e, j, value) for j < n; Tab:
// where the table lies.
template <class Tab, class Out>
__device__ inline void stage_fir(int gw, int G, int n, const float* in, int pitch,
                                 const float2* table, int steps, Out out) {
  const float2* const at[1] = {table};
  const bf::PlaneB ldb(in, pitch);
  const int nt = tiles16(n);
  for (int gi = gw; gi * kW < nt; gi += G) {
    const int t0 = gi * kW;
    float acc[1][kW][4];
    bf::fir16<kW, kS, 1, 1, Tab>(t0, at, steps, ldb, acc);
#pragma unroll
    for (int w = 0; w < kW; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * (t0 + w) + bf::acc16_out(e);
        if (j < n) out(bf::acc16_row(e), e, j, acc[0][w][e]);
      }
  }
}

// The phase scan and the carrier of one row by one warp: c[k] =
// cosf(ramp[k] + sum(df[0..k]) - df[k] / 2); c may be df (in place).
__device__ inline void scan_row(const float* df, float* c, const float* ramp, int n) {
  const int lane = threadIdx.x & 31;
  const int chunk = (n + 31) / 32;
  const int b = min(lane * chunk, n), e = min(b + chunk, n);
  float s = 0.0f;
  for (int k = b; k < e; ++k) s += df[k];
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float run = incl - s;
#pragma unroll 4
  for (int k = b; k < e; ++k) {
    const float v = df[k];
    run += v;
    c[k] = cosf(ramp[k] + (run - 0.5f * v));
  }
}

// Columns [0, a) := left and [b, w) := right of one row, by one warp.
__device__ inline void fill_edges(float* row, int a, float left, int b, int w, float right) {
  const int lane = threadIdx.x & 31;
  for (int col = lane; col < a; col += 32) row[col] = left;
  for (int col = b + lane; col < w; col += 32) row[col] = right;
}

// --- the serial kernel -----------------------------------------------------

// One block of 16 warps per SM; the row tasks (staging, held edges, the
// scan) take warps 0-7, one row each, and the FIRs all of them.
constexpr int NW = 16;
__global__ void __launch_bounds__(32 * NW, 1)
secam_encode_kernel(const float* __restrict__ ycc, const float* __restrict__ isr_col,
                    const float* __restrict__ ramp, const float2* __restrict__ t_lpf,
                    const float2* __restrict__ t_pre, const float2* __restrict__ t_anti,
                    float* __restrict__ out, int n_lines, int lines_per_group, int n,
                    int nt_lpf, int nt_pre, int nt_anti, int pitch, float f0r_c,
                    float f0b_c, float devr_c, float devb_c) {
  extern __shared__ float4 smem4[];
#ifdef CMT_POISON
  bf::poison_shared(smem4, bf::dynamic_smem_bytes());
  __syncthreads();
#endif
  float* p0 = reinterpret_cast<float*>(smem4);  // d (held), then df
  float* p1 = p0 + kRows * pitch;               // dl (held), then the carrier
  float* ramp_s = p1 + kRows * pitch;           // the carrier ramp
  const int h_lpf = (nt_lpf - 1) / 2, h_pre = (nt_pre - 1) / 2;
  const int h_anti = (nt_anti - 1) / 2;
  const int s_lpf = bf::n_steps16(nt_lpf), s_pre = bf::n_steps16(nt_pre);
  const int s_anti = bf::n_steps16(nt_anti);
  const int nt = tiles16(n);
  const int w_lpf = bf::plane16_cols(nt, kW, s_lpf);
  const int w_pre = bf::plane16_cols(nt, kW, s_pre);
  const int w_anti = bf::plane16_cols(nt, kW, s_anti);
  const int warp = threadIdx.x >> 5;
  const int q = threadIdx.x & 3;
  const int total = (n_lines + kRows - 1) / kRows;

  // warp w copies row w of a tile, its line's own chroma plane, into the
  // middle of plane 0 (origin -h_lpf); the held edges come after it lands
  auto stage = [&](int tile) {
    const int line = tile * kRows + warp;
    const bool ok = warp < kRows && line < n_lines;
    const int plane = ok && isr_col[line] != 0.0f ? 1 : 2;
    if (warp < kRows)
      bf::warp_copy_row(p0 + warp * pitch + h_lpf,
                        ycc + (ok ? cm::plane_row(line, plane, lines_per_group, n) : 0), n, ok);
    bf::cp_async_commit();
  };
  if (static_cast<int>(blockIdx.x) < total) stage(blockIdx.x);
  for (int k = threadIdx.x; k < n; k += blockDim.x) ramp_s[k] = ramp[k];

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int line0 = tile * kRows;
    // the lane's two lines (accumulator rows 2q and 2q + 1)
    bool live[2];
    float f0c[2], devc[2];
    const float* y_row[2];
    float* o_row[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int line = line0 + 2 * q + k;
      live[k] = line < n_lines;
      const bool r = live[k] && isr_col[line] != 0.0f;
      f0c[k] = r ? f0r_c : f0b_c;
      devc[k] = r ? devr_c : devb_c;
      y_row[k] = ycc + (live[k] ? cm::plane_row(line, 0, lines_per_group, n) : 0);
      o_row[k] = out + static_cast<long long>(live[k] ? line : 0) * n;
    }

    // stage 1: the warp's row has landed; its held edges
    bf::cp_async_wait<0>();
    __syncwarp();
    if (warp < kRows) {
      float* row = p0 + warp * pitch;
      fill_edges(row, h_lpf, row[h_lpf], h_lpf + n, w_lpf, row[h_lpf + n - 1]);
    }
    __syncthreads();

    // stage 2: dl -> plane 1 (origin -h_pre)
    stage_fir<bf::GlobalTables>(warp, NW, n, p0, pitch, t_lpf, s_lpf,
                                [&](int row, int, int j, float v) {
                                  p1[row * pitch + j + h_pre] = v;
                                });
    __syncthreads();
    // the held halo of dl, from its own edge samples (warp w: row w)
    if (warp < kRows) {
      float* row = p1 + warp * pitch;
      fill_edges(row, h_pre, row[h_pre], h_pre + n, w_pre, row[h_pre + n - 1]);
    }
    __syncthreads();

    // stage 3: dpre -> df in plane 0 (a plain row, column j)
    stage_fir<bf::GlobalTables>(warp, NW, n, p1, pitch, t_pre, s_pre,
                                [&](int row, int e, int j, float v) {
                                  p0[row * pitch + j] = f0c[e & 1] + devc[e & 1] * v;
                                });
    __syncthreads();

    // stage 4: the phase scan and the carrier -> plane 1 (origin -h_anti),
    // warp w on row w, with the row's other columns zeroed
    if (warp < kRows) {
      float* row = p1 + warp * pitch;
      fill_edges(row, h_anti, 0.0f, h_anti + n, w_anti, 0.0f);
      scan_row(p0 + warp * pitch, row + h_anti, ramp_s, n);
    }
    __syncthreads();
    // plane 0 is read: the next tile's rows land in it during stage 5
    if (tile + static_cast<int>(gridDim.x) < total) stage(tile + gridDim.x);

    // stage 5: out = y + carrier (*) anticloche -> device memory, y loaded
    // before the products
    {
      const float2* const at[1] = {t_anti};
      const bf::PlaneB ldb(p1, pitch);
      for (int gi = warp; gi * kW < nt; gi += NW) {
        const int t0 = gi * kW;
        float y[kW][4];
#pragma unroll
        for (int w = 0; w < kW; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * (t0 + w) + bf::acc16_out(e);
            y[w][e] = j < n && live[e & 1] ? y_row[e & 1][j] : 0.0f;
          }
        float acc[1][kW][4];
        bf::fir16<kW, kS, 1, 1>(t0, at, s_anti, ldb, acc);
#pragma unroll
        for (int w = 0; w < kW; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * (t0 + w) + bf::acc16_out(e);
            if (j < n && live[e & 1]) o_row[e & 1][j] = y[w][e] + acc[0][w][e];
          }
      }
    }
    __syncthreads();  // plane 1 is rewritten by the next tile
  }
}

// --- the pipelined kernel --------------------------------------------------

constexpr int kRowWarps = 4, kFirWarps = 12;
constexpr int kPipeWarps = kRowWarps + kFirWarps;
constexpr int kRowThreads = 32 * kRowWarps, kFirThreads = 32 * kFirWarps;
enum { kDFull, kDEmpty, kYFull, kYEmpty, kFFull, kCReady = kFFull + 2, kBars = kCReady + 2 };

// The pipelined kernel's shared memory, in floats: the d, dl and two
// df/carrier planes of 8 rows, each as wide as its reader reads and its
// writer writes, the Y staging rows, the carrier ramp and the three tap
// tables.
struct EncLayout {
  int h_lpf, h_pre, h_anti, s_lpf, s_pre, s_anti, w_lpf, w_pre, w_anti;
  int pd, pl, pf, py;
  int d, l, f, y, ramp, t_lpf, t_pre, t_anti, total;  // offsets; df plane s at f + s * 8 * pf
};

// Floats of a band table of `steps` 16x8 steps (kernels/tiles.py::band_tiles16).
__host__ __device__ inline int table_len(int steps) { return 2 * (8 * steps + 24); }

inline EncLayout enc_layout(int n, int nt_lpf, int nt_pre, int nt_anti) {
  auto wider = [](int a, int b) { return a > b ? a : b; };
  EncLayout L{};
  L.h_lpf = (nt_lpf - 1) / 2;
  L.h_pre = (nt_pre - 1) / 2;
  L.h_anti = (nt_anti - 1) / 2;
  L.s_lpf = bf::n_steps16(nt_lpf);
  L.s_pre = bf::n_steps16(nt_pre);
  L.s_anti = bf::n_steps16(nt_anti);
  L.w_lpf = bf::plane16_cols(tiles16(n), kW, L.s_lpf);
  L.w_pre = bf::plane16_cols(tiles16(n), kW, L.s_pre);
  L.w_anti = bf::plane16_cols(tiles16(n), kW, L.s_anti);
  L.pd = ap::pitch8(wider(L.w_lpf, L.h_lpf + n));
  L.pl = ap::pitch8(wider(L.w_pre, L.h_pre + n));
  L.pf = ap::pitch8(wider(L.w_anti, L.h_anti + n));
  L.py = bf::round_up(n, 4);
  L.d = 0;
  L.l = L.d + kRows * L.pd;
  L.f = L.l + kRows * L.pl;
  L.y = L.f + 2 * kRows * L.pf;
  L.ramp = L.y + kRows * L.py;
  L.t_lpf = L.ramp + bf::round_up(n, 4);
  L.t_pre = L.t_lpf + table_len(L.s_lpf);
  L.t_anti = L.t_pre + table_len(L.s_pre);
  L.total = L.t_anti + table_len(L.s_anti);
  return L;
}

__global__ void __launch_bounds__(32 * kPipeWarps, 1)
secam_encode_pipe(const float* __restrict__ ycc, const float* __restrict__ isr_col,
                  const float* __restrict__ ramp, const float2* __restrict__ t_lpf,
                  const float2* __restrict__ t_pre, const float2* __restrict__ t_anti,
                  float* __restrict__ out, int n_lines, int lines_per_group, int n, EncLayout L,
                  int bulk_out, float f0r_c, float f0b_c, float devr_c,
                  float devb_c) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[kBars];
#ifdef CMT_POISON
  bf::poison_shared(smem4, bf::dynamic_smem_bytes());
  __syncthreads();
#endif
  float* sm = reinterpret_cast<float*>(smem4);
  float *Dp = sm + L.d, *Lp = sm + L.l, *Yp = sm + L.y, *ramp_s = sm + L.ramp;
  const float2 *tl = reinterpret_cast<const float2*>(sm + L.t_lpf),
               *tp = reinterpret_cast<const float2*>(sm + L.t_pre),
               *ta = reinterpret_cast<const float2*>(sm + L.t_anti);
  const int total = (n_lines + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's tiles: blockIdx.x + k * gridDim.x, k < n_mine
  const int n_mine = static_cast<int>(blockIdx.x) < total
                         ? (total - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                         : 0;
  auto line0_of = [&](int k) { return (static_cast<int>(blockIdx.x) + k * gridDim.x) * kRows; };
  auto rows_of = [&](int k) { return min(kRows, n_lines - line0_of(k)); };
  auto df_plane = [&](int k) { return sm + L.f + (k & 1) * kRows * L.pf; };

  // the carrier's zero halo in every df plane, once; the ramp
  for (int i = threadIdx.x; i < 2 * kRows * L.pf; i += blockDim.x) {
    const int c = i % L.pf;
    if (c < L.h_anti || c >= L.h_anti + n) sm[L.f + i] = 0.0f;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) ramp_s[k] = ramp[k];
  // the tap tables, read by every tile
  const float2* const tg[3] = {t_lpf, t_pre, t_anti};
  const int toff[3] = {L.t_lpf, L.t_pre, L.t_anti};
  const int tlen[3] = {table_len(L.s_lpf), table_len(L.s_pre), table_len(L.s_anti)};
  for (int k = 0; k < 3; ++k)
    for (int i = threadIdx.x; i < tlen[k]; i += blockDim.x)
      sm[toff[k] + i] = reinterpret_cast<const float*>(tg[k])[i];
  if (threadIdx.x == 0) {
    ap::init(&bars[kDFull], kRowThreads);
    ap::init(&bars[kDEmpty], kFirThreads);
    ap::init(&bars[kYFull], kRowThreads);
    ap::init(&bars[kYEmpty], 1);
    for (int s = 0; s < 2; ++s) {
      ap::init(&bars[kFFull + s], kFirThreads);
      ap::init(&bars[kCReady + s], kRowThreads);
    }
    ap::fence_init();
  }
  __syncthreads();

  if (warp < kRowWarps) {
    // d rows of tile k: cp.async into the middle of the d plane, held
    // edges from the rows' end samples
    auto stage_d = [&](int k) {
      const int line0 = line0_of(k), rows = rows_of(k);
      ap::wait(&bars[kDEmpty], (k & 1) ^ 1);
      auto src = [&](int r) {
        const int line = line0 + r;
        return ycc + cm::plane_row(line, isr_col[line] != 0.0f ? 1 : 2, lines_per_group, n);
      };
      for (int r = warp; r < kRows; r += kRowWarps) {
        float* row = Dp + r * L.pd;
        if (r < rows) {
          const float* d = src(r);
          fill_edges(row, L.h_lpf, __ldg(d), L.h_lpf + n, L.w_lpf, __ldg(d + n - 1));
          bf::warp_copy_row(row + L.h_lpf, d, n, true);
        } else {
          fill_edges(row, L.w_lpf, 0.0f, L.w_lpf, L.w_lpf, 0.0f);
        }
      }
      bf::cp_async_commit();
      bf::cp_async_wait<0>();
      ap::arrive(&bars[kDFull]);
    };
    // Y rows of tile k into the staging rows
    auto stage_y = [&](int k) {
      const int line0 = line0_of(k), rows = rows_of(k);
      ap::wait(&bars[kYEmpty], (k & 1) ^ 1);
      for (int r = warp; r < rows; r += kRowWarps)
        bf::warp_copy_row(Yp + r * L.py, ycc + cm::plane_row(line0 + r, 0, lines_per_group, n), n,
                          true);
      bf::cp_async_commit();
      bf::cp_async_wait<0>();
      ap::arrive(&bars[kYFull]);
    };
    // the phase scan and the carrier of tile k, in place
    auto scan = [&](int k) {
      float* f = df_plane(k);
      ap::wait(&bars[kFFull + (k & 1)], (k >> 1) & 1);
      for (int r = warp; r < kRows; r += kRowWarps) {
        float* c = f + r * L.pf + L.h_anti;
        scan_row(c, c, ramp_s, n);
      }
      ap::arrive(&bars[kCReady + (k & 1)]);
    };
    // in the order the FIR warps free what each task waits for
    if (n_mine > 0) stage_d(0);
    for (int k = 0; k < n_mine; ++k) {
      if (k + 1 < n_mine) stage_d(k + 1);
      scan(k);
      stage_y(k);
    }
  } else {
    const int gw = warp - kRowWarps, t = threadIdx.x - kRowThreads;
    const int q = lane & 3;
    // dl of tile k (and its held halo)
    auto lpf = [&](int k) {
      ap::group_sync(1, kFirThreads);  // dl is rewritten
      ap::wait(&bars[kDFull], k & 1);
      stage_fir<bf::SharedTables>(gw, kFirWarps, n, Dp, L.pd, tl, L.s_lpf,
                                  [&](int row, int, int j, float v) {
                                    Lp[row * L.pl + j + L.h_pre] = v;
                                  });
      ap::arrive(&bars[kDEmpty]);
      ap::group_sync(1, kFirThreads);
      for (int r = gw; r < kRows; r += kFirWarps) {
        float* row = Lp + r * L.pl;
        fill_edges(row, L.h_pre, row[L.h_pre], L.h_pre + n, L.w_pre, row[L.h_pre + n - 1]);
      }
      ap::group_sync(1, kFirThreads);
    };
    // df of tile k into its df plane
    auto pre = [&](int k) {
      const int line0 = line0_of(k), rows = rows_of(k);
      float f0c[2], devc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool red = 2 * q + r < rows && isr_col[line0 + 2 * q + r] != 0.0f;
        f0c[r] = red ? f0r_c : f0b_c;
        devc[r] = red ? devr_c : devb_c;
      }
      float* f = df_plane(k) + L.h_anti;
      stage_fir<bf::SharedTables>(gw, kFirWarps, n, Lp, L.pl, tp, L.s_pre,
                                  [&](int row, int e, int j, float v) {
                                    f[row * L.pf + j] = f0c[e & 1] + devc[e & 1] * v;
                                  });
      ap::arrive(&bars[kFFull + (k & 1)]);
    };
    // out = y + carrier (*) anticloche of tile k, over the staged Y, then out
    auto anti = [&](int k) {
      const int line0 = line0_of(k), rows = rows_of(k);
      ap::wait(&bars[kCReady + (k & 1)], (k >> 1) & 1);
      ap::wait(&bars[kYFull], k & 1);
      stage_fir<bf::SharedTables>(gw, kFirWarps, n, df_plane(k), L.pf, ta, L.s_anti,
                                  [&](int row, int, int j, float v) {
                                    float* y = Yp + row * L.py + j;
                                    *y = *y + v;
                                  });
      if (bulk_out) ap::fence_async();
      ap::group_sync(1, kFirThreads);
      float* dst = out + static_cast<long long>(line0) * n;
      if (bulk_out) {
        if (t == 0) {
          for (int r = 0; r < rows; ++r)
            ap::bulk_store(dst + static_cast<long long>(r) * n, Yp + r * L.py, 4 * n);
          ap::bulk_commit();
          ap::bulk_wait_read();
          ap::arrive(&bars[kYEmpty]);
        }
      } else {
        for (int i = t; i < rows * n; i += kFirThreads) dst[i] = Yp[i / n * L.py + i % n];
        ap::group_sync(1, kFirThreads);
        if (t == 0) ap::arrive(&bars[kYEmpty]);
      }
    };
    // comp_lpf and preemph of tile k, then the anti-cloche of tile k - 1
    // (one call site each: a smaller kernel)
    for (int k = 0; k <= n_mine; ++k) {
      if (k < n_mine) {
        lpf(k);
        pre(k);
      }
      if (k > 0) anti(k - 1);
    }
    if (bulk_out && t == 0) ap::bulk_wait();
  }
}

}  // namespace

// ycc: (G, 3, L, N) with G*L = n_lines; isr: (n_lines,) 1.0 on D'R lines,
// 0.0 on D'B lines; ramp: (N,) carrier phase base; t_lpf, t_pre, t_anti:
// (8S + 24, 2) band tables (kernels/tiles.py::band_tiles16) of comp_lpf,
// preemph, anticloche (nt_* taps); out: (n_lines, N).  f0r_c, f0b_c:
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
  const float2 *tl = reinterpret_cast<const float2*>(t_lpf),
               *tp = reinterpret_cast<const float2*>(t_pre),
               *ta = reinterpret_cast<const float2*>(t_anti);
  const int total = (n_lines + kRows - 1) / kRows;

  // the pipelined kernel where its planes fit a block
  const EncLayout L = enc_layout(n, nt_lpf, nt_pre, nt_anti);
  const size_t pipe_smem = sizeof(float) * static_cast<size_t>(L.total);
  if (pipe_smem <= bf::kSmemMax) {
    static size_t opted_pipe[bf::kMaxDevices] = {};
    int blocks = 0;
    const cudaError_t err =
        bf::launch_blocks(secam_encode_pipe, pipe_smem, total, opted_pipe, blocks, 1);
    if (err != cudaSuccess) return err;
    const bool bulk_out = n % 4 == 0 && ap::aligned16(out);
    secam_encode_pipe<<<blocks, 32 * kPipeWarps, pipe_smem, stream>>>(
        ycc, isr, ramp, tl, tp, ta, out, n_lines, lines_per_group, n, L, bulk_out, f0r_c,
        f0b_c, devr_c, devb_c);
    return cudaGetLastError();
  }

  // else the serial kernel
  const int pitch = encode_pitch(n, nt_lpf, nt_pre, nt_anti);
  const size_t smem =
      sizeof(float) * (2 * kRows * static_cast<size_t>(pitch) + bf::round_up(n, 4));
  if (smem > bf::kSmemMax) return cudaErrorInvalidValue;  // above about 2500 samples
  static size_t opted[bf::kMaxDevices] = {};
  int blocks = 0;
  const cudaError_t err = bf::launch_blocks(secam_encode_kernel, smem, total, opted, blocks, 1);
  if (err != cudaSuccess) return err;
  secam_encode_kernel<<<blocks, 32 * NW, smem, stream>>>(ycc, isr, ramp, tl, tp, ta, out, n_lines,
                                                        lines_per_group, n, nt_lpf, nt_pre,
                                                        nt_anti, pitch, f0r_c, f0b_c, devr_c,
                                                        devb_c);
  return cudaGetLastError();
}

// The pipelined encoder's shared-memory layout for a line of n samples, in
// floats: out[0..3] the row pitches of the d, dl and df/carrier planes and
// of the Y rows, out[4] the total.  secam_encode runs the pipelined kernel
// where 4 * out[4] <= 227 KB.  Launches nothing: the card tests hold the
// CPU tests' model of the layout (tests/test_torch_secam_tiles.py) to it.
extern "C" int secam_encode_pipe_layout(int n, int nt_lpf, int nt_pre, int nt_anti, int* out) {
  if (n <= 0) return cudaErrorInvalidValue;
  const EncLayout L = enc_layout(n, nt_lpf, nt_pre, nt_anti);
  const int v[5] = {L.pd, L.pl, L.pf, L.py, L.total};
  for (int k = 0; k < 5; ++k) out[k] = v[k];
  return cudaSuccess;
}
