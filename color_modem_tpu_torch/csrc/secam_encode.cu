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
// Design: one tile = 8 whole lines, the lines the N = 8 columns of
// mma.m16n8k8 and 16 outputs its rows (band_fir.cuh's fir16), three TF32
// passes, A read from the host-built tables of the reversed taps.  Two
// planes of 8 rows (69 KB at 720 samples with the carrier ramp, two blocks
// of 8 warps per SM; 135 KB at 1440, one block of 16 warps):
//   plane 0: d, copied by cp.async during the previous tile's last stage
//            (warp w: row w, its own line's D'R or D'B plane: a tile mixes
//            them), its held edges filled once it lands;
//   plane 1: dl at the preemph origin; once every warp has written it, its
//            held halo is filled from its own edge samples;
//   plane 0: df (the per-row rest frequency and deviation in the epilogue);
//   plane 1: the carrier with a zero halo: warp w scans row w (each lane a
//            contiguous chunk of ceil(N/32) increments, a shuffle scan of the
//            chunk sums, then the chunk again from its exclusive prefix);
//   out = y + the anti-cloche FIR, y loaded before the products.
// A line is never split: the phase scan needs all of it.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): 0.20 ms at
// 16x576x720, 23% of the bound, against 0.27 ms for the fp32 SIMT kernel
// it replaces (-24%); 0.21 ms at 4x576x1440 against 0.24.  The products
// run near the mma.sync ceiling; the rest is latency between them.
// nvcc -Xptxas -v, sm_90a: 126 registers, no spills, a 32-byte stack
// frame (cosf's slow path).

#include "band_fir.cuh"
#include "fir.cuh"

namespace {

constexpr int kRows = 8;  // lines per tile: the N of mma.m16n8k8
constexpr int kW = 4, kS = 8;  // output tiles per warp group, steps per block

__host__ __device__ inline int tiles16(int n) { return (n + 15) / 16; }

// Floats per plane row: the widest of the three FIRs' inputs, and N.
inline int encode_pitch(int n, int nt_lpf, int nt_pre, int nt_anti) {
  const int taps[3] = {nt_lpf, nt_pre, nt_anti};
  int cols = n;
  for (int k = 0; k < 3; ++k) {
    const int c = bf::plane16_cols(tiles16(n), kW, bf::n_steps16(taps[k]));
    cols = c > cols ? c : cols;
  }
  return bf::pitch_of(bf::round_up(cols, 8) / 8);
}

// NW warps: 8 where two blocks fit an SM, else 16 (one block); the row
// tasks (staging, held edges, the scan) take warps 0-7, one row each, and
// the FIRs all of them.
template <int NW>
__global__ void __launch_bounds__(32 * NW, 16 / NW)
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
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
      const float left = row[h_lpf], right = row[h_lpf + n - 1];
      for (int col = lane; col < h_lpf; col += 32) row[col] = left;
      for (int col = h_lpf + n + lane; col < w_lpf; col += 32) row[col] = right;
    }
    __syncthreads();

    // stage 2: dl -> plane 1 (origin -h_pre)
    {
      const float2* const at[1] = {t_lpf};
      const bf::PlaneB ldb(p0, pitch);
      for (int gi = warp; gi * kW < nt; gi += NW) {
        const int t0 = gi * kW;
        float acc[1][kW][4];
        bf::fir16<kW, kS, 1, 1>(t0, at, s_lpf, ldb, acc);
#pragma unroll
        for (int w = 0; w < kW; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * (t0 + w) + bf::acc16_out(e);
            if (j < n) p1[bf::acc16_row(e) * pitch + j + h_pre] = acc[0][w][e];
          }
      }
    }
    __syncthreads();
    // the held halo of dl, from its own edge samples (warp w: row w)
    if (warp < kRows) {
      float* row = p1 + warp * pitch;
      const float left = row[h_pre], right = row[h_pre + n - 1];
      for (int col = lane; col < h_pre; col += 32) row[col] = left;
      for (int col = h_pre + n + lane; col < w_pre; col += 32) row[col] = right;
    }
    __syncthreads();

    // stage 3: dpre -> df in plane 0 (a plain row, column j)
    {
      const float2* const at[1] = {t_pre};
      const bf::PlaneB ldb(p1, pitch);
      for (int gi = warp; gi * kW < nt; gi += NW) {
        const int t0 = gi * kW;
        float acc[1][kW][4];
        bf::fir16<kW, kS, 1, 1>(t0, at, s_pre, ldb, acc);
#pragma unroll
        for (int w = 0; w < kW; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * (t0 + w) + bf::acc16_out(e);
            if (j < n)
              p0[bf::acc16_row(e) * pitch + j] = f0c[e & 1] + devc[e & 1] * acc[0][w][e];
          }
      }
    }
    __syncthreads();

    // stage 4: the phase scan and the carrier -> plane 1 (origin -h_anti),
    // warp w on row w, with the row's other columns zeroed
    if (warp < kRows) {
      const float* df = p0 + warp * pitch;
      float* row = p1 + warp * pitch;
      for (int col = lane; col < h_anti; col += 32) row[col] = 0.0f;
      for (int col = h_anti + n + lane; col < w_anti; col += 32) row[col] = 0.0f;
      float* c = row + h_anti;
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
        c[k] = cosf(ramp_s[k] + (run - 0.5f * v));
      }
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
  const int pitch = encode_pitch(n, nt_lpf, nt_pre, nt_anti);
  const size_t smem =
      sizeof(float) * (2 * kRows * static_cast<size_t>(pitch) + bf::round_up(n, 4));
  if (smem > bf::kSmemMax) return cudaErrorInvalidValue;  // above about 2500 samples
  auto launch = [&](auto kernel, int warps, size_t (&opted)[bf::kMaxDevices]) {
    int blocks = 0;
    const cudaError_t err = bf::launch_blocks(kernel, smem, (n_lines + kRows - 1) / kRows,
                                              opted, blocks, 16 / warps);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, 32 * warps, smem, stream>>>(
        ycc, isr, ramp, reinterpret_cast<const float2*>(t_lpf),
        reinterpret_cast<const float2*>(t_pre), reinterpret_cast<const float2*>(t_anti), out,
        n_lines, lines_per_group, n, nt_lpf, nt_pre, nt_anti, pitch, f0r_c, f0b_c, devr_c,
        devb_c);
    return cudaGetLastError();
  };
  static size_t opted8[bf::kMaxDevices] = {}, opted16[bf::kMaxDevices] = {};
  return smem <= bf::kSmemBudget ? launch(secam_encode_kernel<8>, 8, opted8)
                                 : launch(secam_encode_kernel<16>, 16, opted16);
}
