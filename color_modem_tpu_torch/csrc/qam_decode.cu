// QAM decode: band-split and product detector, with every FIR on the tensor
// cores (band_fir.cuh).
//
// Replaces the Pallas kernels color_modem_tpu/kernels/qam.py::_decode_kernel
// and _decode_kernel_shared (the same function with c1_lpf == c2_lpf).
//
// Per line: cb = sep (*) chroma_bpf; y = comp - cb; c1 = (2*cb*sin) (*) c1_lpf;
// c2 = vs * ((2*cb*cos) (*) c2_lpf).  `sep` is the comb stencil signal (the
// composite itself for the notch decoder), computed outside the kernel.
//
// What bounds it on an H100: at 7680 lines x 720 samples x 129 taps one call
// reads two planes and writes three, 110.6 MB, 0.0330 ms at 3.35 TB/s; its
// three FIRs are 4.28 GFLOP, 0.0259 ms at 165 TFLOP/s (the 495 TFLOP/s of
// TF32 over three passes).  The bytes bound it.
//
// Design: a block takes 16 lines x one span of the line (the whole line
// where two blocks' shared memory fits in an SM, else equal spans: 2 x 360
// samples at 720 with 129 taps).  It stages sep for the span with both
// halos (cp.async), runs the band FIR over the span plus the low-passes'
// halo, and mixes in the accumulator registers: y goes to device memory,
// 2*cb*sin and 2*cb*cos to two shared planes with ZERO halos (the
// low-pass's 'same' convolution treats samples outside the line as zero; a
// FIR reading past the row in flat memory would pick up the next line).
// Then both low-passes read those planes, while the next tile's sep loads
// into the plane the band has finished with (persistent blocks, two per
// SM).  Band tiles wholly outside the line are skipped.
//
// nvcc -Xptxas -v, sm_90a (scripts/torch_ptxas_stats.py): 110 registers, no
// spills, a 32-byte stack frame (sincosf's slow path); 107,264 bytes of
// dynamic shared memory at 720 samples and 129 taps.

#include "band_fir.cuh"
#include "fir.cuh"

namespace {

__host__ __device__ inline int sep_chunks(int tiles, int steps) {
  return bf::plane_chunks(tiles + steps - 1, steps);
}

// the arms are written by the band's groups and read by the low-passes
__host__ __device__ inline int arm_chunks(int tiles, int steps) {
  const int read = bf::plane_chunks(tiles, steps);
  const int written = bf::round_up(tiles + steps - 1, bf::kW);
  return read > written ? read : written;
}

__host__ __device__ inline size_t decode_smem(int span, int ntaps) {
  const int tiles = span / 8, steps = bf::n_steps(ntaps);
  return sizeof(float) * bf::kRows *
         (bf::pitch_of(sep_chunks(tiles, steps)) +
          2 * static_cast<size_t>(bf::pitch_of(arm_chunks(tiles, steps))));
}

__global__ void __launch_bounds__(bf::kThreads, bf::kBlocksPerSm)
qam_decode_kernel(const float* __restrict__ sep, const float* __restrict__ comp,
                  const float* __restrict__ cols, const float* __restrict__ rc,
                  const float* __restrict__ rs, const float4* __restrict__ tb,
                  const float4* __restrict__ t1, const float4* __restrict__ t2,
                  float* __restrict__ out, int n_lines, int lines_per_group, int n,
                  int ntaps, int span, int vec) {
  extern __shared__ float4 smem4[];
#ifdef CMT_POISON
  bf::poison_shared(smem4, bf::dynamic_smem_bytes());
  __syncthreads();
#endif
  const int steps = bf::n_steps(ntaps), half = (ntaps - 1) / 2;
  const int pitch_s = bf::pitch_of(sep_chunks(span / 8, steps));
  const int pitch_m = bf::pitch_of(arm_chunks(span / 8, steps));
  float* xs = reinterpret_cast<float*>(smem4);  // sep with both halos
  float* ms = xs + bf::kRows * pitch_s;         // 2*cb*sin, zero halo
  float* mc = ms + bf::kRows * pitch_m;         // 2*cb*cos, zero halo
  const bf::TileGrid grid(n_lines, n, span);
  auto load = [&](int tile) {
    int line0, p0;
    grid.at(tile, span, line0, p0);
    bf::stage(xs, pitch_s, p0 - 2 * half,
              [=](int line) { return sep + (long long)line * n; }, line0, n_lines, n, vec);
  };
  if ((int)blockIdx.x < grid.total) load(blockIdx.x);
  bf::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  for (int tile = blockIdx.x; tile < grid.total; tile += gridDim.x) {
    int line0, p0;
    grid.at(tile, span, line0, p0);
    const int end = min(p0 + span, n);
    const int nt = (end - p0 + 7) / 8;  // output tiles
    const int ut = nt + steps - 1;      // band tiles: the low-passes' inputs
    const int o_m = p0 - half;          // line position of the arms' column 0
    const int written = 8 * bf::round_up(ut, bf::kW), rest = pitch_m - written;
    for (int i = threadIdx.x; i < bf::kRows * rest; i += blockDim.x) {
      const int k = (i / rest) * pitch_m + written + i % rest;
      ms[k] = 0.0f;
      mc[k] = 0.0f;
    }

    // the lane's two lines (accumulator rows g and g + 8) and their rows in
    // device memory, addressed once
    float s0[2], c0[2], vs[2];
    bool live[2];
    const float* comp_row[2];
    float *y_row[2], *c1_row[2], *c2_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int line = line0 + ((threadIdx.x & 31) >> 2) + 8 * h;
      live[h] = line < n_lines;
      s0[h] = c0[h] = vs[h] = 0.0f;
      comp_row[h] = comp;
      y_row[h] = c1_row[h] = c2_row[h] = out;
      if (live[h]) {
        sincosf(cols[line * 3 + 0], &s0[h], &c0[h]);
        vs[h] = cols[line * 3 + 1];
        comp_row[h] = comp + (long long)line * n;
        y_row[h] = out + cm::plane_row(line, 0, lines_per_group, n);
        c1_row[h] = out + cm::plane_row(line, 1, lines_per_group, n);
        c2_row[h] = out + cm::plane_row(line, 2, lines_per_group, n);
      }
    }
    bf::cp_async_wait<0>();
    __syncthreads();

    // band split and mix
    for (int gi = warp; gi * bf::kW < ut; gi += bf::kWarps) {
      const int u0 = gi * bf::kW;
      float acc[bf::kW][4];
      const int lo = o_m + 8 * u0, hi = lo + 8 * bf::kW;
      if (hi > 0 && lo < n) {
        bf::fir_group(xs, pitch_s, u0, tb, steps, acc);
      } else {
#pragma unroll
        for (int w = 0; w < bf::kW; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[w][e] = 0.0f;
      }
#pragma unroll
      for (int w = 0; w < bf::kW; ++w) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 8 * u0 + bf::acc_col(w, 0), pos = o_m + i;
          const float2 cp =
              live[h] ? bf::load2(comp_row[h], pos, p0, end) : make_float2(0.0f, 0.0f);
          float am[2], ac[2], y[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float cb = acc[w][2 * h + j];
            am[j] = ac[j] = 0.0f;
            y[j] = (j ? cp.y : cp.x) - cb;
            if (live[h] && pos + j >= 0 && pos + j < n) {
              float sn, cs;
              cm::carrier(s0[h], c0[h], rc, rs, pos + j, sn, cs);
              am[j] = 2.0f * cb * sn;
              ac[j] = 2.0f * cb * cs;
            }
          }
          if (live[h]) bf::store2(y_row[h], pos, p0, end, y[0], y[1]);
          const int k = bf::acc_row(2 * h) * pitch_m + i;
          *reinterpret_cast<float2*>(ms + k) = make_float2(am[0], am[1]);
          *reinterpret_cast<float2*>(mc + k) = make_float2(ac[0], ac[1]);
        }
      }
    }
    __syncthreads();
    // sep is read: load the next tile's while the low-passes run
    if (tile + gridDim.x < grid.total) load(tile + gridDim.x);
    bf::cp_async_commit();

    // the two low-passes, their groups interleaved
    const int ng = (nt + bf::kW - 1) / bf::kW;
    for (int gi = warp; gi < 2 * ng; gi += bf::kWarps) {
      const int arm = gi & 1, t0 = (gi >> 1) * bf::kW;
      float acc[bf::kW][4];
      bf::fir_group(arm ? mc : ms, pitch_m, t0, arm ? t2 : t1, steps, acc);
#pragma unroll
      for (int w = 0; w < bf::kW; ++w) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live[h]) continue;
          const int pos = p0 + 8 * t0 + bf::acc_col(w, 0);
          if (arm)
            bf::store2(c2_row[h], pos, p0, end, vs[h] * acc[w][2 * h],
                       vs[h] * acc[w][2 * h + 1]);
          else
            bf::store2(c1_row[h], pos, p0, end, acc[w][2 * h], acc[w][2 * h + 1]);
        }
      }
    }
    __syncthreads();  // the arms are rewritten by the next tile's band
  }
}

}  // namespace

// sep, comp: (n_lines, N); cols: (n_lines, 3); rc, rs: (N,); bpf_tiles,
// tiles1, tiles2: (S, 32, 4) band tiles of chroma_bpf, c1_lpf, c2_lpf (all
// of ntaps taps); out: (G, 3, L, N) [y, c1, c2] with G*L = n_lines.
extern "C" cudaError_t qam_decode(const float* sep, const float* comp,
                                  const float* cols, const float* rc,
                                  const float* rs, const float* bpf_tiles,
                                  const float* tiles1, const float* tiles2,
                                  float* out, int n_lines, int lines_per_group,
                                  int n, int ntaps, cudaStream_t stream) {
  if (n_lines <= 0) return cudaSuccess;
  if (lines_per_group <= 0 || n <= 0 || !cm::odd_taps(ntaps))
    return cudaErrorInvalidValue;
  size_t smem = 0;
  const int span = bf::choose_span(n, [=](int s) { return decode_smem(s, ntaps); }, smem);
  if (span == 0) return cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(sep) % 16 == 0;
  static size_t opted[bf::kMaxDevices] = {};
  int blocks = 0;
  const cudaError_t err =
      bf::launch_blocks(qam_decode_kernel, smem, bf::TileGrid(n_lines, n, span).total, opted, blocks);
  if (err != cudaSuccess) return err;
  qam_decode_kernel<<<blocks, bf::kThreads, smem, stream>>>(
      sep, comp, cols, rc, rs, reinterpret_cast<const float4*>(bpf_tiles),
      reinterpret_cast<const float4*>(tiles1), reinterpret_cast<const float4*>(tiles2),
      out, n_lines, lines_per_group, n, ntaps, span, vec);
  return cudaGetLastError();
}
