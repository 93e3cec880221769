// One zero-edged 'same' FIR per line through band_fir.cuh alone: the check
// of the tensor-core FIR (tap orientation on asymmetric taps, halos, spans,
// the ragged last tile of lines) against np.convolve, independent of any
// modem kernel.  It replaces no TPU kernel and no pipeline path launches it.

#include "band_fir.cuh"
#include "fir.cuh"

namespace {

// two stages of one plane: the tile being filtered and the next one
__host__ __device__ inline size_t check_smem(int span, int ntaps) {
  return sizeof(float) * bf::kRows * 2 *
         static_cast<size_t>(bf::pitch_of(bf::plane_chunks(span / 8, bf::n_steps(ntaps))));
}

__global__ void __launch_bounds__(bf::kThreads, bf::kBlocksPerSm)
band_fir_check_kernel(const float* __restrict__ x, const float4* __restrict__ tiles,
                      float* __restrict__ out, int n_lines, int n, int ntaps, int span,
                      int vec) {
  extern __shared__ float4 smem4[];
  const int steps = bf::n_steps(ntaps), half = (ntaps - 1) / 2;
  const int pitch = bf::pitch_of(bf::plane_chunks(span / 8, steps));
  auto stage_buf = [&](int k) {
    return reinterpret_cast<float*>(smem4) + (k & 1) * bf::kRows * pitch;
  };
  const bf::TileGrid grid(n_lines, n, span);
  auto load = [&](int tile, float* xs) {
    int line0, p0;
    grid.at(tile, span, line0, p0);
    bf::stage(xs, pitch, p0 - half,
              [=](int line) { return x + (long long)line * n; }, line0, n_lines, n, vec);
  };
  if ((int)blockIdx.x < grid.total) load(blockIdx.x, stage_buf(0));
  bf::cp_async_commit();
  for (int tile = blockIdx.x, k = 0; tile < grid.total; tile += gridDim.x, ++k) {
    if (tile + gridDim.x < grid.total) load(tile + gridDim.x, stage_buf(k + 1));
    bf::cp_async_commit();
    bf::cp_async_wait<1>();
    __syncthreads();
    int line0, p0;
    grid.at(tile, span, line0, p0);
    const int end = min(p0 + span, n), nt = (end - p0 + 7) / 8;
    for (int gi = threadIdx.x >> 5; gi * bf::kW < nt; gi += bf::kWarps) {
      const int t0 = gi * bf::kW;
      float acc[bf::kW][4];
      bf::fir_group(stage_buf(k), pitch, t0, tiles, steps, acc);
#pragma unroll
      for (int w = 0; w < bf::kW; ++w)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int line = line0 + bf::acc_row(2 * h);
          const int pos = p0 + 8 * t0 + bf::acc_col(w, 0);
          if (line < n_lines)
            bf::store2(out + (long long)line * n, pos, p0, end, acc[w][2 * h],
                       acc[w][2 * h + 1]);
        }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
}

}  // namespace

// x, out: (n_lines, N); tiles: (S, 32, 4) band tiles of ntaps taps.
extern "C" cudaError_t band_fir_check(const float* x, const float* tiles, float* out,
                                      int n_lines, int n, int ntaps,
                                      cudaStream_t stream) {
  if (n_lines <= 0) return cudaSuccess;
  if (n <= 0 || !cm::odd_taps(ntaps)) return cudaErrorInvalidValue;
  size_t smem = 0;
  const int span = bf::choose_span(n, [=](int s) { return check_smem(s, ntaps); }, smem);
  if (span == 0) return cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  static size_t opted[bf::kMaxDevices] = {};
  int blocks = 0;
  const cudaError_t err =
      bf::launch_blocks(band_fir_check_kernel, smem, bf::TileGrid(n_lines, n, span).total, opted, blocks);
  if (err != cudaSuccess) return err;
  band_fir_check_kernel<<<blocks, bf::kThreads, smem, stream>>>(
      x, reinterpret_cast<const float4*>(tiles), out, n_lines, n, ntaps, span, vec);
  return cudaGetLastError();
}
