// One 'same' FIR per line through fir.cuh alone: the check of the shared FIR
// (tap orientation on asymmetric taps, zero and held edges) against
// np.convolve, independent of any modem kernel.  It replaces no TPU kernel
// and no pipeline path launches it.

#include "fir.cuh"

namespace {

__global__ void __launch_bounds__(cm::kThreads)
fir_check_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int n, int ntaps, int held) {
  extern __shared__ float smem[];
  const int half = (ntaps - 1) / 2;
  const int len = cm::staged_len(n, half);
  float* xs = smem;
  float* tr = xs + len;
  const long long line = blockIdx.x;
  if (held) cm::stage_line_held(xs, x + line * n, n, half, len);
  else cm::stage_line(xs, x + line * n, n, half, len);
  cm::stage_taps(tr, taps, ntaps);
  __syncthreads();
  for (int q = threadIdx.x; q < cm::n_groups(n); q += blockDim.x) {
    const int j0 = q * cm::kOut;
    float acc[cm::kOut];
    cm::fir_window(xs, tr, ntaps, j0, acc);
#pragma unroll
    for (int r = 0; r < cm::kOut; ++r)
      if (j0 + r < n) out[line * n + j0 + r] = acc[r];
  }
}

}  // namespace

// x, out: (n_lines, N); taps: (ntaps,); held: 0 zero edge, 1 held edge.
extern "C" cudaError_t fir_check(const float* x, const float* taps, float* out,
                                 int n_lines, int n, int ntaps, int held,
                                 cudaStream_t stream) {
  if (n_lines <= 0) return cudaSuccess;
  if (n <= 0 || !cm::odd_taps(ntaps)) return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(cm::staged_len(n, (ntaps - 1) / 2)) + cm::round4(ntaps)) *
      sizeof(float);
  fir_check_kernel<<<n_lines, cm::kThreads, smem, stream>>>(x, taps, out, n, ntaps,
                                                            held);
  return cudaGetLastError();
}
