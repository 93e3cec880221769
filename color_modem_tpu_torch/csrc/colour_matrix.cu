// The round trip's colour matrices, one pass each: RGB -> (Y, C1, C2) before
// the encoder, (Y, C1, C2) -> RGB after the decoder with its clamp to [0, 1].
// A second kernel, delayline_matrix_kernel, is the decoder's pass of the
// delay-line decoders (PAL 'delayline', 'avg' on the other QAM standards): the
// same matrix and clamp, on C1 and C2 first averaged with the line before.
//
// Replaces no Pallas kernel.  The JAX package's dsp/colorimetry.py::apply_mat3
// is an einsum at Precision.HIGHEST, which XLA fuses with the clamp around it.
// The plain PyTorch version (dsp/colorimetry.py::apply_mat3) is a
// product that broadcasts one plane into three and two addcmul_ over strided
// single-plane slices, then a separate clamp: 18 planes of traffic per matrix
// and 6 more for the clamp.
//
//   out[g, d, p] = fma(x2, m[d][2], fma(x1, m[d][1], x0 * m[d][0])),
//   x_c = x[g, c, p], d = 0, 1, 2
//
// summed in the order c = 0, 1, 2 in float32 (no TF32, no tensor core: the
// JAX twin asks for full float32).  With `clamp` each output follows
// torch.clamp(v, 0, 1): a NaN stays a NaN, where fminf/fmaxf alone would drop
// it and hide it from the float checks (utils/debug.py::checked).  The matrix
// is read by pointer from the plan's (3, 3) float32 buffer: nothing goes back
// to the host.
//
// What bounds it on an H100: the bytes.  It reads three planes and writes
// three, 9 multiply-adds per 24 bytes of traffic; at 64 x 3 x 480 x 720 one
// pass moves 530.8 MB, 0.158 ms at 3.35 TB/s.
//
// Design: registers only, no shared memory.  Blocks of 256 threads, enough
// of them to fill 132 SMs eight deep; grid row y walks the groups, and each
// block walks its group's plane in a grid-stride loop.  Where the plane is a
// multiple of 4 samples and both pointers are 16-byte aligned, each thread
// loads a float4 of each of the three planes and stores a float4 of each
// output (kernels/colorimetry.py makes the input contiguous); otherwise it
// goes sample by sample.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks in flight across all groups: 8 blocks of 256 threads on each of 132 SMs
constexpr int kGridBlocks = 8 * 132;
constexpr int kMaxRows = 65535;  // gridDim.y

struct Mat3 {
  float m[9];
};

__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// one sample: the three outputs of (x0, x1, x2)
template <bool kClamp>
__device__ __forceinline__ void mix(const Mat3& m, float x0, float x1, float x2, float& y0,
                                    float& y1, float& y2) {
  y0 = fmaf(x2, m.m[2], fmaf(x1, m.m[1], __fmul_rn(x0, m.m[0])));
  y1 = fmaf(x2, m.m[5], fmaf(x1, m.m[4], __fmul_rn(x0, m.m[3])));
  y2 = fmaf(x2, m.m[8], fmaf(x1, m.m[7], __fmul_rn(x0, m.m[6])));
  if constexpr (kClamp) {
    y0 = clamp01(y0);
    y1 = clamp01(y1);
    y2 = clamp01(y2);
  }
}

// (a + b) / 2 as the plain composition rounds it: the sum to nearest, the
// halving exact; neither may merge into a multiply-add
__device__ __forceinline__ float half_sum(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// T is float4 (the vector path: `count` is the plane over 4) or float
template <typename T, bool kClamp>
__global__ void __launch_bounds__(kThreads)
colour_matrix_kernel(const T* __restrict__ x, const float* __restrict__ mat,
                     T* __restrict__ out, int groups, unsigned long long count) {
  Mat3 m;
#pragma unroll
  for (int i = 0; i < 9; ++i) m.m[i] = __ldg(mat + i);
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const T* x0 = x + 3ull * g * count;
    const T* x1 = x0 + count;
    const T* x2 = x1 + count;
    T* o0 = out + 3ull * g * count;
    T* o1 = o0 + count;
    T* o2 = o1 + count;
    for (unsigned long long i =
             static_cast<unsigned long long>(blockIdx.x) * kThreads + threadIdx.x;
         i < count; i += stride) {
      const T a = __ldg(x0 + i), b = __ldg(x1 + i), c = __ldg(x2 + i);
      T r, s, t;
      if constexpr (sizeof(T) == sizeof(float4)) {
        mix<kClamp>(m, a.x, b.x, c.x, r.x, s.x, t.x);
        mix<kClamp>(m, a.y, b.y, c.y, r.y, s.y, t.y);
        mix<kClamp>(m, a.z, b.z, c.z, r.z, s.z, t.z);
        mix<kClamp>(m, a.w, b.w, c.w, r.w, s.w, t.w);
      } else {
        mix<kClamp>(m, a, b, c, r, s, t);
      }
      o0[i] = r;
      o1[i] = s;
      o2[i] = t;
    }
  }
}

template <typename T, bool kClamp>
cudaError_t launch(const float* x, const float* mat, float* out, int groups,
                   unsigned long long count, cudaStream_t stream) {
  const int rows = groups < kMaxRows ? groups : kMaxRows;
  const unsigned long long need = (count + kThreads - 1) / kThreads;
  const unsigned long long cap =
      static_cast<unsigned long long>(kGridBlocks / rows > 0 ? kGridBlocks / rows : 1);
  const dim3 grid(static_cast<unsigned>(need < cap ? need : cap), rows);
  colour_matrix_kernel<T, kClamp><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(x), mat, reinterpret_cast<T*>(out), groups, count);
  return cudaGetLastError();
}

// The delay line and the decoder's matrix in one pass.  For line l of a frame,
// with neighbour n(l) = l - 1 (l >= 1) and n(0) = 1, the reflection
// separate/stencil.py::prev_reflect takes:
//
//   u = 0.5f * (c1[l] + c1[n(l)]),  v = 0.5f * (c2[l] + c2[n(l)])
//
// each sum rounded to nearest and the halving exact, as the plain composition
// (separate/delayline.py::average_with_neighbor on each chroma plane, the stack,
// apply_mat3 with its clamp) computes them; then `mix` on (y[l], u, v)
// with the clamp.  So the result is bit for bit the plain composition's.
//
// It reads the three planes once and writes three, 24 bytes a pixel.  The
// neighbour line is one line (`row` elements) before the sample in the same
// plane, or one after on line 0, so no division finds it: an index i below
// `row` is on line 0.  A block's neighbour reads are the lines that it, or the
// block before it, has just read, which the L2 still holds.  Same grid as
// colour_matrix_kernel; T is float4 where the line is a multiple of 4 samples
// and both pointers 16-byte aligned, float otherwise; `row` and `count` are a
// line and a plane in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delayline_matrix_kernel(const T* __restrict__ x, const float* __restrict__ mat,
                        T* __restrict__ out, int groups, unsigned row, unsigned count) {
  Mat3 m;
#pragma unroll
  for (int i = 0; i < 9; ++i) m.m[i] = __ldg(mat + i);
  const unsigned stride = gridDim.x * kThreads;
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const T* x0 = x + 3ull * g * count;
    const T* x1 = x0 + count;
    const T* x2 = x1 + count;
    T* o0 = out + 3ull * g * count;
    T* o1 = o0 + count;
    T* o2 = o1 + count;
    for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < count; i += stride) {
      const unsigned j = i < row ? i + row : i - row;
      const T a = __ldg(x0 + i);
      const T b = __ldg(x1 + i), bn = __ldg(x1 + j);
      const T c = __ldg(x2 + i), cn = __ldg(x2 + j);
      T r, s, t;
      if constexpr (sizeof(T) == sizeof(float4)) {
        mix<true>(m, a.x, half_sum(b.x, bn.x), half_sum(c.x, cn.x), r.x, s.x, t.x);
        mix<true>(m, a.y, half_sum(b.y, bn.y), half_sum(c.y, cn.y), r.y, s.y, t.y);
        mix<true>(m, a.z, half_sum(b.z, bn.z), half_sum(c.z, cn.z), r.z, s.z, t.z);
        mix<true>(m, a.w, half_sum(b.w, bn.w), half_sum(c.w, cn.w), r.w, s.w, t.w);
      } else {
        mix<true>(m, a, half_sum(b, bn), half_sum(c, cn), r, s, t);
      }
      o0[i] = r;
      o1[i] = s;
      o2[i] = t;
    }
  }
}

template <typename T>
cudaError_t launch_delayline(const float* x, const float* mat, float* out, int groups,
                             unsigned row, unsigned count, cudaStream_t stream) {
  const int rows = groups < kMaxRows ? groups : kMaxRows;
  const unsigned need = (count + kThreads - 1) / kThreads;
  const unsigned cap = static_cast<unsigned>(kGridBlocks / rows > 0 ? kGridBlocks / rows : 1);
  const dim3 grid(need < cap ? need : cap, rows);
  delayline_matrix_kernel<T><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(x), mat, reinterpret_cast<T*>(out), groups, row, count);
  return cudaGetLastError();
}

}  // namespace

// x and out: `groups` groups of three planes of `plane` samples each, contiguous;
// mat: the (3, 3) matrix, row d holding output d's weights of inputs 0, 1, 2
extern "C" cudaError_t colour_matrix(const float* x, const float* mat, float* out, int groups,
                                     unsigned long long plane, int clamp,
                                     cudaStream_t stream) {
  if (groups == 0 || plane == 0) return cudaSuccess;
  if (groups < 0) return cudaErrorInvalidValue;
  const bool vec = plane % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    return clamp ? launch<float4, true>(x, mat, out, groups, plane / 4, stream)
                 : launch<float4, false>(x, mat, out, groups, plane / 4, stream);
  }
  return clamp ? launch<float, true>(x, mat, out, groups, plane, stream)
               : launch<float, false>(x, mat, out, groups, plane, stream);
}

// x and out: `groups` groups of the planes (Y, C1, C2), each `lines` lines of
// `samples` samples, contiguous; mat: the decoder's (3, 3) matrix.  A frame of
// one line has no neighbour line, and a plane must index in 32 bits: both are
// refused (cudaErrorInvalidValue).
extern "C" cudaError_t delayline_matrix(const float* x, const float* mat, float* out,
                                        int groups, int lines, int samples,
                                        cudaStream_t stream) {
  if (groups == 0 || samples == 0) return cudaSuccess;
  if (groups < 0 || lines < 2 || samples < 0) return cudaErrorInvalidValue;
  const unsigned long long plane = static_cast<unsigned long long>(lines) * samples;
  if (plane + samples > 0xFFFFFFFFull - 1ull * kGridBlocks * kThreads) {
    return cudaErrorInvalidValue;
  }
  const bool vec = samples % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    return launch_delayline<float4>(x, mat, out, groups, samples / 4,
                                    static_cast<unsigned>(plane / 4), stream);
  }
  return launch_delayline<float>(x, mat, out, groups, samples, static_cast<unsigned>(plane),
                                 stream);
}
