// The line-axis comb stencil in front of the QAM decode kernel: the signal
// whose sample-axis band-pass is the chroma band, for the decoders 'comb2' and
// 'comb3' at the comb spacing p (1 line for NTSC, 2 for the PAL family):
//
//   comb2:  s[l] = (x[l] - x[l-p]) / 2
//   comb3:  s[l] = ((2 x[l] - x[l-p]) - x[l+p]) / 4
//
// with the line edges reflected as separate/stencil.py reflects them: above the
// top, line l < p takes x[p - l] for x[l-p]; below the bottom, line l >= L - p
// takes x[2 (L-1) - l - p] for x[l+p].
//
// Replaces no Pallas kernel.  The JAX package leaves the stencil to XLA outside
// the decode kernel (separate/comb.py::stencil_signal, on stencil.py's flips and
// concatenations), as the seam where the sharded pipelines exchange their line
// halos.  The port's plain version (separate/comb.py::line_stencil) is that
// composition in eight launches: two flips, two torch.cat, a scale, two
// subtractions and a division, some 14 planes of device traffic.
//
// Arithmetic: in the plain composition's order, each step rounded to nearest
// in float32 and kept apart by the _rn intrinsics, so nothing contracts into a
// multiply-add; 2 x and the halving and quartering are exact powers of two
// (x * 0.25f is x / 4 correctly rounded, subnormals too).  So the result is bit
// for bit the plain composition's, NaNs and infinities where it has them.
//
// What bounds it on an H100: the bytes.  One read of the composite and one
// write of the stencil signal, 8 bytes a sample; at 64 x 480 x 720 that is
// 176.9 MB, 0.0528 ms at 3.35 TB/s.  Its two or three operations a sample are
// nothing beside that.
//
// Design: registers only, no shared memory.  A thread owns one column of 16
// bytes (4 samples, a float4) of one strip of kStrip lines of one frame.  It
// loads the strip's rows and the p-line halos the stencil reads above and below
// it (p below for comb2) into registers, all the loads first, then writes the
// strip's output rows from them: a register window as tall as the strip.  So
// each row of the strip comes from device memory once; only the halos are read
// twice, and those the thread of the neighbouring strip, one block or so away,
// reads at the same time, so the L2 cache serves them.  Neighbouring threads
// hold neighbouring columns of one row: a warp loads and stores 512 contiguous
// bytes.  With every load of the strip in flight at once (17 to 20 float4s a
// thread) the pass reaches ~82% of its bound on an H100; a window of 2p + 1
// rows that loads a row per output row, which the compiler issued one at a
// time, reached ~70%, at strips of 8, 16 or 32 lines alike.  Where the line is
// not a multiple of 4 samples, or a pointer is not 16-byte aligned, the same
// strips run on single samples (a ragged row cannot start 16-byte aligned);
// rows past the last line of a frame, in the last strip, are loaded from a
// clamped line and never stored.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// output lines per thread: the halos add 2p / kStrip to the reads (from the L2)
constexpr int kStrip = 16;
// a grid-stride loop covers anything past this many blocks
constexpr unsigned kMaxBlocks = 1u << 30;

__device__ __forceinline__ float comb2(float prev, float x) {
  return __fmul_rn(0.5f, __fsub_rn(x, prev));
}

__device__ __forceinline__ float comb3(float prev, float x, float next) {
  return __fmul_rn(0.25f, __fsub_rn(__fsub_rn(__fmul_rn(2.0f, x), prev), next));
}

__device__ __forceinline__ float4 comb2(float4 prev, float4 x) {
  return make_float4(comb2(prev.x, x.x), comb2(prev.y, x.y), comb2(prev.z, x.z),
                     comb2(prev.w, x.w));
}

__device__ __forceinline__ float4 comb3(float4 prev, float4 x, float4 next) {
  return make_float4(comb3(prev.x, x.x, next.x), comb3(prev.y, x.y, next.y),
                     comb3(prev.z, x.z, next.z), comb3(prev.w, x.w, next.w));
}

// the line that row r of the window reads: reflected at both edges, then
// clamped (only rows past the frame's last line, whose outputs are never
// stored, reach the clamp)
__device__ __forceinline__ int source_line(int r, int lines) {
  r = r < 0 ? -r : r;
  r = r > lines - 1 ? 2 * (lines - 1) - r : r;
  return r < 0 ? 0 : (r > lines - 1 ? lines - 1 : r);
}

// T is float4 (`cols` is the line over 4) or float; P is the spacing
template <typename T, int P, bool kComb3>
__global__ void __launch_bounds__(kThreads)
comb_stencil_kernel(const T* __restrict__ x, T* __restrict__ out, int lines, unsigned cols,
                    unsigned strips, unsigned long long items) {
  // w holds rows l0 - P .. l0 + kStrip - 1 + kLead: output line l0 + k reads
  // w[k] (line - P), w[k + P] (itself) and, for comb3, w[k + 2P] (line + P)
  constexpr int kLead = kComb3 ? P : 0;
  constexpr int kRows = kStrip + P + kLead;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long item = static_cast<unsigned long long>(blockIdx.x) * kThreads +
                                 threadIdx.x;
       item < items; item += stride) {
    const unsigned col = static_cast<unsigned>(item % cols);
    const unsigned long long rest = item / cols;
    const int l0 = static_cast<int>(rest % strips) * kStrip;
    const unsigned long long frame = (rest / strips) * static_cast<unsigned long long>(lines) *
                                     cols + col;
    const T* src = x + frame;
    T* dst = out + frame;
    // every load first, so that the strip's rows are all in flight at once
    T w[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      w[i] = __ldg(src + static_cast<unsigned>(source_line(l0 - P + i, lines)) * cols);
    }
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int l = l0 + k;
      if (l < lines) {
        if constexpr (kComb3) {
          dst[static_cast<unsigned>(l) * cols] = comb3(w[k], w[k + P], w[k + 2 * P]);
        } else {
          dst[static_cast<unsigned>(l) * cols] = comb2(w[k], w[k + P]);
        }
      }
    }
  }
}

template <typename T, int P, bool kComb3>
cudaError_t launch(const float* x, float* out, int groups, int lines, unsigned cols,
                   cudaStream_t stream) {
  const unsigned strips = static_cast<unsigned>((lines + kStrip - 1) / kStrip);
  const unsigned long long items = static_cast<unsigned long long>(groups) * strips * cols;
  const unsigned long long need = (items + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(need < kMaxBlocks ? need : kMaxBlocks);
  comb_stencil_kernel<T, P, kComb3><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<T*>(out), lines, cols, strips, items);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(const float* x, float* out, int groups, int lines, unsigned cols,
                        int p, int form, cudaStream_t stream) {
  if (p == 1) {
    return form == 3 ? launch<T, 1, true>(x, out, groups, lines, cols, stream)
                     : launch<T, 1, false>(x, out, groups, lines, cols, stream);
  }
  return form == 3 ? launch<T, 2, true>(x, out, groups, lines, cols, stream)
                   : launch<T, 2, false>(x, out, groups, lines, cols, stream);
}

}  // namespace

// x and out: `groups` frames of `lines` lines of `samples` samples, contiguous;
// p: the comb spacing, 1 or 2; form: 2 ('comb2') or 3 ('comb3').  A frame needs
// p + 1 lines for the reflections, and a frame must index in 32 bits; anything
// else is refused (cudaErrorInvalidValue).
extern "C" cudaError_t comb_stencil(const float* x, float* out, int groups, int lines,
                                    int samples, int p, int form, cudaStream_t stream) {
  if (groups == 0 || samples == 0) return cudaSuccess;
  if (groups < 0 || samples < 0 || (p != 1 && p != 2) || (form != 2 && form != 3) ||
      lines < p + 1) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<unsigned long long>(lines) * samples > 0x7FFFFFFFull) {
    return cudaErrorInvalidValue;
  }
  const bool vec = samples % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    return launch_form<float4>(x, out, groups, lines, static_cast<unsigned>(samples / 4), p,
                               form, stream);
  }
  return launch_form<float>(x, out, groups, lines, static_cast<unsigned>(samples), p, form,
                            stream);
}
