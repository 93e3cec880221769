// threefry2x32, the JAX package's PRNG, on the card: the port's noise equals
// jax.random's from the same keys.
//
// Replaces no Pallas kernel.  The JAX package draws every noise through
// jax.random (threefry2x32 in its partitionable form), which XLA lowers to
// elementwise integer work; utils/prng.py holds the key algebra on the host
// and the plain PyTorch version, some 150 elementwise passes over int64
// tensors.  Two entry points:
//
//   threefry_bits        out[i] = bits1 ^ bits2, the hash of the counter
//                        (i >> 32, i mod 2^32) under one key: jax.random.bits.
//   threefry_add_normal  out[t, i] = x[t, i] + sigma * normal, over `items`
//                        rows of `words` values; row t's key is the key itself
//                        or, with `fold`, fold_in(key, g0 + t) (the hash of
//                        the counter (0, g0 + t)); x may be NULL (the normal
//                        alone).  normal = sqrt(2) * erf_inv(u), u = max(lo,
//                        2 f + lo) with f the top 23 bits as a float in [0, 1)
//                        and lo = nextafter(-1, 0): jax.random.normal.
//
// The arithmetic follows utils/prng.py operation for operation: __fmul_rn and
// __fadd_rn keep nvcc from contracting a product and a sum into one rounding,
// so only log1pf may differ from the plain version (by an ulp of w); the bits
// are exact.
//
// What bounds it on an H100: per value the hash runs 20 rotations (funnel
// shifts) and 20 xors that only the 64 INT32 lanes of an SM take: 41 such
// operations with the words' xor (the bits), 43 with the mantissa's shift
// and or (the normal) (kernels/measure.py::THREEFRY_INT_OPS; its 32 adds
// may issue to the float lanes as integer multiply-adds, beside the
// normal's ~45 float operations).  At 16 x 480 x 2880 values (22.1 M: the
// video runner's satellite noise on 16 NTSC frames) the normal is 0.95 G
// such operations, 0.057 ms at 132 SMs x 64 lanes x 1.98 GHz, just above
// the 177 MB that x + sigma * n reads and writes (0.053 ms at 3.35 TB/s).  The integer lanes bound it.
//
// Design: a grid-stride loop, no shared staging; row t of the grid's second
// dimension is item t, whose key thread 0 hashes once into shared memory.
// The rotations are __funnelshift_l; the counters are 64-bit.
//
// nvcc -Xptxas -v, sm_90a (scripts/torch_ptxas_stats.py): 19 registers (the
// normal) and 22 (the bits), no stack, no spills, 8 bytes of shared memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "band_fir.cuh"

namespace {

constexpr int kThreads = 256;
// blocks in flight across all items: 8 blocks of 256 threads on each of 132 SMs, twice
constexpr int kGridBlocks = 2 * 8 * 132;
constexpr int kMaxItems = 65535;  // gridDim.y
constexpr uint32_t kParity = 0x1BD11BDAu;

// four rounds: x0 += x1, x1 = rotl(x1, r) ^ x0
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                                       int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

// threefry2x32 of the counter pair (x0, x1) under the key (k0, k1), in place
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// XLA's float32 erf_inv (M. Giles): w = -log1p(-x x), a degree-8 polynomial of
// w - 2.5 (w < 5) or of sqrt(w) - 3 by Horner, times x
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  float p;
  if (w < 5.0f) {
    w = __fadd_rn(w, -2.5f);
    p = 2.81022636e-08f;
    p = __fadd_rn(3.43273939e-07f, __fmul_rn(p, w));
    p = __fadd_rn(-3.5233877e-06f, __fmul_rn(p, w));
    p = __fadd_rn(-4.39150654e-06f, __fmul_rn(p, w));
    p = __fadd_rn(0.00021858087f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00125372503f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00417768164f, __fmul_rn(p, w));
    p = __fadd_rn(0.246640727f, __fmul_rn(p, w));
    p = __fadd_rn(1.50140941f, __fmul_rn(p, w));
  } else {
    w = __fadd_rn(sqrtf(w), -3.0f);
    p = -0.000200214257f;
    p = __fadd_rn(0.000100950558f, __fmul_rn(p, w));
    p = __fadd_rn(0.00134934322f, __fmul_rn(p, w));
    p = __fadd_rn(-0.00367342844f, __fmul_rn(p, w));
    p = __fadd_rn(0.00573950773f, __fmul_rn(p, w));
    p = __fadd_rn(-0.0076224613f, __fmul_rn(p, w));
    p = __fadd_rn(0.00943887047f, __fmul_rn(p, w));
    p = __fadd_rn(1.00167406f, __fmul_rn(p, w));
    p = __fadd_rn(2.83297682f, __fmul_rn(p, w));
  }
  return __fmul_rn(p, x);
}

// jax.random.normal from one word: the uniform on [lo, 1), then sqrt(2) erf_inv
__device__ __forceinline__ float unit_normal(uint32_t bits) {
  constexpr float kLo = -0.99999994f;  // nextafter(-1, 0); 1 - lo rounds to 2
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(kLo, __fadd_rn(__fmul_rn(f, 2.0f), kLo));
  return __fmul_rn(1.41421356f, erf_inv(u));
}

template <bool kNormal>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(uint32_t k0, uint32_t k1, int fold, uint32_t g0, const float* __restrict__ x,
                float sigma, void* __restrict__ out, unsigned long long words) {
  __shared__ uint32_t key_s[2];
#ifdef CMT_POISON
  bf::poison_shared(key_s, sizeof(key_s));
  __syncthreads();
#endif
  const unsigned item = blockIdx.y;
  if (threadIdx.x == 0) {
    // fold_in(key, g0 + item): the hash of the counter (0, g0 + item)
    uint32_t a = 0u, b = g0 + item;
    if (fold) {
      threefry(k0, k1, a, b);
    } else {
      a = k0;
      b = k1;
    }
    key_s[0] = a;
    key_s[1] = b;
  }
  __syncthreads();
  const uint32_t a = key_s[0], b = key_s[1];
  const unsigned long long base = static_cast<unsigned long long>(item) * words;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long i = static_cast<unsigned long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < words; i += stride) {
    uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
    threefry(a, b, x0, x1);
    const uint32_t bits = x0 ^ x1;
    if constexpr (kNormal) {
      const float n = unit_normal(bits);
      static_cast<float*>(out)[base + i] =
          x != nullptr ? __fadd_rn(x[base + i], __fmul_rn(sigma, n)) : n;
    } else {
      static_cast<uint32_t*>(out)[base + i] = bits;
    }
  }
}

int blocks_per_item(unsigned long long words, int items) {
  const unsigned long long need = (words + kThreads - 1) / kThreads;
  const unsigned long long cap = static_cast<unsigned long long>(
      kGridBlocks / items > 0 ? kGridBlocks / items : 1);
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace

extern "C" cudaError_t threefry_bits(uint32_t* out, uint32_t k0, uint32_t k1,
                                     unsigned long long words, cudaStream_t stream) {
  if (words == 0) return cudaSuccess;
  threefry_kernel<false><<<dim3(blocks_per_item(words, 1), 1), kThreads, 0, stream>>>(
      k0, k1, 0, 0u, nullptr, 0.0f, out, words);
  return cudaGetLastError();
}

extern "C" cudaError_t threefry_add_normal(const float* x, float* out, uint32_t k0,
                                           uint32_t k1, int fold, uint32_t g0, float sigma,
                                           unsigned long long words, int items,
                                           cudaStream_t stream) {
  if (words == 0 || items == 0) return cudaSuccess;
  if (items < 0 || items > kMaxItems) return cudaErrorInvalidValue;
  threefry_kernel<true><<<dim3(blocks_per_item(words, items), items), kThreads, 0, stream>>>(
      k0, k1, fold, g0, x, sigma, out, words);
  return cudaGetLastError();
}
