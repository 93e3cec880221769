// The FIR on the tensor cores: a 'same' FIR as a banded product of Toeplitz
// tiles, in three TF32 passes.  Two forms: 16 lines x 8 outputs per
// mma.sync (fir_group, the QAM kernels: the lines are its rows, A), and 16
// outputs x 8 lines (fir16, the SECAM kernels: the lines are its columns,
// B; see "The product with the outputs as rows" below).
//
// With tr[m] = taps[T-1-m] (the taps reversed) and the line staged with a
// halo, x~[i] = x[i - half], the output tile t (samples 8t..8t+7) is
//
//   out[l, 8t + r] = sum_{s<S} sum_{u<8} x~[l, 8(t+s) + u] * B_s[u, r],
//   B_s[u, r] = tr[8s + u - r] (0 outside [0, T)),  S = (T + 6) / 8 + 1,
//
// one mma.sync.m16n8k8 per (t, s) with M = 16 lines, N = 8 outputs, K = 8
// samples: 136 multiply-adds per output for 129 taps (5% above the direct
// FIR).  Why mma.sync and not wgmma, measured (scripts/torch_mma_ceiling.py
// on NVIDIA H100 80GB HBM3, 700.00 W; share of the card's 495 TFLOP/s, one
// warpgroup per SM):
//
//   wgmma.m64nNk8 tf32   N = 8    16     32     64     128    256
//   A from registers     28.7%  54.9%  87.7%  98.0%  98.2%  99.5%
//   A from shared        22.1%  39.6%  65.8%  98.2%  98.4%  98.1%
//   mma.sync.m16n8k8 tf32: 51.4-64.9% (4-16 accumulators a warp)
//
// The band makes an output tile of N outputs cost T + N - 1 multiply-adds
// per output, so here N stays at 8, where wgmma runs at half the rate of
// mma.sync.  The other layout, 64 outputs as M and 32 lines as N (A the
// Toeplitz tile from a table in shared memory, B the signal from TMA-staged
// slabs, 1.49x the direct FIR's products at 129 taps), was built and
// measured in full: slower than these kernels (PERF.md, section 6),
// because a warpgroup's own products stall it while the tensor cores take
// them in, the products ran at about half their rate in the kernels, and
// shared memory could not hold both the decode's rings.
//
// Precision: acc += A_lo*B_hi + A_hi*B_lo + A_hi*B_hi, fp32 accumulators.
// The B tiles are built once per plan on the host in float64 and split
// there into TF32 hi and lo parts (color_modem_tpu_torch/kernels/tiles.py::
// band_tiles), laid out in fragment order: tile s, lane -> float4
// (b0_hi, b1_hi, b0_lo, b1_lo), one 16-byte load per lane per step.  A is
// split in registers: hi = a rounded to TF32 by cvt.rna.tf32.f32's rule,
// written as two integer operations (the cvt itself compiles to about five
// on sm_90a), and lo = a - hi exactly, of which the tensor core reads the
// TF32 part (|lo| <= 2^-11 |a|, so the error is below 2^-21 |a|).  One
// TF32 pass keeps about three decimal digits; three passes keep about six,
// which the encoder's 2e-5 bound needs.
//
// Reuse: a warp computes kW = 4 neighbouring output tiles.  Per block of
// kW steps it loads 2*kW - 1 A chunks (one ldmatrix each, split once) and
// kW B fragments for 3*kW*kW products, as straight-line code: loads
// guarded by the step count inside the block kept the scheduler from
// issuing them ahead of the products, and made the kernels slower than
// the SIMT FIR they replace.  The tensor cores' own ceiling for this
// instruction is scripts/torch_mma_ceiling.py.
//
// Staging: a tile of 16 lines x a span of samples with its halo is copied
// into shared memory by cp.async, which zero-fills what lies outside the
// line (the 'same' FIR's zero edge) and below the last line (the ragged
// last tile).  Rows are padded so that pitch % 32 == 4: a fragment
// load (8 rows x 4 columns per instruction) hits 32 distinct banks.  The
// kernels are persistent, two blocks per SM, and each block loads its next
// tile while it computes this one: without that, every block waited for
// its own load, and a launch took the sum of the memory and tensor-core
// times.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bf {

constexpr int kRows = 16;   // lines per tile: the M of mma.m16n8k8
constexpr int kW = 4;       // output tiles per warp group
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 2;
// two blocks per SM: 228 KB of the SM's shared memory, 1 KB reserved per block
constexpr size_t kSmemBudget = 113 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ inline int n_steps(int ntaps) { return (ntaps + 6) / 8 + 1; }
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Floats per staged row holding `chunks` chunks of 8, padded to
// pitch % 32 == 4.
__host__ __device__ inline int pitch_of(int chunks) {
  const int len = 8 * chunks;
  return len + (36 - len % 32) % 32;
}

// Chunks a group loop over `tiles` output tiles reads (fir_group's bound).
__host__ __device__ inline int plane_chunks(int tiles, int steps) {
  return round_up(tiles, kW) + steps - 1;
}

// The widest span (a multiple of 8 samples, the line cut into equal spans)
// whose shared memory fits two blocks per SM; 0 if not even 8 samples fit
// one block.
template <class SmemOf>
inline int choose_span(int n, SmemOf smem_of, size_t& smem) {
  for (int ns = 1;; ++ns) {
    const int span = round_up((n + ns - 1) / ns, 8);
    smem = smem_of(span);
    if (smem <= kSmemBudget || span == 8) return smem <= kSmemMax ? span : 0;
  }
}

// --- the poisoned build (kernels/sanitize.py) -------------------------------
//
// Built with -DCMT_POISON, every kernel first fills its dynamic shared memory
// (its size read from %dynamic_smem_size) and its static shared arrays with
// kPoisonBits, a quiet NaN, and syncs, before its first staging: a read of
// shared memory the kernel never wrote then turns an output into a NaN or
// changes it, where a normal launch may find a harmless value there.  The
// sanitizer holds the poisoned build's outputs bit for bit to the normal
// build's.  Without the flag these blocks compile to nothing.
#ifdef CMT_POISON
constexpr unsigned kPoisonBits = 0x7FC5A5A5u;

__device__ inline unsigned dynamic_smem_bytes() {
  unsigned bytes;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
  return bytes;
}

// Every 4-byte word of [base, base + bytes) := kPoisonBits, by the block.
__device__ inline void poison_shared(void* base, unsigned bytes) {
  unsigned* words = static_cast<unsigned*>(base);
  for (unsigned i = threadIdx.x; i < bytes / 4; i += blockDim.x) words[i] = kPoisonBits;
}
#endif

// --- staging --------------------------------------------------------------

__device__ inline void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ inline void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Copy a row of n floats from device to shared memory by one warp, with
// cp.async (the caller commits and waits): 16-byte copies where both rows
// are 16-byte aligned and n % 4 == 0, else 4-byte ones; zeros, and `src`
// only a valid address, where `live` is false.
__device__ inline void warp_copy_row(float* dst, const float* src, int n, bool live) {
  const int lane = threadIdx.x & 31;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (__cvta_generic_to_shared(dst) & 15) == 0;
  if (vec)
    for (int k = 4 * lane; k < n; k += 128) cp_async16(dst + k, src + k, live ? 16 : 0);
  else
    for (int k = lane; k < n; k += 32) cp_async4(dst + k, src + k, live ? 4 : 0);
}

// The work of a launch: tiles of 16 lines x one span, the spans of a line
// block consecutive (their halos overlap, so neighbours meet in L2).  A
// launch has one block per (SM, kBlocksPerSm); each block walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...
struct TileGrid {
  int n_spans, total;
  __host__ __device__ TileGrid(int n_lines, int n, int span)
      : n_spans((n + span - 1) / span),
        total((n_lines + kRows - 1) / kRows * ((n + span - 1) / span)) {}
  __device__ void at(int tile, int span, int& line0, int& p0) const {
    line0 = tile / n_spans * kRows;
    p0 = tile % n_spans * span;
  }
};

// sm[r * pitch + k] = x(line0 + r, base + k) for r < 16, k < pitch; zero
// outside the line [0, n) and for lines >= n_lines.  row(line) is the
// line's first sample in device memory; each thread stays on one row, so
// it computes that address once.  16-byte copies where every row is
// 16-byte aligned (vec) and base % 4 == 0 (129 taps: half = 64), else
// 4-byte copies.  blockDim.x is a multiple of 16.
template <class Row>
__device__ inline void stage(float* sm, int pitch, int base, Row row, int line0,
                             int n_lines, int n, bool vec) {
  const int per_row = blockDim.x / kRows, r = threadIdx.x / per_row;
  const int line = line0 + r;
  const bool live = line < n_lines;
  const float* src = row(live ? line : line0);  // a valid address either way
  float* dst = sm + r * pitch;
  if (vec && base % 4 == 0) {
    for (int k = 4 * (threadIdx.x % per_row); k < pitch; k += 4 * per_row) {
      const int pos = base + k;
      const bool ok = live && pos >= 0 && pos + 4 <= n;
      cp_async16(dst + k, ok ? src + pos : src, ok ? 16 : 0);
    }
  } else {
    for (int k = threadIdx.x % per_row; k < pitch; k += per_row) {
      const int pos = base + k;
      const bool ok = live && pos >= 0 && pos < n;
      cp_async4(dst + k, ok ? src + pos : src, ok ? 4 : 0);
    }
  }
}

// --- the banded product ---------------------------------------------------

constexpr int kMaxDevices = 64;

// The host side of a launch: `blocks` = one per (SM, per_sm), capped at
// `total` tiles.  The SM count is read once per device.  The kernel's
// dynamic shared memory is opted in (shared memory before L1, so that two
// blocks of up to kSmemBudget fit an SM) once per device for the largest
// size asked so far; `opted` is the kernel's own record of it, a static of
// its caller.  After that a launch makes one runtime call here, cudaGetDevice.
template <class Kernel>
inline cudaError_t launch_blocks(Kernel kernel, size_t smem, int total,
                                 size_t (&opted)[kMaxDevices], int& blocks,
                                 int per_sm = kBlocksPerSm) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  if (opted[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  blocks = total < per_sm * sms[dev] ? total : per_sm * sms[dev];
  return cudaSuccess;
}

__device__ inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Frag {
  uint32_t hi[4], lo[4];
};

// The A fragment of a chunk by one ldmatrix: lanes 0-7 address rows 0-7 of
// its columns 0-3 (a0), lanes 8-15 rows 8-15 (a1), lanes 16-31 the same
// rows at columns 4-7 (a2, a3); each lane gets (row g, column q) of all
// four, split into hi = TF32 rounding of a (cvt.rna.tf32.f32's rule, ties
// away from zero, in two integer operations: the data are finite) and
// lo = a - hi.
__device__ inline void load_a(unsigned addr, Frag& f) {
  uint32_t v[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = (v[i] + 0x1000u) & 0xffffe000u;
    f.lo[i] = __float_as_uint(__uint_as_float(v[i]) - __uint_as_float(f.hi[i]));
  }
}

// acc += A * B in three TF32 passes, the small terms first; b is the step's
// (b0_hi, b1_hi, b0_lo, b1_lo).
__device__ inline void mma3(float (&acc)[4], const Frag& a, const float4& b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma_tf32(acc, a.lo, bh0, bh1);
  mma_tf32(acc, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(acc, a.hi, bh0, bh1);
}

// acc[w] = FIR output tiles t0 + w (w < kW) of the staged plane xs, whose
// chunk c starts at column 8c; bt holds the S steps' B fragments.
// Accumulator element e of tile w is row g + 8 * (e >> 1), sample
// 8 * (t0 + w) + 2 * q + (e & 1), with g = lane / 4, q = lane % 4.
__device__ inline void fir_group(const float* xs, int pitch, int t0,
                                 const float4* __restrict__ bt, int steps,
                                 float (&acc)[kW][4]) {
  const int lane = threadIdx.x & 31;
  const unsigned a0 = static_cast<unsigned>(__cvta_generic_to_shared(
      xs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + 4 * (lane >> 4) + 8 * t0));
#pragma unroll
  for (int w = 0; w < kW; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[w][e] = 0.0f;
  // whole blocks of kW steps as straight-line code, so that the scheduler
  // can issue all of a block's loads ahead of its products ...
  int sb = 0;
  for (; sb + kW <= steps; sb += kW) {
    float4 b[kW];
#pragma unroll
    for (int sp = 0; sp < kW; ++sp) b[sp] = __ldg(bt + (sb + sp) * 32 + lane);
    Frag a[2 * kW - 1];
#pragma unroll
    for (int j = 0; j < 2 * kW - 1; ++j) load_a(a0 + 32 * (sb + j), a[j]);
#pragma unroll
    for (int sp = 0; sp < kW; ++sp)
#pragma unroll
      for (int w = 0; w < kW; ++w) mma3(acc[w], a[w + sp], b[sp]);
  }
  // ... then the steps left over, one at a time
  for (; sb < steps; ++sb) {
    const float4 b = __ldg(bt + sb * 32 + lane);
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      Frag a;
      load_a(a0 + 32 * (sb + w), a);
      mma3(acc[w], a, b);
    }
  }
}

// (row[pos], row[pos + 1]), each 0 outside [lo, hi); one 8-byte load when
// both are inside and the address is 8-byte aligned.
__device__ inline float2 load2(const float* row, int pos, int lo, int hi) {
  if (pos >= lo && pos + 1 < hi && (reinterpret_cast<uintptr_t>(row + pos) & 7) == 0)
    return *reinterpret_cast<const float2*>(row + pos);
  return make_float2(pos >= lo && pos < hi ? row[pos] : 0.0f,
                     pos + 1 >= lo && pos + 1 < hi ? row[pos + 1] : 0.0f);
}

// row[pos] = v0, row[pos + 1] = v1 where the position lies in [lo, hi); one
// 8-byte store when both do and the address is 8-byte aligned.
__device__ inline void store2(float* row, int pos, int lo, int hi, float v0, float v1) {
  if (pos >= lo && pos + 1 < hi && (reinterpret_cast<uintptr_t>(row + pos) & 7) == 0) {
    *reinterpret_cast<float2*>(row + pos) = make_float2(v0, v1);
    return;
  }
  if (pos >= lo && pos < hi) row[pos] = v0;
  if (pos + 1 >= lo && pos + 1 < hi) row[pos + 1] = v1;
}

// Row (0..15) and sample offset within the group of accumulator (w, e).
__device__ inline int acc_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ inline int acc_col(int w, int e) {
  return 8 * w + 2 * (threadIdx.x & 3) + (e & 1);
}

// --- the product with the outputs as rows (the SECAM kernels) ------------
//
// The SECAM kernels chain up to six FIRs per line through shared memory,
// with nonlinear stages between them, so every plane of 16 lines would cost
// twice the shared memory of a plane of 8 (a decoder of 16 lines needs
// about 300 KB).  So there the lines are the N = 8 columns of
// mma.m16n8k8 and 16 outputs its M rows:
//
//   out[l, 16t + r] = sum_{s<S} sum_{u<8} A_s[r, u] * x~[l, 8(2t + s) + u],
//   A_s[r, u] = tr[8s + u - r] (0 outside [0, T)),  S = (T + 14) / 8 + 1,
//
// 144 multiply-adds per output for 129 taps (12% above the direct FIR).
//
// A is the 16x8 Toeplitz tile.  Its fragment for lane (g, q) is tr at
// d = 8s + q - g, d - 8, d + 4 and d - 4 (a0, a1, a2, a3), so step s + 1
// reads two new values and reuses two of step s: the kernel reads A from a
// table of the reversed taps, split into TF32 hi and lo on the host in
// float64 (kernels/tiles.py::band_tiles16: row m + 16 = (hi, lo) of tr[m]),
// a few KB per filter that stay in L1, where the fragments themselves (1 KB
// per warp per step) streamed from L2.
//
// B is the signal, read from a plane of 8 rows in shared memory that the
// kernel itself wrote between its nonlinear stages: lane (g, q) needs row g
// at columns 8c + q and 8c + q + 4; one ldmatrix.x4 gives it both for two
// chunks (conflict-free where pitch % 32 == 4).  B is split in registers:
// hi = b with its low 13 bits cleared, lo = b - hi (exact), of which the
// tensor core reads the TF32 part: the error is below 2^-20 |b|.
//
// A warp computes kW output tiles; each A value serves kW tiles, and tiles
// 2 chunks apart share B chunks in a straight-line block of kS >= 3 steps.
// kA tables (two filters on one signal) and kB signals (two arms through
// one filter) share the loads further.

__host__ __device__ inline int n_steps16(int ntaps) { return (ntaps + 14) / 8 + 1; }

struct Split {
  uint32_t hi, lo;
};

__device__ inline Split split_tf32(float v) {
  const uint32_t hi = __float_as_uint(v) & 0xffffe000u;
  return {hi, __float_as_uint(v - __uint_as_float(hi))};
}

// acc += A * B in three TF32 passes, the small terms first.
__device__ inline void mma3_rows(float (&acc)[4], const uint32_t (&ah)[4],
                                 const uint32_t (&al)[4], const Split& b0,
                                 const Split& b1) {
  mma_tf32(acc, al, b0.hi, b1.hi);
  mma_tf32(acc, ah, b0.lo, b1.lo);
  mma_tf32(acc, ah, b0.hi, b1.hi);
}

// r[k] = plane[row lane & 7][8c + 4k + ...]: lane (g, q) gets columns
// 8c + q, + 4, + 8, + 12 of row g from `addr`, the lane's ldmatrix address
// (ld_addr) plus 32 bytes per chunk.
__device__ inline void ldmatrix_x4(unsigned addr, float (&r)[4]) {
  uint32_t v[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = __uint_as_float(v[k]);
}

// The lane's ldmatrix address of chunk 0 of an 8-row plane: lanes 0-7 rows
// 0-7 at column 0, lanes 8-15 at column 4, lanes 16-31 the same at 8, 12.
__device__ inline unsigned ld_addr(const float* plane, int pitch) {
  const int lane = threadIdx.x & 31;
  return static_cast<unsigned>(__cvta_generic_to_shared(
      plane + (lane & 7) * pitch + 4 * ((lane >> 3) & 1) + 8 * (lane >> 4)));
}

// The B loader of one plane: pair(c) chunks c and c + 1 by ldmatrix, one(c)
// chunk c by two loads (for a last step whose pair would leave the plane).
struct PlaneB {
  unsigned addr;     // ld_addr(plane, pitch)
  const float* row;  // plane + g * pitch + q
  __device__ PlaneB(const float* plane, int pitch)
      : addr(ld_addr(plane, pitch)),
        row(plane + ((threadIdx.x & 31) >> 2) * pitch + (threadIdx.x & 3)) {}
  __device__ void pair(int c, float (&v)[1][2][2]) const {
    float r[4];
    ldmatrix_x4(addr + 32u * c, r);
    v[0][0][0] = r[0], v[0][0][1] = r[1], v[0][1][0] = r[2], v[0][1][1] = r[3];
  }
  __device__ void one(int c, float (&v)[1][2]) const {
    v[0][0] = row[8 * c];
    v[0][1] = row[8 * c + 4];
  }
};

// Where fir16 reads its tap tables (and the decoder its mix rows): device
// memory through the read-only cache, or shared memory the kernel filled.
struct GlobalTables {
  __device__ static float2 ld(const float2* p) { return __ldg(p); }
  __device__ static float ld(const float* p) { return __ldg(p); }
};
struct SharedTables {
  __device__ static float2 ld(const float2* p) { return *p; }
  __device__ static float ld(const float* p) { return *p; }
};

// One straight-line block of kS steps from step sb, for the kW tiles whose
// first chunk is c0: all of its B chunks and A values are loaded before its
// products.  acc[a * kB + j][w] += table a (*) signal j, tile w; tr[a] is the
// lane's pointer into table a (fir16).
template <int kW, int kS, int kA, int kB, class Tab, class LoadB>
__device__ inline void fir16_block(int c0, int sb, const float2* const (&tr)[kA],
                                   const LoadB& ldb, float (&acc)[kA * kB][kW][4]) {
  constexpr int kC = 2 * kW + kS - 2;  // chunks the block reads
  Split b[kC][kB][2];
  if constexpr (kS % 2 == 0) {
#pragma unroll
    for (int o = 0; o < kC; o += 2) {
      float v[kB][2][2];
      ldb.pair(c0 + sb + o, v);
#pragma unroll
      for (int j = 0; j < kB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          b[o + h][j][0] = split_tf32(v[j][h][0]);
          b[o + h][j][1] = split_tf32(v[j][h][1]);
        }
    }
  } else {
#pragma unroll
    for (int o = 0; o < kC; ++o) {
      if (kS == 1 && (o & 1)) continue;  // one step reads only even offsets
      float v[kB][2];
      ldb.one(c0 + sb + o, v);
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        b[o][j][0] = split_tf32(v[j][0]);
        b[o][j][1] = split_tf32(v[j][1]);
      }
    }
  }
  // the A window: tr[d - 8 + 4k] for k < 2 kS + 2, d = 8 sb + q - g
  float2 wa[kA][2 * kS + 2];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int k = 0; k < 2 * kS + 2; ++k) wa[a][k] = Tab::ld(tr[a] + 8 * sb + 4 * k);
#pragma unroll
  for (int sp = 0; sp < kS; ++sp)
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      const float2* f = wa[a] + 2 * sp;
      const uint32_t ah[4] = {__float_as_uint(f[2].x), __float_as_uint(f[0].x),
                              __float_as_uint(f[3].x), __float_as_uint(f[1].x)};
      const uint32_t al[4] = {__float_as_uint(f[2].y), __float_as_uint(f[0].y),
                              __float_as_uint(f[3].y), __float_as_uint(f[1].y)};
#pragma unroll
      for (int w = 0; w < kW; ++w)
#pragma unroll
        for (int j = 0; j < kB; ++j)
          mma3_rows(acc[a * kB + j][w], ah, al, b[2 * w + sp][j][0], b[2 * w + sp][j][1]);
    }
}

// acc = output tiles t0 .. t0 + kW - 1 (16 outputs each, out[16t + r]
// reading chunks 2t .. 2t + S - 1 of the loader's plane) of kA filters
// (tables, kernels/tiles.py::band_tiles16) on kB signals, S = steps;
// blocks of kS steps, then the rest one at a time; Tab: where the tables
// lie.
template <int kW, int kS, int kA, int kB, class Tab = GlobalTables, class LoadB>
__device__ inline void fir16(int t0, const float2* const (&table)[kA], int steps,
                             const LoadB& ldb, float (&acc)[kA * kB][kW][4]) {
  const int lane = threadIdx.x & 31;
  const float2* tr[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) tr[a] = table[a] + 8 + (lane & 3) - (lane >> 2);
#pragma unroll
  for (int k = 0; k < kA * kB; ++k)
#pragma unroll
    for (int w = 0; w < kW; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][w][e] = 0.0f;
  int sb = 0;
  for (; sb + kS <= steps; sb += kS) fir16_block<kW, kS, kA, kB, Tab>(2 * t0, sb, tr, ldb, acc);
  for (; sb < steps; ++sb) fir16_block<kW, 1, kA, kB, Tab>(2 * t0, sb, tr, ldb, acc);
}

// Output (0..15) within its tile, and plane row (0..7), of accumulator e.
__device__ inline int acc16_out(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ inline int acc16_row(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// Columns a loop over `tiles` output tiles in groups of kW reads from its
// plane (fir16's bound).
__host__ __device__ inline int plane16_cols(int tiles, int kw, int steps) {
  return 8 * (2 * round_up(tiles, kw) + steps - 2);
}

}  // namespace bf
