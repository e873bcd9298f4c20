// The sumcheck / multilinear hot loops as CUDA kernels for Hopper (sm_90a).
//
// Four kernels, each the counterpart of one Pallas TPU kernel of
// zktpu/field/pallas_kernels.py. All share one first design: one thread per
// field element, the element's W words moved as 16-byte vectors and held in
// registers (field.cuh), a grid-stride loop, no shared memory except for the
// block reduction of the two summing kernels. Tables are (size, W) uint32 words,
// element-major; every power-of-two size from 2 up is taken, the ragged edge is
// masked by the loop bound.
//
// Plain C interface (loaded with ctypes): every function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for a word count it was not built for). The challenge
// `r` is a DEVICE pointer to W words: in the fused prover it is computed on the
// card from the Keccak digest and never visits the host.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

using zk::Modulus;

template <int W>
Modulus<W> make_modulus(const uint32_t* p_host, uint32_t n0) {
  Modulus<W> m;
  for (int j = 0; j < W; ++j) m.p[j] = p_host[j];
  m.n0 = n0;
  return m;
}

// ---------------------------------------------------------------------------
// mont_mul -- replaces zktpu/field/pallas_kernels.py:mont_mul_pallas (:110).
// out[i] = a[i] * b[i] * R^-1 mod p; with b_stride = 0, b is one element that
// multiplies every a[i] (to_mont and from_mont of a whole table).
// Bound on this card: bytes. An element moves 3 * 4W bytes for 2W^2 + W wide
// multiply-adds; at W = 8 that is 96 bytes for 136 products, and the card does
// integer multiply-adds faster than memory delivers the words. The design just
// keeps every word in registers and every access a 16-byte vector.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, long long n, long long b_stride,
                const Modulus<W> m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t x[W], y[W], z[W];
    zk::load_words<W>(x, a + i * W);
    zk::load_words<W>(y, b + i * b_stride);
    zk::mont_mul<W>(z, x, y, m);
    zk::store_words<W>(out + i * W, z);
  }
}

// ---------------------------------------------------------------------------
// fold -- replaces pallas_kernels.py:fold_pallas (:140).
// table (lead, size, W) -> out (lead, size/2, W): out[l, i] = a + r * (b - a)
// with a = table[l, i], b = table[l, i + size/2].
// Bound: bytes (two elements read, one written, one Montgomery product). The
// leading dimension is flattened into the thread index, so one launch folds a
// whole stack of tables (the GKR dense fold will need that).
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ r_ptr,
            uint32_t* __restrict__ out, long long lead, long long half, int log_half,
            const Modulus<W> m) {
  uint32_t r[W];
  zk::load_words<W>(r, r_ptr);
  const long long total = lead * half;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total; g += stride) {
    const long long l = g >> log_half;
    const long long i = g & (half - 1);
    const uint32_t* base = table + (l * 2 * half + i) * W;
    uint32_t a[W], b[W], f[W];
    zk::load_words<W>(a, base);
    zk::load_words<W>(b, base + half * W);
    zk::lerp<W>(f, a, b, r, m);
    zk::store_words<W>(out + g * W, f);
  }
}

// ---------------------------------------------------------------------------
// Reductions. The TPU kernels carry the running sum from grid step to grid step
// in a resident output block; here blocks run in any order and nothing carries
// over. Each thread adds its words column by column into 64-bit accumulators (a
// 32-bit column over fewer than 2^31 entries fits), the block reduces them by
// shuffles and shared memory and writes one row of per-block partials, and a
// small finishing kernel adds the partials and ripples the column sums into
// clean words. Integer addition is associative, so the result is exact and the
// same on every run.
// ---------------------------------------------------------------------------
template <int W>
__device__ __forceinline__ void block_reduce_store(uint64_t (&acc)[W], uint64_t* dst) {
  __shared__ uint64_t warp_sums[W][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    unsigned long long v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < W) {
    uint64_t s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[threadIdx.x][w];
    dst[threadIdx.x] = s;
  }
}

// partials (2, nb, W) uint64 -> rows (2, W + 1) clean words. One block per row.
template <int W>
__global__ void __launch_bounds__(kThreads)
finish_rows_kernel(const uint64_t* __restrict__ partials, int nb, uint32_t* __restrict__ rows) {
  __shared__ uint64_t cols[W];
  const int h = blockIdx.x;
  uint64_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const uint64_t* row = partials + ((size_t)h * nb + b) * W;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += row[j];
  }
  block_reduce_store<W>(acc, cols);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t c = 0;
    for (int j = 0; j < W; ++j) {
      const uint64_t v = cols[j] + c;
      rows[h * (W + 1) + j] = (uint32_t)v;
      c = v >> 32;
    }
    rows[h * (W + 1) + W] = (uint32_t)c;
  }
}

// ---------------------------------------------------------------------------
// halves_sums -- replaces pallas_kernels.py:halves_sums_pallas (:184).
// Exact integer sums of the first and the second half of a (size, W) table, as
// two rows of W + 1 words. Bound: bytes (the table is read once, nothing but 72
// bytes is written). blockIdx.y picks the half, so a block never mixes them.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads)
halves_sums_kernel(const uint32_t* __restrict__ table, uint64_t* __restrict__ partials,
                   long long half) {
  const uint32_t* base = table + (long long)blockIdx.y * half * W;
  uint64_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < half; i += stride) {
    uint32_t x[W];
    zk::load_words<W>(x, base + i * W);
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += x[j];
  }
  block_reduce_store<W>(acc, partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * W);
}

// ---------------------------------------------------------------------------
// fold_and_halves -- replaces pallas_kernels.py:fold_and_halves_pallas (:227).
// One sumcheck round in one pass over the table: fold (size, W) at r into
// (size/2, W), and sum the FOLDED table's two halves on the way out, so the
// folded words are never read back. Bound: bytes (size elements read, size/2
// written). Which half a folded element belongs to is decided by its index in
// the folded table (i < size/4); blockIdx.y picks that half.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads)
fold_and_halves_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ r_ptr,
                       uint32_t* __restrict__ out, uint64_t* __restrict__ partials,
                       long long half, const Modulus<W> m) {
  uint32_t r[W];
  zk::load_words<W>(r, r_ptr);
  const long long quarter = half / 2;
  const long long lo = blockIdx.y ? quarter : 0;
  const long long hi = blockIdx.y ? half : quarter;
  uint64_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < hi; i += stride) {
    uint32_t a[W], b[W], f[W];
    zk::load_words<W>(a, table + i * W);
    zk::load_words<W>(b, table + (i + half) * W);
    zk::lerp<W>(f, a, b, r, m);
    zk::store_words<W>(out + i * W, f);
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += f[j];
  }
  block_reduce_store<W>(acc, partials + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * W);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
int blocks_for(long long n, int cap) {
  long long nb = (n + kThreads - 1) / kThreads;
  if (nb < 1) nb = 1;
  if (nb > cap) nb = cap;
  return (int)nb;
}

// enough resident blocks to fill 132 SMs several times over
constexpr int kMaxBlocks = 132 * 16;

template <int W>
int launch_mont_mul(const void* a, const void* b, void* out, long long n, long long b_stride,
                    const uint32_t* p, uint32_t n0, cudaStream_t s) {
  mont_mul_kernel<W><<<blocks_for(n, kMaxBlocks), kThreads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_stride,
      make_modulus<W>(p, n0));
  return (int)cudaGetLastError();
}

template <int W>
int launch_fold(const void* table, const void* r, void* out, long long lead, long long size,
                const uint32_t* p, uint32_t n0, cudaStream_t s) {
  const long long half = size / 2;
  int log_half = 0;
  while ((1LL << log_half) < half) ++log_half;
  fold_kernel<W><<<blocks_for(lead * half, kMaxBlocks), kThreads, 0, s>>>(
      (const uint32_t*)table, (const uint32_t*)r, (uint32_t*)out, lead, half, log_half,
      make_modulus<W>(p, n0));
  return (int)cudaGetLastError();
}

template <int W>
int launch_halves_sums(const void* table, void* partials, void* rows, long long size, int nb,
                       cudaStream_t s) {
  halves_sums_kernel<W><<<dim3(nb, 2), kThreads, 0, s>>>((const uint32_t*)table,
                                                         (uint64_t*)partials, size / 2);
  int err = (int)cudaGetLastError();
  if (err) return err;
  finish_rows_kernel<W><<<2, kThreads, 0, s>>>((const uint64_t*)partials, nb, (uint32_t*)rows);
  return (int)cudaGetLastError();
}

template <int W>
int launch_fold_and_halves(const void* table, const void* r, void* out, void* partials,
                           void* rows, long long size, int nb, const uint32_t* p, uint32_t n0,
                           cudaStream_t s) {
  fold_and_halves_kernel<W><<<dim3(nb, 2), kThreads, 0, s>>>(
      (const uint32_t*)table, (const uint32_t*)r, (uint32_t*)out, (uint64_t*)partials, size / 2,
      make_modulus<W>(p, n0));
  int err = (int)cudaGetLastError();
  if (err) return err;
  finish_rows_kernel<W><<<2, kThreads, 0, s>>>((const uint64_t*)partials, nb, (uint32_t*)rows);
  return (int)cudaGetLastError();
}

}  // namespace

#define ZK_DISPATCH_W(W, CALL8, CALL12) \
  do {                                  \
    if ((W) == 8) return CALL8;         \
    if ((W) == 12) return CALL12;       \
    return -1;                          \
  } while (0)

extern "C" {

// threads per block of every kernel here; the wrappers size the partials by it
int zk_block_threads() { return kThreads; }

// b_stride: W for an (n, W) table, 0 for a single element
int zk_mont_mul(const void* a, const void* b, void* out, long long n, long long b_stride, int W,
                const uint32_t* p, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_mont_mul<8>(a, b, out, n, b_stride, p, n0, s),
                launch_mont_mul<12>(a, b, out, n, b_stride, p, n0, s));
}

int zk_fold(const void* table, const void* r, void* out, long long lead, long long size, int W,
            const uint32_t* p, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_fold<8>(table, r, out, lead, size, p, n0, s),
                launch_fold<12>(table, r, out, lead, size, p, n0, s));
}

// partials: (2, nb, W) uint64 scratch; rows: (2, W + 1) uint32
int zk_halves_sums(const void* table, void* partials, void* rows, long long size, int nb, int W,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_halves_sums<8>(table, partials, rows, size, nb, s),
                launch_halves_sums<12>(table, partials, rows, size, nb, s));
}

int zk_fold_and_halves(const void* table, const void* r, void* out, void* partials, void* rows,
                       long long size, int nb, int W, const uint32_t* p, uint32_t n0,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_fold_and_halves<8>(table, r, out, partials, rows, size, nb, p, n0, s),
                launch_fold_and_halves<12>(table, r, out, partials, rows, size, nb, p, n0, s));
}

}  // extern "C"
