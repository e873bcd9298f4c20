// The tables of a lazy GKR layer as three CUDA kernels for Hopper (sm_90a).
//
// Each layer of the GKR walk builds, before its first sumcheck phase, the
// per-gate wiring coefficients and the phase-1 stack, and between its phases
// the phase-2 stack (gkr/lazy.py, gkr/fused_lazy.py). Their plain PyTorch
// versions (gkr/tables.py) are chains of whole-table products, modular
// additions, selects and interleaves, some 800 eager operations a layer. Here
// each table is one launch that writes it once, in its final layout
// (gkr_tables.cuh has the per-thread work and the eq tables' halves):
//
//   * gkr_wiring -- coef_a, coef_m of one layer: a block doubles one eq entry
//     (the hi bits' chain, scaled by alpha or beta) over 2^m gates in its
//     shared memory, both terms at once, and writes each gate's coefficient
//     by its type from the circuit's gate mask.
//   * gkr_phase1_stack -- [[w, G], [H, 1]], a thread a gate: two products and
//     one addition a gate.
//   * gkr_phase2_stack -- [[A2, wb + w], [M2 wb, w]]: eq(r_b, 2g) by the same
//     halves at the even indices only, then three more products a gate.
//
// Bound. The stacks: bytes. At the widest layer of a 2^20-input circuit (2^19
// gates) each writes 128 MB and reads 64 MB, against two or four products
// (272 multiply-adds each at W = 8) a gate. The wiring writes 32 MB and takes
// two products a gate (one a term): operations, by a little. The eq chains'
// depth at that layer (9 products on the hi bits, 10 levels with a barrier
// each) is a few microseconds a block.
//
// Plain C interface (loaded with ctypes): every function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for arguments it does not take). Challenges,
// scales, masks and w(r_b) are device buffers; p, n0 and one (R mod p) come by
// value.

#include <cstdint>
#include <cuda_runtime.h>

#include "gkr_tables.cuh"

namespace {

using gkr_tables::Consts;
using gkr_tables::kMaxTerms;
using gkr_tables::kSharedEntries;
using gkr_tables::kThreads;
using gkr_tables::W;

// blocks a grid-stride launch of the phase-1 stack takes at the most
constexpr long long kMaxStackBlocks = 1 << 16;

__global__ void __launch_bounds__(kThreads)
gkr_wiring_kernel(const gkr_tables::Wiring a, const Consts c) {
  __shared__ __align__(16) uint32_t table[kMaxTerms * kSharedEntries * W];
  const long long b = blockIdx.x;
  if ((int)threadIdx.x < a.q.terms)
    gkr_tables::seed_thread(table, a.q, a.scales, b, threadIdx.x, c);
  __syncthreads();
  for (int l = 0; l < a.q.m - 1; ++l) {
    gkr_tables::level_thread(table, a.q, l, threadIdx.x, blockDim.x, c);
    __syncthreads();
  }
  gkr_tables::wiring_last_thread(table, a, b, threadIdx.x, blockDim.x, c);
}

__global__ void __launch_bounds__(kThreads)
gkr_phase1_stack_kernel(uint32_t* __restrict__ stack, const uint32_t* __restrict__ coef_a,
                        const uint32_t* __restrict__ coef_m, const uint32_t* __restrict__ w,
                        long long n, const Consts c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n; g += stride)
    gkr_tables::phase1_gate(stack, coef_a, coef_m, w, n, g, c);
}

__global__ void __launch_bounds__(kThreads)
gkr_phase2_stack_kernel(const gkr_tables::Phase2 a, const Consts c) {
  __shared__ __align__(16) uint32_t table[kSharedEntries * W];
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) gkr_tables::seed_thread(table, a.q, nullptr, b, 0, c);
  __syncthreads();
  for (int l = 0; l < a.q.m - 1; ++l) {
    gkr_tables::level_thread(table, a.q, l, threadIdx.x, blockDim.x, c);
    __syncthreads();
  }
  gkr_tables::phase2_last_thread(table, a, b, threadIdx.x, blockDim.x, c);
}

Consts make_consts(const uint32_t* p, uint32_t n0, const uint32_t* one) {
  Consts c;
  for (int j = 0; j < W; ++j) {
    c.M.p[j] = p[j];
    c.one[j] = one[j];
  }
  c.M.n0 = n0;
  return c;
}

bool pow2(long long n) { return n >= 1 && (n & (n - 1)) == 0; }

int log2_of(long long n) {
  int k = 0;
  while ((1ll << k) < n) ++k;
  return k;
}

}  // namespace

extern "C" {

// rs: (terms, k, 8) challenges; scales: (terms, 8) or null (each term's seed
// is one); is_add: (n,) bytes, nonzero where gate g adds; coef_a, coef_m:
// (n, 8). 1 <= n <= 2^k.
int zk_gkr_wiring(const void* rs, const void* scales, int terms, int k, const void* is_add,
                  long long n, void* coef_a, void* coef_m, const uint32_t* p, uint32_t n0,
                  const uint32_t* one, void* stream) {
  if (terms < 1 || terms > kMaxTerms || k < 1 || k > 40 || n < 1 || n > (1ll << k)) return -1;
  gkr_tables::Wiring a;
  a.q = gkr_tables::make_eq((const uint32_t*)rs, k, terms);
  a.scales = (const uint32_t*)scales;
  a.is_add = (const uint8_t*)is_add;
  a.n = n;
  a.coef_a = (uint32_t*)coef_a;
  a.coef_m = (uint32_t*)coef_m;
  const long long blocks = gkr_tables::wiring_blocks(n, k);
  if (blocks > 0x7fffffffll) return -1;
  gkr_wiring_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, make_consts(p, n0, one));
  return (int)cudaGetLastError();
}

// coef_a, coef_m: (n, 8); w: (2n, 8); stack: (2, 2, 2n, 8). n >= 1.
int zk_gkr_phase1_stack(const void* coef_a, const void* coef_m, const void* w, long long n,
                        void* stack, const uint32_t* p, uint32_t n0, const uint32_t* one,
                        void* stream) {
  if (n < 1) return -1;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxStackBlocks) blocks = kMaxStackBlocks;
  gkr_phase1_stack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)stack, (const uint32_t*)coef_a, (const uint32_t*)coef_m, (const uint32_t*)w, n,
      make_consts(p, n0, one));
  return (int)cudaGetLastError();
}

// rs: (log2(2n), 8) phase 1's challenges; coef_a, coef_m: (n, 8); w: (2n, 8);
// wb: (8,); stack: (2, 2, 2n, 8). n a power of two.
int zk_gkr_phase2_stack(const void* rs, const void* coef_a, const void* coef_m, const void* w,
                        const void* wb, long long n, void* stack, const uint32_t* p, uint32_t n0,
                        const uint32_t* one, void* stream) {
  if (!pow2(n) || n > (1ll << 40)) return -1;
  const int k = log2_of(2 * n);
  gkr_tables::Phase2 a;
  a.q = gkr_tables::make_eq((const uint32_t*)rs, k, 1);
  a.coef_a = (const uint32_t*)coef_a;
  a.coef_m = (const uint32_t*)coef_m;
  a.w = (const uint32_t*)w;
  a.wb = (const uint32_t*)wb;
  a.n = n;
  a.stack = (uint32_t*)stack;
  const long long blocks = gkr_tables::phase2_blocks(n, k);
  if (blocks > 0x7fffffffll) return -1;
  gkr_phase2_stack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, make_consts(p, n0, one));
  return (int)cudaGetLastError();
}

}  // extern "C"
