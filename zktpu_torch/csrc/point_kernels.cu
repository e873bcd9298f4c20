// BLS12-381 G1 Jacobian point addition and doubling as CUDA kernels for Hopper
// (sm_90a).
//
// Two kernels, the counterparts of the two Pallas TPU kernels of
// zktpu/curve/pallas_point.py: point_add replaces _add_impl (:78), point_double
// replaces _double_impl (:117), and with a repeat count also the
// fori_loop(0, c, point_double_px) of zktpu/msm/pippenger.py's window combine.
// Every group operation of the fixed-base comb, the Pippenger MSM and the KZG
// bases goes through one of them.
//
// A batch of points is three (B, 12) uint32 tables X, Y, Z of Montgomery words
// over Fq, element-major like every table of the package; infinity is Z == 0.
// One thread a lane, the grid over B, the ragged edge masked by `i < n`: any
// B >= 1, no padding with infinities. (The TPU kernels' limb-major (24, B)
// layout, 512-lane tile and width padding answer that chip's 128-lane registers
// and per-width compiles and have no counterpart.)
//
// Bound on this card: operations. An addition is 11 Montgomery products and
// 5 squarings of W = 12 words against 9 x 48 = 432 bytes moved; a doubling is
// 2 products and 5 squarings against 288 bytes. In 32-bit operations (a
// 32x32->64 multiply-add counts as two) a product is 2(2W^2 + W) = 600, a
// squaring W(W + 1) for the square and W(2W + 1) for the reduction, 456.
// What the design does about it (fq381.cuh): products on PTX carry chains,
// about one instruction a counted multiply-add; squarings form each cross
// product once; reduction is lazy (values in [0, 2p), canonical only when
// stored or tested for zero); at most five field elements live between
// products. Registers: capped at 128 (__launch_bounds__(128, 4), 16 warps an
// SM) the allocator spills in both kernels and they run slower at 2^20 lanes;
// capped at 168 (three blocks an SM, 12 warps) they spill nothing (PERF.md
// section 6 has the measurements). Nothing is computed that is not stored:
// lanes with an infinite operand leave before the first product, and only
// lanes with P == Q take the doubling branch.
// point_double runs `times` doublings on the lane in registers between one
// load and one store, so a Horner window of c doublings is one launch.
//
// Plain C interface (loaded with ctypes): each function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (-1 for a bad size or count, -2 for a modulus other than
// BLS12-381 Fq's). Outputs must not alias inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq381.cuh"

namespace {

constexpr int W = fq381::W;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;  // 168 registers a thread at most: no spill

__global__ void __launch_bounds__(kThreads, kMinBlocks)
point_double_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n,
                    int times) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W;
  fq381::point_double_lane(x + o, y + o, z + o, ox + o, oy + o, oz + o, times);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
point_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                 const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                 uint32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W;
  fq381::point_add_lane(x1 + o, y1 + o, z1 + o, x2 + o, y2 + o, z2 + o, ox + o, oy + o, oz + o);
}

bool is_fq381(const uint32_t* p_host, uint32_t n0) {
  for (int j = 0; j < W; ++j) {
    if (p_host[j] != fq381::P(j)) return false;
  }
  return n0 == fq381::N0;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// every pointer: n x 12 words, 16-byte aligned; 1 <= n < 2^31
int zk_point_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                 const void* z2, void* ox, void* oy, void* oz, long long n, const uint32_t* p,
                 uint32_t n0, void* stream) {
  if (n < 1 || n >= (1LL << 31)) return -1;
  if (!is_fq381(p, n0)) return -2;
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

// each lane doubled `times` >= 1 times
int zk_point_double(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                    long long n, int times, const uint32_t* p, uint32_t n0, void* stream) {
  if (n < 1 || n >= (1LL << 31) || times < 1) return -1;
  if (!is_fq381(p, n0)) return -2;
  point_double_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n, times);
  return (int)cudaGetLastError();
}

}  // extern "C"
