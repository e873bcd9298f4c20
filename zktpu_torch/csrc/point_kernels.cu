// BLS12-381 G1 Jacobian point addition and doubling as CUDA kernels for Hopper
// (sm_90a).
//
// Two kernels, the counterparts of the two Pallas TPU kernels of
// zktpu/curve/pallas_point.py: point_add replaces _add_impl (:78), point_double
// replaces _double_impl (:117). Every group operation of the fixed-base comb,
// the Pippenger MSM and the KZG bases goes through one of them.
//
// A batch of points is three (B, 12) uint32 tables X, Y, Z of Montgomery words
// over Fq, element-major like every table of the package; infinity is Z == 0.
// One thread a lane, the grid over B, the ragged edge masked by `i < n`: any
// B >= 1, no padding with infinities. (The TPU kernels' limb-major (24, B)
// layout, 512-lane tile and width padding answer that chip's 128-lane registers
// and per-width compiles and have no counterpart.)
//
// Bound on this card: operations. An addition is 16 Montgomery products of
// W = 12 (2W^2 + W = 300 wide multiply-adds each) against 9 x 48 = 432 bytes
// moved; a doubling is 7 products against 288 bytes. The integer pipes take
// several times longer over the products than memory over the bytes.
// What the design does about it: nothing is recomputed and nothing is computed
// that is not stored -- the doubling that patches P == Q, which the TPU kernel
// pays for a whole tile, is a branch a thread here, taken only by lanes that
// really double; lanes with an infinite operand leave before the first
// product. What limits a thread is registers: six 12-word inputs, the 14-word
// CIOS accumulator and the live temporaries. The formula is ordered so that each
// coordinate is loaded right before its only use and dies with it (at most five
// field elements live between products), and the patching branches reload their
// operand from memory rather than hold it.
//
// Plain C interface (loaded with ctypes): each function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError(). Outputs must not alias inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int W = 12;
constexpr int kThreads = 128;

using Mod = zk::Modulus<W>;
typedef uint32_t Fe[W];

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) acc |= a[j];
  return acc == 0;
}

__device__ __forceinline__ void fe_dbl(Fe& out, const Fe& a, const Mod& m) {
  zk::add_mod<W>(out, a, a, m);
}

__device__ __forceinline__ void copy_point(const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ y,
                                           const uint32_t* __restrict__ z,
                                           uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                           uint32_t* __restrict__ oz) {
  Fe t;
  zk::load_words<W>(t, x);
  zk::store_words<W>(ox, t);
  zk::load_words<W>(t, y);
  zk::store_words<W>(oy, t);
  zk::load_words<W>(t, z);
  zk::store_words<W>(oz, t);
}

// dbl-2009-l (a = 0): A = X^2, B = Y^2, C = B^2, D = 2((X+B)^2 - A - C), E = 3A,
// X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ. Infinity (Z = 0) gives Z3 = 0.
// The pointers address one lane's 12 words of each coordinate.
__device__ __forceinline__ void jac_double(const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ y,
                                           const uint32_t* __restrict__ z,
                                           uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                           uint32_t* __restrict__ oz, const Mod& m) {
  Fe B, C;
  {
    Fe Y, Z;
    zk::load_words<W>(Y, y);
    zk::load_words<W>(Z, z);
    zk::mont_mul<W>(Z, Y, Z, m);
    fe_dbl(Z, Z, m);
    zk::store_words<W>(oz, Z);  // Z3 = 2YZ
    zk::mont_mul<W>(B, Y, Y, m);
  }
  zk::mont_mul<W>(C, B, B, m);
  Fe A, D;
  {
    Fe X;
    zk::load_words<W>(X, x);
    zk::mont_mul<W>(A, X, X, m);
    zk::add_mod<W>(X, X, B, m);   // X + B
    zk::mont_mul<W>(D, X, X, m);  // (X + B)^2
  }
  zk::sub_mod<W>(D, D, A, m);
  zk::sub_mod<W>(D, D, C, m);
  fe_dbl(D, D, m);
  // B is free from here: E = 3A
  fe_dbl(B, A, m);
  zk::add_mod<W>(B, B, A, m);
  // A is free: X3 = E^2 - 2D
  zk::mont_mul<W>(A, B, B, m);
  {
    Fe D2;
    fe_dbl(D2, D, m);
    zk::sub_mod<W>(A, A, D2, m);
  }
  zk::store_words<W>(ox, A);
  // Y3 = E(D - X3) - 8C
  zk::sub_mod<W>(D, D, A, m);
  zk::mont_mul<W>(D, B, D, m);
  fe_dbl(C, C, m);
  fe_dbl(C, C, m);
  fe_dbl(C, C, m);
  zk::sub_mod<W>(D, D, C, m);
  zk::store_words<W>(oy, D);
}

__global__ void __launch_bounds__(kThreads)
point_double_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n,
                    const Mod m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W;
  jac_double(x + o, y + o, z + o, ox + o, oy + o, oz + o, m);
}

// add-2007-bl, complete: Z1Z1 = Z1^2, Z2Z2 = Z2^2, U1 = X1 Z2Z2, U2 = X2 Z1Z1,
// S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1, H = U2 - U1, r = 2(S2 - S1), I = (2H)^2,
// J = H I, V = U1 I, X3 = r^2 - J - 2V, Y3 = r(V - X3) - 2 S1 J,
// Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H.
// Selection, in this order of precedence: P2 infinite -> P1 (also when both
// are); P1 infinite -> P2; H == 0 and r == 0 on finite operands (P1 == P2) ->
// the doubling of P1. P1 == -P2 (H == 0, r != 0) needs nothing: Z3 = 0.
__global__ void __launch_bounds__(kThreads)
point_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                 const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                 const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                 uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                 uint32_t* __restrict__ oz, long long n, const Mod m) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long o = i * W;

  Fe Z1Z1, Z2Z2, ZZ, S1, R;
  {
    Fe Z1, Z2;
    zk::load_words<W>(Z1, z1 + o);
    zk::load_words<W>(Z2, z2 + o);
    if (fe_is_zero(Z2)) {
      copy_point(x1 + o, y1 + o, z1 + o, ox + o, oy + o, oz + o);
      return;
    }
    if (fe_is_zero(Z1)) {
      copy_point(x2 + o, y2 + o, z2 + o, ox + o, oy + o, oz + o);
      return;
    }
    zk::mont_mul<W>(Z1Z1, Z1, Z1, m);
    zk::mont_mul<W>(Z2Z2, Z2, Z2, m);
    zk::add_mod<W>(ZZ, Z1, Z2, m);
    zk::mont_mul<W>(ZZ, ZZ, ZZ, m);
    zk::sub_mod<W>(ZZ, ZZ, Z1Z1, m);
    zk::sub_mod<W>(ZZ, ZZ, Z2Z2, m);  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
    Fe T;
    zk::mont_mul<W>(Z2, Z2, Z2Z2, m);  // Z2^3
    zk::load_words<W>(T, y1 + o);
    zk::mont_mul<W>(S1, T, Z2, m);
    zk::mont_mul<W>(Z1, Z1, Z1Z1, m);  // Z1^3
    zk::load_words<W>(T, y2 + o);
    zk::mont_mul<W>(R, T, Z1, m);      // S2
  }
  zk::sub_mod<W>(R, R, S1, m);
  fe_dbl(R, R, m);  // r = 2(S2 - S1)

  Fe U1, H;
  {
    Fe T;
    zk::load_words<W>(T, x1 + o);
    zk::mont_mul<W>(U1, T, Z2Z2, m);
    zk::load_words<W>(T, x2 + o);
    zk::mont_mul<W>(H, T, Z1Z1, m);  // U2
  }
  zk::sub_mod<W>(H, H, U1, m);

  if (fe_is_zero(H) && fe_is_zero(R)) {
    jac_double(x1 + o, y1 + o, z1 + o, ox + o, oy + o, oz + o, m);
    return;
  }

  zk::mont_mul<W>(ZZ, ZZ, H, m);
  zk::store_words<W>(oz + o, ZZ);  // Z3

  // Z1Z1, Z2Z2 and ZZ are free from here; reuse them as I, J, V
  Fe& I = Z1Z1;
  Fe& J = Z2Z2;
  Fe& V = ZZ;
  fe_dbl(I, H, m);
  zk::mont_mul<W>(I, I, I, m);
  zk::mont_mul<W>(J, H, I, m);
  zk::mont_mul<W>(V, U1, I, m);
  // X3 = r^2 - J - 2V (into H, which is free)
  zk::mont_mul<W>(H, R, R, m);
  zk::sub_mod<W>(H, H, J, m);
  fe_dbl(I, V, m);
  zk::sub_mod<W>(H, H, I, m);
  zk::store_words<W>(ox + o, H);
  // Y3 = r(V - X3) - 2 S1 J
  zk::sub_mod<W>(V, V, H, m);
  zk::mont_mul<W>(V, R, V, m);
  zk::mont_mul<W>(J, S1, J, m);
  fe_dbl(J, J, m);
  zk::sub_mod<W>(V, V, J, m);
  zk::store_words<W>(oy + o, V);
}

Mod make_modulus(const uint32_t* p_host, uint32_t n0) {
  Mod m;
  for (int j = 0; j < W; ++j) m.p[j] = p_host[j];
  m.n0 = n0;
  return m;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// every pointer: n x 12 words, 16-byte aligned; 1 <= n < 2^31
int zk_point_add(const void* x1, const void* y1, const void* z1, const void* x2, const void* y2,
                 const void* z2, void* ox, void* oy, void* oz, long long n, const uint32_t* p,
                 uint32_t n0, void* stream) {
  if (n < 1 || n >= (1LL << 31)) return -1;
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      make_modulus(p, n0));
  return (int)cudaGetLastError();
}

int zk_point_double(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
                    long long n, const uint32_t* p, uint32_t n0, void* stream) {
  if (n < 1 || n >= (1LL << 31)) return -1;
  point_double_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n, make_modulus(p, n0));
  return (int)cudaGetLastError();
}

}  // extern "C"
