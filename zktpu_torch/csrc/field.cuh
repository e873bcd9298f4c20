// Prime-field arithmetic on W little-endian 32-bit words held in registers.
//
// The one place every CUDA kernel of the package gets its arithmetic from: the
// counterpart of zktpu/field/limb_major.py (add, sub, mont_mul at :102-143),
// which plays the same part for the Pallas kernels. The TPU version works on
// 16-bit digits in uint32 lanes with delayed carries, because that chip has no
// 64-bit integer path. This card multiplies 32x32->64 natively, so an element is
// W = 8 words (256-bit fields) or W = 12 (BLS12-381 Fq), one element per thread,
// every loop unrolled so the words stay in registers, and carries are the high
// half of a 64-bit sum. The Montgomery radix R = 2^(32 W) is the same number as
// the reference's 2^(16 N), so values agree with it bit for bit.
//
// Operands need not be reduced: mont_mul(a, b) is exact for any a < R with
// b < p (the CIOS sum stays below 2p and one conditional subtraction finishes).
//
// The modulus and n0 = -p^-1 mod 2^32 are passed to each kernel by value in a
// Modulus<W>, so they sit in the kernel's constant bank.

#pragma once

#include <cstdint>

namespace zk {

template <int W>
struct Modulus {
  uint32_t p[W];
  uint32_t n0;
};

// Element loads and stores as 16-byte vectors (W is a multiple of 4 and every
// element starts on a 16-byte boundary; the wrappers check the base pointer).
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&x)[W], const uint32_t* __restrict__ src) {
  static_assert(W % 4 == 0, "elements are moved as uint4 vectors");
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    uint4 q = v[k];
    x[4 * k + 0] = q.x;
    x[4 * k + 1] = q.y;
    x[4 * k + 2] = q.z;
    x[4 * k + 3] = q.w;
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, const uint32_t (&x)[W]) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    v[k] = make_uint4(x[4 * k + 0], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  }
}

// t (< 2p, `extra` = the overflow bit 2^(32 W)) -> [0, p).
template <int W>
__device__ __forceinline__ void cond_sub_p(uint32_t (&t)[W], uint32_t extra, const Modulus<W>& m) {
  uint32_t d[W];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t v = (uint64_t)t[j] - m.p[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  const bool take = (extra != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = take ? d[j] : t[j];
}

// out = a + b mod p (a + b < 2p).
template <int W>
__device__ __forceinline__ void add_mod(uint32_t (&out)[W], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W], const Modulus<W>& m) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    out[j] = (uint32_t)v;
    c = v >> 32;
  }
  cond_sub_p<W>(out, (uint32_t)c, m);
}

// out = a - b mod p: on a borrow, p is added back mod 2^(32 W).
template <int W>
__device__ __forceinline__ void sub_mod(uint32_t (&out)[W], const uint32_t (&a)[W],
                                        const uint32_t (&b)[W], const Modulus<W>& m) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    out[j] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint64_t v = (uint64_t)out[j] + (borrow ? m.p[j] : 0u) + c;
    out[j] = (uint32_t)v;
    c = v >> 32;
  }
}

// out = a * b * R^-1 mod p: CIOS, one word of `a` per outer iteration.
// t[j] + a_i * b_j + carry <= (2^32 - 1) + (2^32 - 1)^2 + (2^32 - 1) = 2^64 - 1,
// so each step is exact in 64 bits.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t (&out)[W], const uint32_t (&a)[W],
                                         const uint32_t (&b)[W], const Modulus<W>& m) {
  uint32_t t[W + 2];
#pragma unroll
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t v = (uint64_t)a[i] * b[j] + t[j] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    uint64_t v = (uint64_t)t[W] + c;
    t[W] = (uint32_t)v;
    t[W + 1] = (uint32_t)(v >> 32);

    const uint32_t q = t[0] * m.n0;
    v = (uint64_t)q * m.p[0] + t[0];
    c = v >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      v = (uint64_t)q * m.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)v;
      c = v >> 32;
    }
    v = (uint64_t)t[W] + c;
    t[W - 1] = (uint32_t)v;
    t[W] = t[W + 1] + (uint32_t)(v >> 32);
  }
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = t[j];
  cond_sub_p<W>(out, t[W], m);
}

// out = a + r * (b - a): the fold of one multilinear variable at r.
template <int W>
__device__ __forceinline__ void lerp(uint32_t (&out)[W], const uint32_t (&a)[W],
                                     const uint32_t (&b)[W], const uint32_t (&r)[W],
                                     const Modulus<W>& m) {
  uint32_t d[W], prod[W];
  sub_mod<W>(d, b, a, m);
  mont_mul<W>(prod, r, d, m);
  add_mod<W>(out, a, prod, m);
}

}  // namespace zk
