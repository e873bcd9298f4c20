// BLS12-381 Fq arithmetic on PTX carry chains, and the G1 Jacobian formulas
// built on it: the core of the two point kernels (point_kernels.cu).
//
// What holds a 12-word product back on this card is instruction count, not
// bytes: field.cuh accumulates in emulated 64-bit C++, where every
// (uint64_t)a*b + t + c becomes a wide multiply and 64-bit adds, and every
// product ends in a full conditional subtraction. Here:
//
//   * Products run on the integer pipe's carry flag: mad.lo.cc / madc.hi.cc /
//     addc.cc in inline PTX, about one instruction per 32-bit multiply-add.
//     A row a * b_i is split into the products of the even words of `a` and
//     those of the odd words, two accumulators `ev` and `od` (od one word up),
//     so each row is two independent carry chains of (lo, hi) pairs that never
//     overlap; the division by 2^32 of each CIOS step is a renaming of the two
//     accumulators, folded into the next row's chain.
//   * Squarings form each cross product once (W(W-1)/2 of them, doubled by a
//     funnel shift), add the diagonal, then reduce the 24-word square.
//   * Reduction is lazy. p < 2^381 and R = 2^384, so for a, b < 2p the CIOS
//     output (a b + m p) / R stays below 4p^2/R + p < 2p: no product ends in a
//     subtraction. add, sub and dbl work modulo 2p on values in [0, 2p). A value
//     is made canonical (< p) only where it is stored, or where it is tested
//     for zero (a lazy 0 may be p).
//
// Tensor cores do no 32-bit integer products and TMA buys nothing for one
// thread streaming 48-byte coordinates, so the design is about instructions,
// registers and occupancy.
//
// Inputs from memory must be canonical (< p), as every producer of the package
// leaves them. The modulus is compiled in (BLS12-381 Fq only); the launchers
// check that the caller's modulus is this one.
//
// The primitives, one PTX instruction each, are carry.cuh's, shared with
// mont.cuh: the carry flag passes between consecutive asm statements, and no
// code between two of them writes the flag (only .cc instructions do, and only
// these primitives emit them). Built without CUDA (a host C++ compiler, as the
// CPU tests do), the primitives emulate the instructions on a thread-local
// flag, so the same arithmetic can be held against the plain PyTorch version
// without a card.

#pragma once

#include <cstdint>

#include "carry.cuh"

#ifdef __CUDACC__
#define FQ_FN __device__ __forceinline__
#define FQ_HD __host__ __device__ __forceinline__
#else
#define FQ_FN inline
#define FQ_HD inline
#endif

namespace fq381 {

constexpr int W = 12;
typedef uint32_t Fe[W];

// p, 2p and n0 = -p^-1 mod 2^32, word by word (constant after unrolling)
FQ_HD constexpr uint32_t P(int j) {
  return j == 0 ? 0xffffaaabu : j == 1 ? 0xb9feffffu : j == 2 ? 0xb153ffffu
       : j == 3 ? 0x1eabfffeu : j == 4 ? 0xf6b0f624u : j == 5 ? 0x6730d2a0u
       : j == 6 ? 0xf38512bfu : j == 7 ? 0x64774b84u : j == 8 ? 0x434bacd7u
       : j == 9 ? 0x4b1ba7b6u : j == 10 ? 0x397fe69au : 0x1a0111eau;
}
FQ_HD constexpr uint32_t P2(int j) {
  return j == 0 ? 0xffff5556u : j == 1 ? 0x73fdffffu : j == 2 ? 0x62a7ffffu
       : j == 3 ? 0x3d57fffdu : j == 4 ? 0xed61ec48u : j == 5 ? 0xce61a541u
       : j == 6 ? 0xe70a257eu : j == 7 ? 0xc8ee9709u : j == 8 ? 0x869759aeu
       : j == 9 ? 0x96374f6cu : j == 10 ? 0x72ffcd34u : 0x340223d4u;
}
constexpr uint32_t N0 = 0xfffcfffdu;
// 1 in Montgomery form, R mod p = 2^384 mod p: the Y of infinity (0, 1, 0)
FQ_HD constexpr uint32_t ONE(int j) {
  return j == 0 ? 0x0002fffdu : j == 1 ? 0x76090000u : j == 2 ? 0xc40c0002u
       : j == 3 ? 0xebf4000bu : j == 4 ? 0x53c758bau : j == 5 ? 0x5f489857u
       : j == 6 ? 0x70525745u : j == 7 ? 0x77ce5853u : j == 8 ? 0xa256ec6du
       : j == 9 ? 0x5c071a97u : j == 10 ? 0xfa80e493u : 0x15f65ec3u;
}

// the carry-flag primitives (mad_lo_cc, addc, ..., and their host emulation)
using namespace carry;

// ----------------------------------------------------------------------
// Montgomery product and square, output in [0, 2p) for inputs in [0, 2p)
// ----------------------------------------------------------------------

// acc += m * (p's even words), or its odd words (od is one word up): one chain
// that starts fresh and leaves its carry in the flag.
template <int Off>
FQ_FN void mad_p(uint32_t (&acc)[W], uint32_t m) {
  acc[0] = mad_lo_cc(P(Off), m, acc[0]);
  acc[1] = madc_hi_cc(P(Off), m, acc[1]);
#pragma unroll
  for (int j = 2; j < W; j += 2) {
    acc[j] = madc_lo_cc(P(j + Off), m, acc[j]);
    acc[j + 1] = madc_hi_cc(P(j + Off), m, acc[j + 1]);
  }
}

// One CIOS reduction step on (ev + 2^32 od) with ev[0] the lowest word: add
// m p with m = ev[0] n0, which clears ev[0]; ev's carry goes to od's top.
FQ_FN void reduce_step(uint32_t (&ev)[W], uint32_t (&od)[W]) {
  const uint32_t m = ev[0] * N0;
  mad_p<1>(od, m);
  mad_p<0>(ev, m);
  od[W - 1] = addc(od[W - 1], 0);
}

// (ev, od) hold t = ev + 2^32 od with ev[0] == 0. Roles swap: od becomes the
// low accumulator E of t / 2^32 and ev, shifted down two words, the high one
// O; ev[1] is added into E[0] and its carry enters O's chain, which adds
// a's odd words times bi. Then E += a's even words times bi.
FQ_FN void mul_row(uint32_t (&E)[W], uint32_t (&O)[W], const Fe& a, uint32_t bi) {
  E[0] = add_cc(E[0], O[1]);
#pragma unroll
  for (int j = 0; j < W - 2; j += 2) {
    O[j] = madc_lo_cc(a[j + 1], bi, O[j + 2]);
    O[j + 1] = madc_hi_cc(a[j + 1], bi, O[j + 3]);
  }
  O[W - 2] = madc_lo_cc(a[W - 1], bi, 0);
  O[W - 1] = madc_hi(a[W - 1], bi, 0);
  E[0] = mad_lo_cc(a[0], bi, E[0]);
  E[1] = madc_hi_cc(a[0], bi, E[1]);
#pragma unroll
  for (int j = 2; j < W; j += 2) {
    E[j] = madc_lo_cc(a[j], bi, E[j]);
    E[j + 1] = madc_hi_cc(a[j], bi, E[j + 1]);
  }
  O[W - 1] = addc(O[W - 1], 0);
}

// A reduction step with no product row, on (ev, od) after a step as in
// mul_row: E[0] += O[1] carries into O's chain (O shifted down two words),
// which adds m p's odd words; then E += m p's even words.
FQ_FN void redc_row(uint32_t (&E)[W], uint32_t (&O)[W]) {
  const uint32_t m = (E[0] + O[1]) * N0;
  E[0] = add_cc(E[0], O[1]);
#pragma unroll
  for (int j = 0; j < W - 2; j += 2) {
    O[j] = madc_lo_cc(P(j + 1), m, O[j + 2]);
    O[j + 1] = madc_hi_cc(P(j + 1), m, O[j + 3]);
  }
  O[W - 2] = madc_lo_cc(P(W - 1), m, 0);
  O[W - 1] = madc_hi(P(W - 1), m, 0);
  mad_p<0>(E, m);
  O[W - 1] = addc(O[W - 1], 0);
}

// out = (ev + 2^32 od) / 2^32 with ev[0] == 0
FQ_FN void merge(Fe& out, const uint32_t (&ev)[W], const uint32_t (&od)[W]) {
  out[0] = add_cc(od[0], ev[1]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) out[j] = addc_cc(od[j], ev[j + 1]);
  out[W - 1] = addc(od[W - 1], 0);
}

// out = a b / R mod p, in [0, 2p) for a, b < 2p. out may alias a or b.
FQ_FN void mul(Fe& out, const Fe& a, const Fe& b) {
  uint32_t ev[W], od[W];
  const uint32_t b0 = b[0];
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    ev[j] = a[j] * b0;
    ev[j + 1] = mul_hi(a[j], b0);
    od[j] = a[j + 1] * b0;
    od[j + 1] = mul_hi(a[j + 1], b0);
  }
  reduce_step(ev, od);
#pragma unroll
  for (int i = 1; i < W; i += 2) {
    mul_row(od, ev, a, b[i]);
    reduce_step(od, ev);
    if (i + 1 < W) {
      mul_row(ev, od, a, b[i + 1]);
      reduce_step(ev, od);
    }
  }
  merge(out, od, ev);
}

// out = a^2 / R mod p, in [0, 2p) for a < 2p. out may alias a.
FQ_FN void sqr(Fe& out, const Fe& a) {
  // cross products c = sum_{i<j} a_i a_j 2^(32(i+j)), row by row. Row i has
  // two chains of non-overlapping (lo, hi) pairs: j - i odd and j - i even.
  // The one that ends lower runs first and leaves its carry in word i + W,
  // which no earlier row reached; the other ends in that word.
  uint32_t c[2 * W];
#pragma unroll
  for (int k = 0; k < 2 * W; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int top_parity = (W - 1 - i) & 1;  // parity of j - i of the last pair
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int parity = pass == 0 ? 1 - top_parity : top_parity;
      const int j0 = i + 2 - parity;  // first j with (j - i) & 1 == parity
      if (j0 > W - 1) continue;
#pragma unroll
      for (int j = j0; j < W; j += 2) {
        const int k = i + j;
        c[k] = j == j0 ? mad_lo_cc(a[i], a[j], c[k]) : madc_lo_cc(a[i], a[j], c[k]);
        if (pass == 1 && j == W - 1) {
          c[k + 1] = madc_hi(a[i], a[j], c[k + 1]);
        } else {
          c[k + 1] = madc_hi_cc(a[i], a[j], c[k + 1]);
        }
      }
      if (pass == 0) c[i + W] = addc(c[i + W], 0);
    }
  }
  // t = 2 c + sum a_i^2 2^(64 i): c[0] and c[2W - 1] are 0
  uint32_t t[2 * W];
  t[0] = 0;
#pragma unroll
  for (int k = 1; k < 2 * W; ++k) t[k] = (c[k] << 1) | (c[k - 1] >> 31);
  t[0] = mad_lo_cc(a[0], a[0], t[0]);
  t[1] = madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < W - 1; ++i) {
    t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[2 * W - 2] = madc_lo_cc(a[W - 1], a[W - 1], t[2 * W - 2]);
  t[2 * W - 1] = madc_hi(a[W - 1], a[W - 1], t[2 * W - 1]);

  // REDC of the low half, then + the high half: (t_lo + m p) / R <= p and
  // t_hi < 4p^2 / R < p / 2
  uint32_t ev[W], od[W];
#pragma unroll
  for (int j = 0; j < W; ++j) ev[j] = t[j];
  {
    const uint32_t m = ev[0] * N0;
#pragma unroll
    for (int j = 0; j < W; j += 2) {
      od[j] = P(j + 1) * m;
      od[j + 1] = mul_hi(P(j + 1), m);
    }
    mad_p<0>(ev, m);
    od[W - 1] = addc(od[W - 1], 0);
  }
#pragma unroll
  for (int i = 1; i < W; i += 2) {
    redc_row(od, ev);
    if (i + 1 < W) redc_row(ev, od);
  }
  // W - 1 is odd: the low accumulator is od
  Fe r;
  merge(r, od, ev);
  out[0] = add_cc(r[0], t[W]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) out[j] = addc_cc(r[j], t[W + j]);
  out[W - 1] = addc(r[W - 1], t[2 * W - 1]);
}

// ----------------------------------------------------------------------
// lazy add, sub, dbl (modulo 2p on [0, 2p)), canonical form, zero test
// ----------------------------------------------------------------------

// s (< 4p) -> s mod 2p
FQ_FN void cond_sub_2p(Fe& out, const Fe& s) {
  Fe d;
  d[0] = sub_cc(s[0], P2(0));
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(s[j], P2(j));
  const uint32_t borrow = subc(0, 0);  // all ones when s < 2p
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = borrow ? s[j] : d[j];
}

FQ_FN void add(Fe& out, const Fe& a, const Fe& b) {
  Fe s;
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) s[j] = addc_cc(a[j], b[j]);
  s[W - 1] = addc(a[W - 1], b[W - 1]);
  cond_sub_2p(out, s);
}

FQ_FN void dbl(Fe& out, const Fe& a) {
  Fe s;
#pragma unroll
  for (int j = W - 1; j > 0; --j) s[j] = (a[j] << 1) | (a[j - 1] >> 31);
  s[0] = a[0] << 1;
  cond_sub_2p(out, s);
}

// a - b, + 2p where it borrows
FQ_FN void sub(Fe& out, const Fe& a, const Fe& b) {
  Fe d;
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0, 0);
  out[0] = add_cc(d[0], P2(0) & mask);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) out[j] = addc_cc(d[j], P2(j) & mask);
  out[W - 1] = addc(d[W - 1], P2(W - 1) & mask);
}

// [0, 2p) -> [0, p)
FQ_FN void canonical(Fe& out, const Fe& a) {
  Fe d;
  d[0] = sub_cc(a[0], P(0));
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(a[j], P(j));
  const uint32_t borrow = subc(0, 0);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = borrow ? a[j] : d[j];
}

// raw words all zero (a canonical value is 0)
FQ_FN bool is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) acc |= a[j];
  return acc == 0;
}

// a in [0, 2p) is 0 mod p: a == 0 or a == p
FQ_FN bool is_zero_lazy(const Fe& a) {
  uint32_t zero = 0, is_p = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    zero |= a[j];
    is_p |= a[j] ^ P(j);
  }
  return zero == 0 || is_p == 0;
}

// ----------------------------------------------------------------------
// element loads and stores: 16-byte vectors (every element is 16-byte aligned)
// ----------------------------------------------------------------------

FQ_FN void load(Fe& x, const uint32_t* __restrict__ src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const uint4 q = v[k];
    x[4 * k + 0] = q.x;
    x[4 * k + 1] = q.y;
    x[4 * k + 2] = q.z;
    x[4 * k + 3] = q.w;
  }
}

// canonical form, then stored
FQ_FN void store(uint32_t* __restrict__ dst, const Fe& lazy) {
  Fe x;
  canonical(x, lazy);
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    v[k] = uint4{x[4 * k + 0], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]};
  }
}

FQ_FN void copy_words(uint32_t* __restrict__ dst, const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) d[k] = s[k];
}

// ----------------------------------------------------------------------
// G1 Jacobian formulas (a = 0): the field values of the plain versions, so
// the same canonical words
// ----------------------------------------------------------------------

// dbl-2009-l in place on lazy coordinates: A = X^2, B = Y^2, C = B^2,
// D = 2((X+B)^2 - A - C), E = 3A, X3 = E^2 - 2D, Y3 = E(D - X3) - 8C, Z3 = 2YZ.
// Infinity (Z = 0) gives Z3 = 0.
FQ_FN void jac_double(Fe& X, Fe& Y, Fe& Z) {
  mul(Z, Y, Z);
  dbl(Z, Z);  // Z3
  Fe B, C;
  sqr(B, Y);
  sqr(C, B);
  sqr(Y, X);  // A, in Y's registers
  add(X, X, B);
  sqr(X, X);  // (X + B)^2
  sub(X, X, Y);
  sub(X, X, C);
  dbl(X, X);  // D
  dbl(B, Y);
  add(B, B, Y);  // E = 3A
  dbl(C, C);
  dbl(C, C);
  dbl(C, C);  // 8C
  sqr(Y, B);
  sub(Y, Y, X);
  sub(Y, Y, X);  // X3 = E^2 - 2D
  sub(X, X, Y);
  mul(X, B, X);
  sub(X, X, C);  // Y3 = E(D - X3) - 8C
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint32_t t = X[j];
    X[j] = Y[j];
    Y[j] = t;
  }
}

// One lane doubled `times` times (>= 1): one load, the doublings in
// registers, one store.
FQ_FN void point_double_lane(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                             const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
                             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int times) {
  Fe X, Y, Z;
  load(X, x);
  load(Y, y);
  load(Z, z);
  for (int t = 0; t < times; ++t) jac_double(X, Y, Z);
  store(ox, X);
  store(oy, Y);
  store(oz, Z);
}

// add-2007-bl, complete: Z1Z1 = Z1^2, Z2Z2 = Z2^2, U1 = X1 Z2Z2, U2 = X2 Z1Z1,
// S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1, H = U2 - U1, r = 2(S2 - S1), I = (2H)^2,
// J = H I, V = U1 I, X3 = r^2 - J - 2V, Y3 = r(V - X3) - 2 S1 J,
// Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H.
// Selection, in this order of precedence: P2 infinite -> P1's words (also when
// both are); P1 infinite -> P2's; H == 0 and r == 0 on finite operands
// (P1 == P2) -> the doubling of P1. P1 == -P2 (H == 0, r != 0) needs nothing:
// Z3 = 0. Each coordinate is loaded right before its only use; at most five
// field elements live between products.
FQ_FN void point_add_lane(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                          const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                          const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz) {
  Fe Z1Z1, Z2Z2, ZZ, S1, R;
  {
    Fe Z1, Z2;
    load(Z1, z1);
    load(Z2, z2);
    if (is_zero(Z2)) {
      copy_words(ox, x1);
      copy_words(oy, y1);
      copy_words(oz, z1);
      return;
    }
    if (is_zero(Z1)) {
      copy_words(ox, x2);
      copy_words(oy, y2);
      copy_words(oz, z2);
      return;
    }
    sqr(Z1Z1, Z1);
    sqr(Z2Z2, Z2);
    add(ZZ, Z1, Z2);
    sqr(ZZ, ZZ);
    sub(ZZ, ZZ, Z1Z1);
    sub(ZZ, ZZ, Z2Z2);  // (Z1 + Z2)^2 - Z1Z1 - Z2Z2
    Fe T;
    mul(Z2, Z2, Z2Z2);  // Z2^3
    load(T, y1);
    mul(S1, T, Z2);
    mul(Z1, Z1, Z1Z1);  // Z1^3
    load(T, y2);
    mul(R, T, Z1);  // S2
  }
  sub(R, R, S1);
  dbl(R, R);  // r

  Fe U1, H;
  {
    Fe T;
    load(T, x1);
    mul(U1, T, Z2Z2);
    load(T, x2);
    mul(H, T, Z1Z1);  // U2
  }
  sub(H, H, U1);

  if (is_zero_lazy(H) && is_zero_lazy(R)) {
    point_double_lane(x1, y1, z1, ox, oy, oz, 1);
    return;
  }

  mul(ZZ, ZZ, H);
  store(oz, ZZ);  // Z3

  // Z1Z1, Z2Z2 and ZZ are free from here: I, J, V
  Fe& I = Z1Z1;
  Fe& J = Z2Z2;
  Fe& V = ZZ;
  dbl(I, H);
  sqr(I, I);
  mul(J, H, I);
  mul(V, U1, I);
  sqr(H, R);
  sub(H, H, J);
  sub(H, H, V);
  sub(H, H, V);  // X3 = r^2 - J - 2V
  store(ox, H);
  sub(V, V, H);
  mul(V, R, V);
  mul(J, S1, J);
  dbl(J, J);
  sub(V, V, J);  // Y3 = r(V - X3) - 2 S1 J
  store(oy, V);
}

}  // namespace fq381
