// BLS12-381 Fq arithmetic and the G1 formulas of fq381.cuh spread over a
// group of cooperating lanes: the window combine's chain (msm_kernels.cu's
// horner kernel) on a group of lanes in place of one.
//
// A Horner chain is one long dependent sequence (240-252 doublings), and the
// proof has only some forty of them, so its time is the latency of one
// product after another, not the card's rate. Split across lanes, a product's
// dependent path is shorter. This is the technique of CGBN (Emmart and Weems,
// NVIDIA Labs), written here from scratch:
//
//   * An element is 12 words; lane l of the group holds words [L l, L l + L),
//     a digit of radix beta = 2^(32 L). The kernels take L = 2 on 6 of 8
//     lanes (lanes 6 and 7 hold zeros and stay zero); L = 3 on 4 lanes has
//     fewer, longer digit steps and was slower on every chain (PERF.md).
//   * A Montgomery product is digit-serial CIOS in radix beta: for each digit
//     B_i of b (fetched by __shfl_sync), every lane adds A_l B_i into its two
//     digits of the accumulator; lane 0 derives Q = T_0 (-p^-1) mod beta,
//     which is broadcast, and every lane adds Q P_l; the accumulator is then
//     shifted down a digit (a lane takes its upper digit plus the lower digit
//     of the lane above, and the small carry word of the lane below). The
//     multiplier M = sum Q_i beta^i is the unique M < R with a b + M p = 0 mod
//     R, so the result (a b + M p) / R is the same integer, lazy words and
//     all, as fq381::mul's word-serial one, in [0, 2p) for a, b < 2p.
//   * Carries between lanes (additions, subtractions, the product's last
//     normalisation) are resolved by warp votes: each lane's carry out
//     ("generate") and whether its digit is all ones ("propagate") are
//     balloted, and ((g << 1) + p) ^ p has the carry into each lane.
//   * add, sub, dbl work modulo 2p on [0, 2p) as fq381.cuh's do; canonical and
//     the zero tests likewise. Every condition the formulas branch on comes
//     from a ballot, so the group never diverges.
//
// Built with nvcc, a group is the first G lanes of a warp (a block of G
// threads). Built with a host C++ compiler (as tests/test_torch_msm_kernels.py
// does), a group is G fibers of one host thread that meet at a barrier for
// each shuffle and vote (warp.cuh), so the same code runs against the plain
// versions without a card.

#pragma once

#include <cstdint>

#include "fq381.cuh"
#include "warp.cuh"

namespace coop381 {

using namespace carry;
constexpr int W = fq381::W;

// -p^-1 mod 2^96, word by word: the digit of Q is T_0 times its low L words
FQ_HD constexpr uint32_t NP(int j) {
  return j == 0 ? 0xfffcfffdu : j == 1 ? 0x89f3fffcu : 0xd9d113e8u;
}

using warp::Group;
#ifndef __CUDACC__
using warp::Exchange;
#endif

// L words a lane: D lanes hold digits, the group is G lanes (a power of two)
template <int L>
struct Lanes {
  static constexpr int D = W / L;
  static constexpr int G = D <= 4 ? 4 : 8;
  static_assert(D * L == W && D <= 8, "a digit is 2 or 3 words");
  Group<G> g;
  bool active;  // lane < D
  uint32_t p[L], p2[L];  // this lane's digits of p and 2p
};

template <int L>
FQ_FN Lanes<L> make_lanes(Group<Lanes<L>::G> g) {
  Lanes<L> s;
  s.g = g;
  s.active = g.lane < (uint32_t)Lanes<L>::D;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int j = (int)g.lane * L + k;
    s.p[k] = s.active ? fq381::P(j) : 0u;
    s.p2[k] = s.active ? fq381::P2(j) : 0u;
  }
  return s;
}

template <int L>
using Fe = uint32_t[L];

// The carry (or borrow) into this lane, from each active lane's carry out
// (`gen`) and whether a carry in passes through it (`prop`); `top` gets the
// carry out of the top lane.
template <int L>
FQ_FN uint32_t resolve(const Lanes<L>& s, bool gen, bool prop, uint32_t& top) {
  const uint32_t g = s.g.ballot(gen && s.active);
  const uint32_t p = s.g.ballot(prop && s.active);
  const uint32_t x = (g << 1) + p;
  top = (x >> Lanes<L>::D) & 1u;
  return s.active ? ((x ^ p) >> s.g.lane) & 1u : 0u;
}

// out = a + b over the group; returns the carry out of the top
template <int L>
FQ_FN uint32_t add_words(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a, const Fe<L>& b) {
  uint32_t t[L];
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) t[k] = addc_cc(a[k], b[k]);
  const uint32_t cy = addc(0, 0);
  uint32_t ones = t[0];
#pragma unroll
  for (int k = 1; k < L; ++k) ones &= t[k];
  uint32_t top;
  const uint32_t cin = resolve(s, cy != 0, ones == 0xffffffffu, top);
  out[0] = add_cc(t[0], cin);
#pragma unroll
  for (int k = 1; k < L - 1; ++k) out[k] = addc_cc(t[k], 0);
  out[L - 1] = addc(t[L - 1], 0);
  return top;
}

// out = a - b over the group; returns the borrow out of the top
template <int L>
FQ_FN uint32_t sub_words(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a, const Fe<L>& b) {
  uint32_t t[L];
  t[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) t[k] = subc_cc(a[k], b[k]);
  const uint32_t borrow = subc(0, 0);
  uint32_t any = t[0];
#pragma unroll
  for (int k = 1; k < L; ++k) any |= t[k];
  uint32_t top;
  const uint32_t bin = resolve(s, borrow != 0, any == 0, top);
  out[0] = sub_cc(t[0], bin);
#pragma unroll
  for (int k = 1; k < L - 1; ++k) out[k] = subc_cc(t[k], 0);
  out[L - 1] = subc(t[L - 1], 0);
  return top;
}

template <int L>
FQ_FN void select(Fe<L>& out, bool first, const Fe<L>& a, const Fe<L>& b) {
#pragma unroll
  for (int k = 0; k < L; ++k) out[k] = first ? a[k] : b[k];
}

template <int L>
FQ_FN void copy(Fe<L>& out, const Fe<L>& a) {
#pragma unroll
  for (int k = 0; k < L; ++k) out[k] = a[k];
}

// s (< 4p) -> s mod 2p
template <int L>
FQ_FN void cond_sub_2p(const Lanes<L>& s, Fe<L>& out, const Fe<L>& v) {
  Fe<L> d;
  const uint32_t borrow = sub_words(s, d, v, s.p2);
  select(out, borrow != 0, v, d);
}

template <int L>
FQ_FN void add(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a, const Fe<L>& b) {
  Fe<L> t;
  add_words(s, t, a, b);
  cond_sub_2p(s, out, t);
}

template <int L>
FQ_FN void dbl(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a) {
  const uint32_t below = s.g.shfl(a[L - 1], (s.g.lane + Lanes<L>::G - 1) & (Lanes<L>::G - 1));
  Fe<L> t;
#pragma unroll
  for (int k = L - 1; k > 0; --k) t[k] = (a[k] << 1) | (a[k - 1] >> 31);
  t[0] = (a[0] << 1) | (s.g.lane > 0 && s.active ? below >> 31 : 0u);
  cond_sub_2p(s, out, t);
}

// a - b, + 2p where it borrows
template <int L>
FQ_FN void sub(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a, const Fe<L>& b) {
  Fe<L> d;
  if (sub_words(s, d, a, b)) {
    add_words(s, out, d, s.p2);
  } else {
    copy(out, d);
  }
}

// [0, 2p) -> [0, p)
template <int L>
FQ_FN void canonical(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a) {
  Fe<L> d;
  const uint32_t borrow = sub_words(s, d, a, s.p);
  select(out, borrow != 0, a, d);
}

template <int L>
FQ_FN bool is_zero(const Lanes<L>& s, const Fe<L>& a) {
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) any |= a[k];
  return s.g.ballot(any == 0) == Group<Lanes<L>::G>::kMask;
}

// a in [0, 2p) is 0 mod p: a == 0 or a == p
template <int L>
FQ_FN bool is_zero_lazy(const Lanes<L>& s, const Fe<L>& a) {
  uint32_t any = 0, diff = 0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    any |= a[k];
    diff |= a[k] ^ s.p[k];
  }
  constexpr uint32_t all = Group<Lanes<L>::G>::kMask;
  return s.g.ballot(any == 0) == all || s.g.ballot(diff == 0) == all;
}

// pr = a b, 2L words (one lane's digits)
template <int L>
FQ_FN void mul_wide(uint32_t (&pr)[2 * L], const Fe<L>& a, const Fe<L>& b) {
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) pr[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t cy = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t v = (uint64_t)a[i] * b[j] + pr[i + j] + cy;
      pr[i + j] = (uint32_t)v;
      cy = v >> 32;
    }
    pr[i + L] = (uint32_t)cy;
  }
}

// (lo, hi) += pr; returns the carry out
template <int L>
FQ_FN uint32_t acc_add(Fe<L>& lo, Fe<L>& hi, const uint32_t (&pr)[2 * L]) {
  lo[0] = add_cc(lo[0], pr[0]);
#pragma unroll
  for (int k = 1; k < L; ++k) lo[k] = addc_cc(lo[k], pr[k]);
#pragma unroll
  for (int k = 0; k < L; ++k) hi[k] = addc_cc(hi[k], pr[L + k]);
  return addc(0, 0);
}

// q = t (-p^-1) mod beta
template <int L>
FQ_FN void mont_q(Fe<L>& q, const Fe<L>& t) {
#pragma unroll
  for (int k = 0; k < L; ++k) q[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    uint64_t cy = 0;
#pragma unroll
    for (int j = 0; i + j < L; ++j) {
      const uint64_t v = (uint64_t)t[i] * NP(j) + q[i + j] + cy;
      q[i + j] = (uint32_t)v;
      cy = v >> 32;
    }
  }
}

// out = a b / R mod p, in [0, 2p) for a, b < 2p: the same integer as
// fq381::mul's. out may alias a or b.
template <int L>
FQ_FN void mul(const Lanes<L>& s, Fe<L>& out, const Fe<L>& a, const Fe<L>& b) {
  constexpr int D = Lanes<L>::D;
  constexpr int G = Lanes<L>::G;
  const uint32_t up = (s.g.lane + 1) & (G - 1), down = (s.g.lane + G - 1) & (G - 1);
  const bool has_up = s.g.lane + 1 < (uint32_t)D, has_down = s.g.lane > 0;
  Fe<L> bi[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = 0; k < L; ++k) bi[i][k] = s.g.shfl(b[k], i);
  }
  Fe<L> lo, hi;
#pragma unroll
  for (int k = 0; k < L; ++k) lo[k] = hi[k] = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    uint32_t pr[2 * L];
    mul_wide<L>(pr, a, bi[i]);
    uint32_t c = acc_add<L>(lo, hi, pr);
    Fe<L> q;
    mont_q<L>(q, lo);  // lane 0's is T_0's
#pragma unroll
    for (int k = 0; k < L; ++k) q[k] = s.g.shfl(q[k], 0);
    mul_wide<L>(pr, q, s.p);
    c += acc_add<L>(lo, hi, pr);  // lane 0's lo is now 0
    // divide by beta: digit l takes hi_l, lo_(l+1) and c_(l-1)
    Fe<L> next;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const uint32_t v = s.g.shfl(lo[k], up);
      next[k] = has_up ? v : 0u;
    }
    const uint32_t cv = s.g.shfl(c, down);
    const uint32_t cin = has_down ? cv : 0u;
    lo[0] = add_cc(hi[0], next[0]);
#pragma unroll
    for (int k = 1; k < L; ++k) lo[k] = addc_cc(hi[k], next[k]);
    uint32_t t = addc(0, 0);
    lo[0] = add_cc(lo[0], cin);
#pragma unroll
    for (int k = 1; k < L; ++k) lo[k] = addc_cc(lo[k], 0);
    t = addc(t, 0);
    hi[0] = t;
#pragma unroll
    for (int k = 1; k < L; ++k) hi[k] = 0;
  }
  // digit l = lo_l + hi_(l-1), the carries resolved by votes
  const uint32_t hv = s.g.shfl(hi[0], down);
  const uint32_t h = has_down ? hv : 0u;
  Fe<L> t;
  t[0] = add_cc(lo[0], h);
#pragma unroll
  for (int k = 1; k < L; ++k) t[k] = addc_cc(lo[k], 0);
  const uint32_t cy = addc(0, 0);
  uint32_t ones = t[0];
#pragma unroll
  for (int k = 1; k < L; ++k) ones &= t[k];
  uint32_t top;
  const uint32_t cin = resolve(s, cy != 0, ones == 0xffffffffu, top);
  out[0] = add_cc(t[0], cin);
#pragma unroll
  for (int k = 1; k < L - 1; ++k) out[k] = addc_cc(t[k], 0);
  out[L - 1] = addc(t[L - 1], 0);
}

// ----------------------------------------------------------------------
// a lane's words of a point coordinate
// ----------------------------------------------------------------------

template <int L>
FQ_FN void load(const Lanes<L>& s, Fe<L>& v, const uint32_t* __restrict__ src) {
#pragma unroll
  for (int k = 0; k < L; ++k) v[k] = s.active ? src[s.g.lane * L + k] : 0u;
}

// canonical form, then stored
template <int L>
FQ_FN void store(const Lanes<L>& s, uint32_t* __restrict__ dst, const Fe<L>& lazy) {
  Fe<L> v;
  canonical(s, v, lazy);
  if (s.active) {
#pragma unroll
    for (int k = 0; k < L; ++k) dst[s.g.lane * L + k] = v[k];
  }
}

// ----------------------------------------------------------------------
// the G1 formulas of fq381.cuh on the group: jac_double, and add_into with
// point_add_lane's selection and formulas
// ----------------------------------------------------------------------

template <int L>
FQ_FN void jac_double(const Lanes<L>& s, Fe<L>& X, Fe<L>& Y, Fe<L>& Z) {
  mul(s, Z, Y, Z);
  dbl(s, Z, Z);  // Z3
  Fe<L> B, C;
  mul(s, B, Y, Y);
  mul(s, C, B, B);
  mul(s, Y, X, X);  // A
  add(s, X, X, B);
  mul(s, X, X, X);  // (X + B)^2
  sub(s, X, X, Y);
  sub(s, X, X, C);
  dbl(s, X, X);  // D
  dbl(s, B, Y);
  add(s, B, B, Y);  // E = 3A
  dbl(s, C, C);
  dbl(s, C, C);
  dbl(s, C, C);  // 8C
  mul(s, Y, B, B);
  sub(s, Y, Y, X);
  sub(s, Y, Y, X);  // X3 = E^2 - 2D
  sub(s, X, X, Y);
  mul(s, X, B, X);
  sub(s, X, X, C);  // Y3 = E(D - X3) - 8C
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const uint32_t t = X[k];
    X[k] = Y[k];
    Y[k] = t;
  }
}

template <int L>
FQ_FN void canonical_point(const Lanes<L>& s, Fe<L>& X, Fe<L>& Y, Fe<L>& Z) {
  canonical(s, X, X);
  canonical(s, Y, Y);
  canonical(s, Z, Z);
}

// P1 += P2 in place, P1 canonical on the group, P2 canonical words in memory
template <int L>
FQ_FN void add_into(const Lanes<L>& s, Fe<L>& X, Fe<L>& Y, Fe<L>& Z,
                    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
                    const uint32_t* __restrict__ z2) {
  Fe<L> Z2;
  load(s, Z2, z2);
  if (is_zero(s, Z2)) return;
  if (is_zero(s, Z)) {
    load(s, X, x2);
    load(s, Y, y2);
    copy(Z, Z2);
    return;
  }
  Fe<L> Z1Z1, Z2Z2, ZZ, S1, R;
  mul(s, Z1Z1, Z, Z);
  mul(s, Z2Z2, Z2, Z2);
  add(s, ZZ, Z, Z2);
  mul(s, ZZ, ZZ, ZZ);
  sub(s, ZZ, ZZ, Z1Z1);
  sub(s, ZZ, ZZ, Z2Z2);
  mul(s, Z2, Z2, Z2Z2);  // Z2^3
  mul(s, S1, Y, Z2);
  mul(s, Z2, Z, Z1Z1);  // Z1^3
  load(s, R, y2);
  mul(s, R, R, Z2);  // S2
  sub(s, R, R, S1);
  dbl(s, R, R);  // r
  Fe<L> U1, H;
  mul(s, U1, X, Z2Z2);
  load(s, H, x2);
  mul(s, H, H, Z1Z1);  // U2
  sub(s, H, H, U1);
  if (is_zero_lazy(s, H) && is_zero_lazy(s, R)) {
    jac_double(s, X, Y, Z);
    canonical_point(s, X, Y, Z);
    return;
  }
  mul(s, Z, ZZ, H);  // Z3
  Fe<L>& I = Z1Z1;
  Fe<L>& J = Z2Z2;
  Fe<L>& V = ZZ;
  dbl(s, I, H);
  mul(s, I, I, I);
  mul(s, J, H, I);
  mul(s, V, U1, I);
  mul(s, H, R, R);
  sub(s, H, H, J);
  sub(s, H, H, V);
  sub(s, H, H, V);  // X3
  sub(s, V, V, H);
  mul(s, V, R, V);
  mul(s, J, S1, J);
  dbl(s, J, J);
  sub(s, V, V, J);  // Y3
  copy(X, H);
  copy(Y, V);
  canonical_point(s, X, Y, Z);
}

// The window combine of one segment (zktpu/msm/pippenger.py:_horner_multi,
// :448) on the group: acc = R_{W-1}, then acc = 2^c acc + R_w for w = W - 2
// down to 0, where R_w is window w of the segment's table (x, y, z: `windows`
// points of W words each, canonical). The point stays on the group's
// registers and is made canonical after its c doublings and after each
// addition, as between two launches of the point kernels, so the words are
// those of that chain of launches, lanes of no meaning (P == -Q) included
template <int L>
FQ_FN void horner_group(const Lanes<L>& s, const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y, const uint32_t* __restrict__ z,
                        int windows, int c, uint32_t* __restrict__ ox,
                        uint32_t* __restrict__ oy, uint32_t* __restrict__ oz) {
  Fe<L> X, Y, Z;
  const long long top = (long long)(windows - 1) * W;
  load(s, X, x + top);
  load(s, Y, y + top);
  load(s, Z, z + top);
  for (int w = windows - 2; w >= 0; --w) {
    for (int t = 0; t < c; ++t) jac_double(s, X, Y, Z);
    canonical_point(s, X, Y, Z);
    const long long o = (long long)w * W;
    add_into(s, X, Y, Z, x + o, y + o, z + o);
  }
  store(s, ox, X);
  store(s, oy, Y);
  store(s, oz, Z);
}

}  // namespace coop381
