// The work of the GKR layer-table kernels (gkr_tables_kernels.cu): every table
// a lazy GKR layer builds before and between its two sumcheck phases, each
// written once, in its final layout.
//
// Eq tables by halves. eq(r, x) over k index bits, challenge 0 on the most
// significant bit, is the product over the bits of (1 - r_j) or r_j. An index
// splits as x = hi 2^m + lo with m = lo_bits(k) = min(ceil(k / 2), 10) low
// bits: a block takes one hi, 2^m consecutive indices. Its first threads
// (one a term) take the hi bits' factors in a chain of products on their own
// seed (seed_thread): the scale of the term (alpha, beta), or one. The block
// then doubles that one entry over the lo bits in its shared memory, a level a
// challenge, a barrier between levels (level_thread), and the last level goes
// straight into the kernel's output (eq_last): the block's eq entries are
// never stored. A level's children are x r and x - x r = x (1 - r): one
// product, and the words of the eager chain, whose products by 1 - r and r
// give the same canonical values.
//
// Shared layout. Level l holds 2^l entries a term. Position p of level l
// goes to positions p (the factor 1 - r) and p + 2^l (the factor r) of level
// l + 1, so a position is written only by the thread that read it and no
// level races with itself: a level l position is the bit reversal of its
// index over the l bits doubled so far. The last level reads its entry of
// index x at bitrev(x), so a thread's outputs lie next to its neighbours'.
// Two terms of 2^9 entries at W = 8: 32 KB.
//
// The three kernels:
//   * wiring (gkr_wiring): coef_g = sum_t s_t eq(r_t, g) over one or two
//     terms (s_t alpha and beta; one term and no scale for the output layer),
//     written to coef_a[g] where the gate adds and to coef_m[g] where it
//     multiplies, zero to the other;
//   * phase-1 stack (gkr_phase1_stack): the (2, 2, 2n, W) stack [[w, G],
//     [H, 1]], G[2g] = coefA_g + coefM_g w[2g+1], H[2g] = coefA_g w[2g+1],
//     the odd entries zero, a thread a gate (phase1_gate);
//   * phase-2 stack (gkr_phase2_stack): [[A2, wb + w], [M2 wb, w]] with
//     A2[2g+1] = coefA_g eq(r, 2g), M2[2g+1] = coefM_g eq(r, 2g), the even
//     entries zero, eq over phase 1's challenges at the even indices only
//     (the eq halves above, the last challenge's factor 1 - r alone).
// Tables are (rows, W) uint32 words, element-major, 16-byte aligned; a stack
// is its four tables, product p and factor f at 2 p + f, 2n rows each.
//
// Built with nvcc the functions are device code; built with a host C++
// compiler (tests/test_torch_gkr_tables.py) the same functions run block by
// block and thread by thread on the host, a barrier a boundary between loops
// over the threads.

#pragma once

#include <cstdint>

#include "mont.cuh"

#ifdef __CUDACC__
#define GT_HD __host__ __device__ inline
#define GT_FN __device__ __forceinline__
#else
#define GT_HD inline
#define GT_FN inline
#endif

namespace gkr_tables {

constexpr int W = 8;
constexpr int kThreads = 256;
constexpr int kMaxTerms = 2;
// the most lo bits a block doubles; its shared table holds the level below
constexpr int kMaxLoBits = 10;
constexpr int kSharedEntries = 1 << (kMaxLoBits - 1);

using Modulus = mont::Modulus<W>;

struct Consts {
  Modulus M;
  uint32_t one[W];  // R mod p: 1 in Montgomery form
};

// lo bits of a block's indices for an eq table over k bits (k >= 1)
GT_HD int lo_bits(int k) {
  const int m = (k + 1) / 2;
  return m < kMaxLoBits ? m : kMaxLoBits;
}

GT_HD unsigned bitrev(unsigned x, int bits) {
  unsigned y = 0;
  for (int j = 0; j < bits; ++j) y |= ((x >> j) & 1u) << (bits - 1 - j);
  return y;
}

// An eq table of one or two terms: term t's k challenges at rs + t k W
struct Eq {
  const uint32_t* rs;
  int k;
  int terms;
  int m;   // lo bits: lo_bits(k)
  int hb;  // hi bits: k - m
};

GT_HD Eq make_eq(const uint32_t* rs, int k, int terms) {
  Eq q;
  q.rs = rs;
  q.k = k;
  q.terms = terms;
  q.m = lo_bits(k);
  q.hb = k - q.m;
  return q;
}

GT_FN const uint32_t* challenge(const Eq& q, int t, int j) {
  return q.rs + ((long long)t * q.k + j) * W;
}

// (x (1 - r), x r): x1 = x r, x0 = x - x1
GT_FN void split(uint32_t (&x0)[W], uint32_t (&x1)[W], const uint32_t (&x)[W],
                 const uint32_t* r_ptr, const Modulus& M) {
  uint32_t r[W];
  mont::load<W>(r, r_ptr);
  mont::mul<W>(x1, x, r, M);
  mont::sub<W>(x0, x, x1, M);
}

// Thread t < terms: its term's seed (scales[t], or one without scales) times
// the hi bits' factors of block hi, into position 0 of its shared table.
GT_FN void seed_thread(uint32_t* table, const Eq& q, const uint32_t* scales,
                       unsigned long long hi, int t, const Consts& c) {
  uint32_t x[W], x0[W], x1[W];
  if (scales) {
    mont::load<W>(x, scales + (long long)t * W);
  } else {
    for (int j = 0; j < W; ++j) x[j] = c.one[j];
  }
  for (int j = 0; j < q.hb; ++j) {
    split(x0, x1, x, challenge(q, t, j), c.M);
    const bool bit = (hi >> (q.hb - 1 - j)) & 1ull;
    for (int w = 0; w < W; ++w) x[w] = bit ? x1[w] : x0[w];
  }
  mont::store<W>(table + (long long)t * kSharedEntries * W, x);
}

// Level l < m - 1 of the doubling, thread t of nthreads: positions p < 2^l of
// each term to p and p + 2^l, at challenge hb + l.
GT_FN void level_thread(uint32_t* table, const Eq& q, int l, int t, int nthreads,
                        const Consts& c) {
  const int half = 1 << l;
  for (int it = t; it < q.terms << l; it += nthreads) {
    const int term = it >> l;
    uint32_t* e = table + ((long long)term * kSharedEntries + (it & (half - 1))) * W;
    uint32_t x[W], x0[W], x1[W];
    mont::load<W>(x, e);
    split(x0, x1, x, challenge(q, term, q.hb + l), c.M);
    mont::store<W>(e, x0);
    mont::store<W>(e + (long long)half * W, x1);
  }
}

// The last level, entry x < 2^(m - 1) of every term: children 0 and 1 of the
// entry at bitrev(x), that is the eq entries of lo = 2 x and 2 x + 1, summed
// over the terms. With only_even, child 0 alone (x1 untouched).
GT_FN void eq_last(uint32_t (&x0)[W], uint32_t (&x1)[W], const uint32_t* table, const Eq& q,
                   unsigned x, bool only_even, const Consts& c) {
  const unsigned pos = bitrev(x, q.m - 1);
  for (int term = 0; term < q.terms; ++term) {
    uint32_t e[W], e0[W], e1[W];
    mont::load<W>(e, table + ((long long)term * kSharedEntries + pos) * W);
    split(e0, e1, e, challenge(q, term, q.k - 1), c.M);
    if (term == 0) {
      for (int w = 0; w < W; ++w) x0[w] = e0[w];
      if (!only_even)
        for (int w = 0; w < W; ++w) x1[w] = e1[w];
    } else {
      mont::add<W>(x0, x0, e0, c.M);
      if (!only_even) mont::add<W>(x1, x1, e1, c.M);
    }
  }
}

// ----------------------------------------------------------------------
// wiring coefficients
// ----------------------------------------------------------------------

struct Wiring {
  Eq q;
  const uint32_t* scales;  // (terms, W) or null
  const uint8_t* is_add;   // (n,)
  long long n;
  uint32_t* coef_a;  // (n, W)
  uint32_t* coef_m;  // (n, W)
};

GT_HD long long wiring_blocks(long long n, int k) {
  const long long span = 1ll << lo_bits(k);
  return (n + span - 1) / span;
}

GT_FN void put_coef(const Wiring& a, long long g, const uint32_t (&coef)[W]) {
  if (g >= a.n) return;
  const bool add = a.is_add[g] != 0;
  uint32_t on[W], off[W];
  for (int w = 0; w < W; ++w) {
    on[w] = add ? coef[w] : 0u;
    off[w] = add ? 0u : coef[w];
  }
  mont::store<W>(a.coef_a + g * W, on);
  mont::store<W>(a.coef_m + g * W, off);
}

// Thread t of block b's last level: gates b 2^m + 2 x and + 1, x from t
GT_FN void wiring_last_thread(const uint32_t* table, const Wiring& a, long long b, int t,
                              int nthreads, const Consts& c) {
  for (unsigned x = t; x < (1u << (a.q.m - 1)); x += nthreads) {
    uint32_t x0[W], x1[W];
    eq_last(x0, x1, table, a.q, x, false, c);
    const long long g = (b << a.q.m) + 2 * (long long)x;
    put_coef(a, g, x0);
    put_coef(a, g + 1, x1);
  }
}

// ----------------------------------------------------------------------
// phase stacks
// ----------------------------------------------------------------------

GT_FN uint32_t* row(uint32_t* stack, long long n, int table, long long i) {
  return stack + ((long long)table * 2 * n + i) * W;
}

// Gate g of the phase-1 stack [[w, G], [H, 1]]: rows 2g and 2g + 1 of each
GT_FN void phase1_gate(uint32_t* stack, const uint32_t* coef_a, const uint32_t* coef_m,
                       const uint32_t* w, long long n, long long g, const Consts& c) {
  const uint32_t zero[W] = {};
  uint32_t w0[W], w1[W], ca[W], cm[W], h[W], gg[W];
  mont::load<W>(w0, w + 2 * g * W);
  mont::load<W>(w1, w + (2 * g + 1) * W);
  mont::load<W>(ca, coef_a + g * W);
  mont::load<W>(cm, coef_m + g * W);
  mont::mul<W>(h, ca, w1, c.M);
  mont::mul<W>(gg, cm, w1, c.M);
  mont::add<W>(gg, ca, gg, c.M);
  mont::store<W>(row(stack, n, 0, 2 * g), w0);
  mont::store<W>(row(stack, n, 0, 2 * g + 1), w1);
  mont::store<W>(row(stack, n, 1, 2 * g), gg);
  mont::store<W>(row(stack, n, 1, 2 * g + 1), zero);
  mont::store<W>(row(stack, n, 2, 2 * g), h);
  mont::store<W>(row(stack, n, 2, 2 * g + 1), zero);
  mont::store<W>(row(stack, n, 3, 2 * g), c.one);
  mont::store<W>(row(stack, n, 3, 2 * g + 1), c.one);
}

struct Phase2 {
  Eq q;  // one term: phase 1's challenges, K = log2(2n) of them
  const uint32_t* coef_a;
  const uint32_t* coef_m;
  const uint32_t* w;   // (2n, W)
  const uint32_t* wb;  // (W,): w(r_b)
  long long n;
  uint32_t* stack;  // (2, 2, 2n, W)
};

// blocks of a phase-2 stack: 2^(m - 1) gates each (2^m eq indices, the even
// ones used)
GT_HD long long phase2_blocks(long long n, int k) { return 2 * n >> lo_bits(k); }

// Gate g of [[A2, wb + w], [M2 wb, w]] from e = eq(r, 2g)
GT_FN void phase2_gate(const Phase2& a, long long g, const uint32_t (&e)[W], const Consts& c) {
  const uint32_t zero[W] = {};
  uint32_t w0[W], w1[W], wb[W], t[W], u[W];
  const long long n = a.n;
  mont::load<W>(w0, a.w + 2 * g * W);
  mont::load<W>(w1, a.w + (2 * g + 1) * W);
  mont::load<W>(wb, a.wb);
  mont::load<W>(t, a.coef_a + g * W);
  mont::mul<W>(t, t, e, c.M);
  mont::store<W>(row(a.stack, n, 0, 2 * g), zero);
  mont::store<W>(row(a.stack, n, 0, 2 * g + 1), t);
  mont::load<W>(t, a.coef_m + g * W);
  mont::mul<W>(t, t, e, c.M);
  mont::mul<W>(t, t, wb, c.M);
  mont::store<W>(row(a.stack, n, 2, 2 * g), zero);
  mont::store<W>(row(a.stack, n, 2, 2 * g + 1), t);
  mont::add<W>(u, w0, wb, c.M);
  mont::store<W>(row(a.stack, n, 1, 2 * g), u);
  mont::add<W>(u, w1, wb, c.M);
  mont::store<W>(row(a.stack, n, 1, 2 * g + 1), u);
  mont::store<W>(row(a.stack, n, 3, 2 * g), w0);
  mont::store<W>(row(a.stack, n, 3, 2 * g + 1), w1);
}

// Thread t of block b's last level: gate b 2^(m - 1) + x, x from t
GT_FN void phase2_last_thread(const uint32_t* table, const Phase2& a, long long b, int t,
                              int nthreads, const Consts& c) {
  for (unsigned x = t; x < (1u << (a.q.m - 1)); x += nthreads) {
    uint32_t e[W], unused[W];
    eq_last(e, unused, table, a.q, x, true, c);
    phase2_gate(a, (b << (a.q.m - 1)) + x, e, c);
  }
}

}  // namespace gkr_tables
