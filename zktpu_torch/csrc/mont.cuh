// A Montgomery core on PTX carry chains with the modulus given at run time, and
// the per-lane work of two of the three kernels built on it: gkr_round
// (sumcheck_kernels.cu) and ntt_phase1 (ntt_kernels.cu). The third,
// fold_and_halves, has its per-thread work in sums.cuh.
//
// Fields: the package's three 8-word fields (BN254 Fq, BN254 Fr, BLS12-381 Fr),
// and BLS12-381 Fq at W = 12, which gkr_round also takes. One kernel serves
// every field of a width: p and n0 = -p^-1 mod 2^32 come in a Modulus<W> that
// the kernel receives by value (its constant bank).
//
// Products are fq381.cuh's even/odd-word CIOS: a row a * b_i is split into the
// products of a's even words and those of its odd words, two accumulators `ev`
// and `od` (od one word up), so each row is two carry chains of
// non-overlapping (lo, hi) pairs, and the division by 2^32 of each CIOS step is
// a renaming of the two. The primitives are carry.cuh's; only p's words differ,
// read from the Modulus instead of compiled in.
//
// Ranges. Every value the core returns is canonical (< p), and every operand
// must be, except mul's second. The core relies on 2p < 2^(32 W), which holds
// for all four fields (BLS12-381 Fr has r < 2^255). fq381.cuh keeps values
// lazily in [0, 2p) because 4p < 2^384 there; here r > 2^254 makes 3r > 2^256,
// so a sum of two lazy values would not fit in 8 words, and nothing is lazy:
//   * mul(a, b) with a < p and any b < 2^(32 W): a CIOS step holds at most
//     (a + p) 2^32 <= 2^(32 (W + 1)), which the (ev, od) pair carries without
//     losing a carry, and the result (a b + M p) / R < a + p < 2p. One
//     conditional subtraction makes it canonical. No product skips it: the next
//     operation (a sum in both kernels) would overflow 2^256 at BLS12-381 Fr.
//   * add(a, b) < 2p needs no top word; one conditional subtraction.
//   * sub(a, b) adds p back where it borrows.
//
// Built with nvcc the functions are device code; built with a host C++ compiler
// (the CPU tests do, tests/test_torch_mont.py) carry.cuh emulates the
// primitives, and the same arithmetic, the gkr_round term of an index and the
// ntt_phase1 tile steps run on the host.

#pragma once

#include <cstdint>

#include "carry.cuh"

#ifdef __CUDACC__
#define MT_FN __device__ __forceinline__
#else
#define MT_FN inline
#endif

namespace mont {

using namespace carry;

template <int W>
struct Modulus {
  uint32_t p[W];
  uint32_t n0;
};

// ----------------------------------------------------------------------
// element loads and stores: 16-byte vectors (elements are 16-byte aligned)
// ----------------------------------------------------------------------

template <int W>
MT_FN void load(uint32_t (&x)[W], const uint32_t* __restrict__ src) {
  static_assert(W % 4 == 0, "elements are moved as 16-byte vectors");
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

template <int W>
MT_FN void store(uint32_t* __restrict__ dst, const uint32_t (&x)[W]) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) v[k] = uint4{x[4 * k + 0], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]};
}

// ----------------------------------------------------------------------
// canonical add, sub, conditional subtraction
// ----------------------------------------------------------------------

// t < 2p -> t mod p
template <int W>
MT_FN void cond_sub(uint32_t (&out)[W], const uint32_t (&t)[W], const Modulus<W>& M) {
  uint32_t d[W];
  d[0] = sub_cc(t[0], M.p[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(t[j], M.p[j]);
  const uint32_t borrow = subc(0, 0);  // all ones when t < p
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = borrow ? t[j] : d[j];
}

// a + b mod p (a + b < 2p < 2^(32 W): no carry out). out may alias a or b.
template <int W>
MT_FN void add(uint32_t (&out)[W], const uint32_t (&a)[W], const uint32_t (&b)[W],
               const Modulus<W>& M) {
  uint32_t s[W];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) s[j] = addc_cc(a[j], b[j]);
  s[W - 1] = addc(a[W - 1], b[W - 1]);
  cond_sub<W>(out, s, M);
}

// a - b mod p: on a borrow, p is added back mod 2^(32 W). out may alias a or b.
template <int W>
MT_FN void sub(uint32_t (&out)[W], const uint32_t (&a)[W], const uint32_t (&b)[W],
               const Modulus<W>& M) {
  uint32_t d[W];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) d[j] = subc_cc(a[j], b[j]);
  const uint32_t mask = subc(0, 0);
  out[0] = add_cc(d[0], M.p[0] & mask);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) out[j] = addc_cc(d[j], M.p[j] & mask);
  out[W - 1] = addc(d[W - 1], M.p[W - 1] & mask);
}

// ----------------------------------------------------------------------
// the Montgomery product
// ----------------------------------------------------------------------

// acc += m * (p's even words), or its odd words (od is one word up): one chain
// that starts fresh and leaves its carry in the flag.
template <int W, int Off>
MT_FN void mad_p(uint32_t (&acc)[W], uint32_t m, const Modulus<W>& M) {
  acc[0] = mad_lo_cc(M.p[Off], m, acc[0]);
  acc[1] = madc_hi_cc(M.p[Off], m, acc[1]);
#pragma unroll
  for (int j = 2; j < W; j += 2) {
    acc[j] = madc_lo_cc(M.p[j + Off], m, acc[j]);
    acc[j + 1] = madc_hi_cc(M.p[j + Off], m, acc[j + 1]);
  }
}

// One CIOS reduction step on (ev + 2^32 od) with ev[0] the lowest word: add
// m p with m = ev[0] n0, which clears ev[0]; ev's carry goes to od's top. The
// carry out of od's chain is 0: the sum stays below 2^(32 (W + 1)).
template <int W>
MT_FN void reduce_step(uint32_t (&ev)[W], uint32_t (&od)[W], const Modulus<W>& M) {
  const uint32_t m = ev[0] * M.n0;
  mad_p<W, 1>(od, m, M);
  mad_p<W, 0>(ev, m, M);
  od[W - 1] = addc(od[W - 1], 0);
}

// (ev, od) hold t = ev + 2^32 od with ev[0] == 0. Roles swap: od becomes the
// low accumulator E of t / 2^32 and ev, shifted down two words, the high one
// O; ev[1] is added into E[0] and its carry enters O's chain, which adds a's
// odd words times bi. Then E += a's even words times bi.
template <int W>
MT_FN void mul_row(uint32_t (&E)[W], uint32_t (&O)[W], const uint32_t (&a)[W], uint32_t bi) {
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

// out = (ev + 2^32 od) / 2^32 with ev[0] == 0
template <int W>
MT_FN void merge(uint32_t (&out)[W], const uint32_t (&ev)[W], const uint32_t (&od)[W]) {
  out[0] = add_cc(od[0], ev[1]);
#pragma unroll
  for (int j = 1; j < W - 1; ++j) out[j] = addc_cc(od[j], ev[j + 1]);
  out[W - 1] = addc(od[W - 1], 0);
}

// out = a b / R mod p, canonical, for a < p and b < 2^(32 W) (the header's
// comment has the bound). out may alias a or b.
template <int W>
MT_FN void mul(uint32_t (&out)[W], const uint32_t (&a)[W], const uint32_t (&b)[W],
               const Modulus<W>& M) {
  static_assert(W % 2 == 0, "the even/odd split needs an even word count");
  uint32_t ev[W], od[W];
  const uint32_t b0 = b[0];
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    ev[j] = a[j] * b0;
    ev[j + 1] = mul_hi(a[j], b0);
    od[j] = a[j + 1] * b0;
    od[j + 1] = mul_hi(a[j + 1], b0);
  }
  reduce_step<W>(ev, od, M);
#pragma unroll
  for (int i = 1; i < W; i += 2) {
    mul_row<W>(od, ev, a, b[i]);
    reduce_step<W>(od, ev, M);
    if (i + 1 < W) {
      mul_row<W>(ev, od, a, b[i + 1]);
      reduce_step<W>(ev, od, M);
    }
  }
  // W is even, so the last row (i = W - 1) left the low accumulator in od
  uint32_t r[W];
  merge<W>(r, od, ev);
  cond_sub<W>(out, r, M);
}

// out = a + r (b - a) mod p, the fold of one multilinear variable at r; a, b
// and r canonical. r is mul's first operand, the one that must be below p.
// out may alias a or b.
template <int W>
MT_FN void lerp(uint32_t (&out)[W], const uint32_t (&a)[W], const uint32_t (&b)[W],
                const uint32_t (&r)[W], const Modulus<W>& M) {
  uint32_t d[W];
  sub<W>(d, b, a, M);
  mul<W>(d, r, d, M);
  add<W>(out, a, d, M);
}

// acc (W + 1 words, an exact integer) += x
template <int W>
MT_FN void acc_add(uint32_t (&acc)[W + 1], const uint32_t (&x)[W]) {
  acc[0] = add_cc(acc[0], x[0]);
#pragma unroll
  for (int j = 1; j < W; ++j) acc[j] = addc_cc(acc[j], x[j]);
  acc[W] = addc(acc[W], 0);
}

// ----------------------------------------------------------------------
// gkr_round: the work of one index
// ----------------------------------------------------------------------

// tables (2, 2, size, W): product p, factor f, entry, word. With a =
// tables[p][f][i] and b = tables[p][f][i + size/2], v_0 = a, v_1 = b and
// v_2 = b + (b - a); term_t = v_t[0][0] v_t[0][1] + v_t[1][0] v_t[1][1] mod p
// goes to add_term(t, term_t) (the caller sums it). The eight elements are
// each loaded once. Order, to keep few values live: product 0's three values
// first (v_2 formed in a's registers once b's product is taken), then product
// 1's, each added to its partner and handed on at once.
template <int W, class AddTerm>
MT_FN void gkr_round_index(AddTerm&& add_term, const uint32_t* __restrict__ tables,
                           long long size, long long i, const Modulus<W>& M) {
  const long long half = size / 2;
  const uint32_t* f0 = tables + i * W;  // product 0, factor 0; factor 1 a table further
  uint32_t s[3][W];
  {
    uint32_t x[W], y[W], u[W], v[W];
    load<W>(x, f0);
    load<W>(y, f0 + size * W);
    mul<W>(s[0], x, y, M);
    load<W>(u, f0 + half * W);
    load<W>(v, f0 + (size + half) * W);
    mul<W>(s[1], u, v, M);
    sub<W>(x, u, x, M);
    add<W>(x, u, x, M);
    sub<W>(y, v, y, M);
    add<W>(y, v, y, M);
    mul<W>(s[2], x, y, M);
  }
  const uint32_t* g0 = f0 + 2 * size * W;  // product 1, factor 0
  uint32_t x[W], y[W], u[W], v[W], pr[W];
  load<W>(x, g0);
  load<W>(y, g0 + size * W);
  mul<W>(pr, x, y, M);
  add<W>(pr, pr, s[0], M);
  add_term(0, pr);
  load<W>(u, g0 + half * W);
  load<W>(v, g0 + (size + half) * W);
  mul<W>(pr, u, v, M);
  add<W>(pr, pr, s[1], M);
  add_term(1, pr);
  sub<W>(x, u, x, M);
  add<W>(x, u, x, M);
  sub<W>(y, v, y, M);
  add<W>(y, v, y, M);
  mul<W>(pr, x, y, M);
  add<W>(pr, pr, s[2], M);
  add_term(2, pr);
}

// Term t of index i alone, for tables too small to fill the card: there one
// thread an (index, t) pair divides a launch's latency by three (a thread's
// products are one serial chain of carries), and the second read of the stack
// that t = 2 makes comes from L2. t = 0, 1 load four elements, t = 2 eight.
template <int W, class AddTerm>
MT_FN void gkr_round_term(AddTerm&& add_term, int t, const uint32_t* __restrict__ tables,
                          long long size, long long i, const Modulus<W>& M) {
  const long long half = size / 2;
  uint32_t pr[2][W];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t* f = tables + (2 * q * size + i) * W;  // product q, factor 0
    uint32_t x[W], y[W];
    if (t < 2) {
      load<W>(x, f + t * half * W);
      load<W>(y, f + (size + t * half) * W);
    } else {
      uint32_t u[W], v[W];
      load<W>(x, f);
      load<W>(y, f + size * W);
      load<W>(u, f + half * W);
      load<W>(v, f + (size + half) * W);
      sub<W>(x, u, x, M);
      add<W>(x, u, x, M);
      sub<W>(y, v, y, M);
      add<W>(y, v, y, M);
    }
    mul<W>(pr[q], x, y, M);
  }
  add<W>(pr[0], pr[0], pr[1], M);
  add_term(t, pr[0]);
}

}  // namespace mont

// ----------------------------------------------------------------------
// ntt_phase1: the steps of one thread of a tile block
// ----------------------------------------------------------------------
//
// A block takes a chunk of C = 2^c consecutive rows of the bit-reversed table,
// c = min(10, log_n), and runs stages 1..log_tile over it (log_tile <= c: a
// stage pairs rows inside aligned groups of its span, so one chunk holds C /
// 2^log_tile whole tiles). Its 128 threads (C / 8, at least one) hold eight
// rows each in registers. A "window" b places them: thread t holds rows
//   k(t, b, m) = (t >> b) 2^(b + 3) + m 2^b + (t mod 2^b),   m = 0..7,
// so stages b + 1, b + 2, b + 3 pair rows of the same thread (m's bits 0, 1,
// 2). A pass runs up to three stages in registers, radix 8; passes meet in
// shared memory: each thread stores its rows under the old window, a barrier,
// and loads them under the new one. At C = 1024 the windows are b = 0, 3, 6, 7
// (stages 1-3, 4-6, 7-9, 10): three exchanges, where a pass of one stage per
// barrier took ten. The first pass's rows are gathered straight from the
// table (row k of the bit-reversed table is x[brev(k)]), the last pass's
// stored straight to the output.
//
// Twiddles: the stage of span 2^s uses w^(pos n / 2^s), pos < 2^(s-1). For
// s <= c these are powers of the 2^c-th root w^(n / C); the block stages the
// C/2 of them (16 KB at C = 1024) into shared memory once, from the compact
// table that ntt_kernels.py gathers from the n/2-entry one, and reads
// w^(pos n / 2^s) as entry pos 2^(c - s). In the first pass a butterfly whose
// twiddle is w^0 = 1 (all of stage 1, half of stage 2, a quarter of stage 3)
// is u + v, u - v without a product: w^0 is R mod p in Montgomery form, and a
// product by it returns v unchanged, so the words are those of the plain
// version either way.
//
// Shared memory holds words in planes, [word][row], read and written 4 bytes
// at a time, so a warp's 32 accesses hit 32 banks when their rows differ mod
// 32. Rows are placed at tile_col(k): k with its bits 5, 6, 7 folded into bits
// 0..4 (bit 5 onto 0, bit 6 onto 1 and 3, bit 7 onto 2 and 4). Under window 0 a
// warp's rows differ in bits 3..7, under window 3 in bits 0, 1, 2, 6, 7, under
// windows of 5 or more in bits 0..4: the fold is one-to-one onto the banks for
// each. A twiddle stage reads entries pos 2^(c - s) whose varying bits are a
// run of at most five: tw_col(j) = j ^ (j >> 5) maps any such run onto
// distinct banks.

namespace ntt_tile {

constexpr int W = 8;
constexpr int kLogChunk = 10;
constexpr int kChunk = 1 << kLogChunk;   // rows a block holds
constexpr int kThreads = kChunk / 8;     // eight rows a thread
constexpr int kTwiddles = kChunk / 2;

typedef uint32_t Rows[8][W];
typedef uint32_t TilePlanes[W][kChunk];  // 32 KB
typedef uint32_t TwPlanes[W][kTwiddles];  // 16 KB
typedef mont::Modulus<W> Mod;

MT_FN uint32_t brev32(uint32_t v) {
#ifdef __CUDACC__
  return __brev(v);
#else
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
#endif
}

MT_FN int row_of(int t, int b, int m) {
  return ((t >> b) << (b + 3)) | (m << b) | (t & ((1 << b) - 1));
}

MT_FN int tile_col(int k) {
  return k ^ ((k >> 5) & 1) ^ (((k >> 6) & 1) * 0x0a) ^ (((k >> 7) & 1) * 0x14);
}

MT_FN int tw_col(int j) { return j ^ ((j >> 5) & 31); }

// The window of the pass that starts at stage f: f - 1, unless the chunk is too
// short for three stages above it (lx = log2 of the rows the threads cover).
MT_FN int window(int f, int lx) { return f - 1 < lx - 3 ? f - 1 : lx - 3; }

// The chunk's twiddles into shared memory: entry j = w^(j n / C), j < C / 2.
MT_FN void stage_twiddles(TwPlanes& tw, const uint32_t* __restrict__ ctw, int t, int threads,
                          int log_chunk) {
  const int count = log_chunk ? 1 << (log_chunk - 1) : 0;
  for (int j = t; j < count; j += threads) {
    uint32_t w[W];
    mont::load<W>(w, ctw + (long long)j * W);
    const int col = tw_col(j);
#pragma unroll
    for (int q = 0; q < W; ++q) tw[q][col] = w[q];
  }
}

// Window 0's rows, gathered from x: row base + k of the bit-reversed table is
// x[brev(base + k)]. Rows past the chunk (log_n < 3) are zeros, never stored.
MT_FN void gather(Rows& e, const uint32_t* __restrict__ x, int t, long long base, int log_n,
                  int log_chunk) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int k = row_of(t, 0, m);
    if (k < (1 << log_chunk)) {
      // a 64-bit shift: log_n = 0 shifts by 32 and gives row 0
      const long long src =
          (long long)((unsigned long long)brev32((uint32_t)(base + k)) >> (32 - log_n));
      mont::load<W>(e[m], x + src * W);
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) e[m][q] = 0;
    }
  }
}

MT_FN void store_rows(TilePlanes& tile, const Rows& e, int t, int b) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int col = tile_col(row_of(t, b, m));
#pragma unroll
    for (int q = 0; q < W; ++q) tile[q][col] = e[m][q];
  }
}

MT_FN void load_rows(Rows& e, const TilePlanes& tile, int t, int b) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int col = tile_col(row_of(t, b, m));
#pragma unroll
    for (int q = 0; q < W; ++q) e[m][q] = tile[q][col];
  }
}

// The rows of window b to the output (rows of the chunk only).
MT_FN void scatter(uint32_t* __restrict__ out, const Rows& e, int t, int b, long long base,
                   int log_chunk) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int k = row_of(t, b, m);
    if (k < (1 << log_chunk)) mont::store<W>(out + (base + k) * W, e[m]);
  }
}

// u, v -> u + w v, u - w v, all canonical
MT_FN void butterfly(uint32_t (&u)[W], uint32_t (&v)[W], const uint32_t (&w)[W], const Mod& M) {
  uint32_t p[W];
  mont::mul<W>(p, w, v, M);
  mont::sub<W>(v, u, p, M);
  mont::add<W>(u, u, p, M);
}

// The stage that pairs bit Bit of m under window b: stage s = b + Bit + 1.
// Under window 0 (the first pass, First) a butterfly's twiddle index is known
// when the code is compiled, and those with w^0 = 1 take no product; under any
// later window every butterfly multiplies, the thread with t mod 2^b = 0 by
// w^0 too (exact: a product by R mod p returns v): a branch on the twiddle
// index there cost more than the products it saved.
template <int Bit, bool First>
MT_FN void radix2_layer(Rows& e, const TwPlanes& tw, int t, int b, int log_chunk, const Mod& M) {
  const int s = b + Bit + 1;
  const int lo = First ? 0 : t & ((1 << b) - 1);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if (m & (1 << Bit)) continue;
    const int pos = lo + ((m & ((1 << Bit) - 1)) << b);
    uint32_t(&u)[W] = e[m];
    uint32_t(&v)[W] = e[m | (1 << Bit)];
    if (First && (m & ((1 << Bit) - 1)) == 0) {  // w^0 = 1
      uint32_t d[W];
      mont::sub<W>(d, u, v, M);
      mont::add<W>(u, u, v, M);
#pragma unroll
      for (int q = 0; q < W; ++q) v[q] = d[q];
    } else {
      const int col = tw_col(pos << (log_chunk - s));
      uint32_t w[W];
#pragma unroll
      for (int q = 0; q < W; ++q) w[q] = tw[q][col];
      butterfly(u, v, w, M);
    }
  }
}

// Stages first..last (within b + 1..b + 3) of the pass under window b.
MT_FN void run_stages(Rows& e, const TwPlanes& tw, int t, int b, int first, int last,
                      int log_chunk, const Mod& M) {
  if (b == 0) {
    if (first <= 1 && last >= 1) radix2_layer<0, true>(e, tw, t, 0, log_chunk, M);
    if (first <= 2 && last >= 2) radix2_layer<1, true>(e, tw, t, 0, log_chunk, M);
    if (first <= 3 && last >= 3) radix2_layer<2, true>(e, tw, t, 0, log_chunk, M);
    return;
  }
  if (b + 1 >= first && b + 1 <= last) radix2_layer<0, false>(e, tw, t, b, log_chunk, M);
  if (b + 2 >= first && b + 2 <= last) radix2_layer<1, false>(e, tw, t, b, log_chunk, M);
  if (b + 3 >= first && b + 3 <= last) radix2_layer<2, false>(e, tw, t, b, log_chunk, M);
}

}  // namespace ntt_tile
