// The work of the fused GKR phase kernels (gkr_phase_kernels.cu): the rounds
// of one sumcheck phase of a lazy GKR layer, each round's fold, sums, Lagrange
// interpolation, trimmed absorb and next challenge, with nothing read back to
// the host.
//
// A phase holds a stack of four tables, product p and factor f at index
// 2 p + f, each `stride` entries apart (the stride of the buffer, which stays
// put while the tables halve in place), `size` entries in use. A round:
//   1. the fused step. With a pending challenge r (every round but a phase's
//      first) the stack is folded at r, entry i < size/2 from entries i and
//      i + size/2 (mont::lerp), the folded stack written, and the three lazy
//      rows y_0, y_1, y_2 of the FOLDED stack summed in the same pass: index
//      i < size/4 folds the four entries i, i + size/4, i + size/2,
//      i + 3 size/4 of each table into the folded pair (i, i + size/4) and
//      forms the round's terms from that pair, so the folded words are never
//      read back. A phase's first round has nothing to fold: index i < size/2
//      forms its terms from the pair (i, i + size/2), gkr_round's per-index
//      work (mont::gkr_round_index) on the caller's stack.
//      Term t of an index is v_t[0][0] v_t[0][1] + v_t[1][0] v_t[1][1] with
//      v_0 = a, v_1 = b, v_2 = b + (b - a) for the pair (a, b).
//   2. the column sums: each block sums its threads' terms into 64-bit column
//      sums, three rows of W + 1 columns, laid out [row][column][block]
//      (sums::partial_at); a round on one block writes them as its columns.
//   3. the finishing step, on one block: the partials' columns added (groups
//      of threads, sums::group_share) and rippled into the (3, W + 1) lazy
//      rows (sums::ripple), then transcript::round_step<3, First> on one warp
//      of that block: the canonical coefficients into the round's slot, the
//      absorb, the new state and the next challenge.
// After the phase's last round the [0][0] table of two entries is folded at
// the last challenge into its one entry, w(r_b) after phase 1.
//
// gkr_big_round takes that fused step, an index a thread. A phase tail's
// rounds are small, where a thread's chain of fourteen products would be the
// round's time, so a tail round splits the same work in two passes over a
// block's run of indices (tail_run): the fold, a thread an entry of the
// folded stack (eight an index, one product each: fold_thread), a barrier,
// then the sums, a thread a term of an index (three an index, two products
// each: terms_thread, on the folded entries the block just wrote). The terms
// and so the rows are the same words as the fused step's.
//
// A tail runs its rounds in two tiers (tail_step). A round that sums more
// than block_max entries a table is a grid round: the blocks it keeps busy
// (step_blocks: a run of at least sums::kRunAlign indices each) fold the stack
// in place in a work buffer in device memory, read through L2 (load_l2:
// another block may have written them since this SM last saw them), and write
// partials that block 0 finishes. A round that sums at most block_max entries
// is a block round: block 0 alone, its first fold from device memory into the
// block's shared memory, the later ones in place there, its columns straight
// into the finish. The rounds' sums only shrink, so the grid rounds come
// first.
//
// A fold writes entry e < size/2 of a table from its entries e and e + size/2:
// an entry is written only by the item that reads it, and the entries at or
// above size/2 are only read, so a fold in place (the source and the folded
// stack in one buffer, one stride) races with nothing within a step; nor does
// the fused step's index i, which touches entries of i alone.
//
// Built with nvcc the functions are device code; built with a host C++ compiler
// (tests/test_torch_gkr_phase_kernels.py) the same functions run block by block
// and thread by thread on the host, a barrier between two steps a boundary
// between two calls and round_step's warp on warp.cuh's fibers.

#pragma once

#include <cstdint>

#include "mont.cuh"
#include "sums.cuh"
#include "transcript.cuh"

// for what the launchers (host code) share with the kernels
#ifdef __CUDACC__
#define GP_HD __host__ __device__ inline
#else
#define GP_HD inline
#endif

namespace gkr_phase {

using namespace carry;

constexpr int W = transcript::W;
// columns of a lazy row and rows of a round
constexpr int C = W + 1;
constexpr int kRows = 3;
constexpr int kThreads = 256;
// the finish's threads a column (27 columns)
constexpr int kGroup = 8;
static_assert(kGroup * kRows * C <= kThreads, "a group of threads for every column");
// the largest block_max: the block tier's stack, 4 tables of 2^10 entries of
// 32 bytes, is 128 KB of shared memory beside the block's 28 KB of sums
constexpr long long kBlockMaxCap = 1 << 10;

// W words of an element through L2 only: no L1 line of another block's writes
MT_FN void load_l2(uint32_t (&x)[W], const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
#ifdef __CUDACC__
    const uint4 q = __ldcg(v + k);
#else
    const uint4 q = v[k];
#endif
    x[4 * k + 0] = q.x;
    x[4 * k + 1] = q.y;
    x[4 * k + 2] = q.z;
    x[4 * k + 3] = q.w;
  }
}

// W words of an element from the block's shared memory (a generic load), or
// through L2
MT_FN void load_src(uint32_t (&x)[W], const uint32_t* src, bool shared) {
  if (shared) {
    mont::load<W>(x, src);
  } else {
    load_l2(x, src);
  }
}

// One step of a phase: fold `src` (size entries in use) at r into `dst`, or,
// in a phase's first round (fold false), sum `src` as it is: then its stride
// is its size (the caller's stack). block: a block round (its dst the block's
// shared memory); src_shared: src is there too.
struct Step {
  const uint32_t* src;
  long long src_stride;
  uint32_t* dst;
  long long dst_stride;
  long long size;
  bool fold;
  bool block;
  bool src_shared;
};

// the indices of a step: a folded pair each, or a pair of the stack each
GP_HD long long step_indices(const Step& s) { return s.fold ? s.size / 4 : s.size / 2; }

// the entries a table that a step sums: the folded stack's, or the stack's
GP_HD long long step_summed(const Step& s) { return s.fold ? s.size / 2 : s.size; }

// The blocks of a grid of nbr that a tail's grid round keeps busy: a run of
// sums::kRunAlign indices each, at least one block, at most nbr
GP_HD int step_blocks(const Step& s, int nbr) {
  const long long need = (step_indices(s) + sums::kRunAlign - 1) / sums::kRunAlign;
  return need < 1 ? 1 : need < nbr ? (int)need : nbr;
}

// product q's three terms of one pair (a[f], b[f]) of factors f = 0, 1 into
// s[t]; a and b are overwritten
MT_FN void pair_terms(uint32_t (&s)[kRows][W], uint32_t (&a)[2][W], uint32_t (&b)[2][W],
                      const mont::Modulus<W>& M) {
  mont::mul<W>(s[0], a[0], a[1], M);
  mont::mul<W>(s[1], b[0], b[1], M);
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    mont::sub<W>(a[f], b[f], a[f], M);
    mont::add<W>(a[f], b[f], a[f], M);
  }
  mont::mul<W>(s[2], a[0], a[1], M);
}

// Index i of a step: its three terms go to add_term(t, term_t). Without a
// fold it is gkr_round's index (mont::gkr_round_index: the pair (src[i],
// src[i + size/2]), src_stride == size). With a fold, table k's entries i,
// i + size/2 fold into a = dst[i] and entries i + size/4, i + 3 size/4 into
// b = dst[i + size/4]; product 0's terms are held while product 1's are
// formed, then the sums handed on.
template <class AddTerm>
MT_FN void step_index(AddTerm&& add_term, const Step& s, long long i, const uint32_t (&r)[W],
                      const mont::Modulus<W>& M) {
  if (!s.fold) {
    mont::gkr_round_index<W>(add_term, s.src, s.size, i, M);
    return;
  }
  const long long half = s.size / 2, quarter = s.size / 4;
  uint32_t held[kRows][W];
#pragma unroll 1
  for (int q = 0; q < 2; ++q) {
    uint32_t a[2][W], b[2][W];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const uint32_t* t = s.src + ((2 * q + f) * s.src_stride + i) * W;
      uint32_t x[W], y[W];
      load_l2(x, t);
      load_l2(y, t + half * W);
      mont::lerp<W>(a[f], x, y, r, M);
      load_l2(x, t + quarter * W);
      load_l2(y, t + (half + quarter) * W);
      mont::lerp<W>(b[f], x, y, r, M);
      uint32_t* d = s.dst + ((2 * q + f) * s.dst_stride + i) * W;
      mont::store<W>(d, a[f]);
      mont::store<W>(d + quarter * W, b[f]);
    }
    if (q == 0) {
      pair_terms(held, a, b, M);
    } else {
      uint32_t s1[kRows][W];
      pair_terms(s1, a, b, M);
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        mont::add<W>(s1[t], s1[t], held[t], M);
        add_term(t, s1[t]);
      }
    }
  }
}

// Thread t of block b of a grid of nbr blocks: its indices of the step, a
// grid-stride loop.
template <class AddTerm>
MT_FN void step_thread(AddTerm&& add_term, const Step& s, int b, int nbr, int t,
                       const uint32_t (&r)[W], const mont::Modulus<W>& M) {
  const long long n = step_indices(s);
  const long long stride = (long long)nbr * kThreads;
  for (long long i = (long long)b * kThreads + t; i < n; i += stride) step_index(add_term, s, i, r, M);
}

// Block b's run of a tail round's indices on nbr blocks: contiguous, whole
// runs of sums::kRunAlign, so the folded entries its sums read are its own
MT_FN sums::Run tail_run(const Step& s, int b, int nbr) {
  return sums::block_run(0, step_indices(s), b, nbr);
}

// Thread t's part of a tail round's fold on a block's run: entries i and
// i + size/4 of each folded table for i in the run, dst[k][e] = src[k][e] +
// r (src[k][e + size/2] - src[k][e]); consecutive threads on consecutive
// entries. Nothing without a fold.
MT_FN void fold_thread(const Step& s, sums::Run run, int t, const uint32_t (&r)[W],
                       const mont::Modulus<W>& M) {
  if (!s.fold) return;
  const long long len = run.end - run.begin, half = s.size / 2, quarter = s.size / 4;
  for (long long j = t; j < 8 * len; j += kThreads) {
    const long long kh = j / len, e = run.begin + j % len + (kh & 1) * quarter, k = kh >> 1;
    const uint32_t* x = s.src + (k * s.src_stride + e) * W;
    uint32_t a[W], b[W];
    load_src(a, x, s.src_shared);
    load_src(b, x + half * W, s.src_shared);
    mont::lerp<W>(a, a, b, r, M);
    mont::store<W>(s.dst + (k * s.dst_stride + e) * W, a);
  }
}

// Thread t's part of a tail round's sums on a block's run, after its fold:
// term t of index i for (t, i) over the run's indices, v_t[0][0] v_t[0][1] +
// v_t[1][0] v_t[1][1] on the pair (i, i + n/2) of the summed stack (n
// entries: the folded one, or the caller's stack in a phase's first round),
// handed to add_term(t, term), as mont::gkr_round_term forms it. (Two items
// a turn, their products side by side, was slower: the SM runs out of
// instruction slots before latency.)
template <class AddTerm>
MT_FN void terms_thread(AddTerm&& add_term, const Step& s, sums::Run run, int t,
                        const mont::Modulus<W>& M) {
  const uint32_t* tab = s.fold ? s.dst : s.src;
  const long long stride = s.fold ? s.dst_stride : s.src_stride;
  const bool shared = s.fold && s.block;
  const long long len = run.end - run.begin, half = step_summed(s) / 2;
  for (long long j = t; j < 3 * len; j += kThreads) {
    const int term = (int)(j / len);
    const long long i = run.begin + j % len;
    uint32_t pr[2][W];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t* f = tab + (2 * q * stride + i) * W;  // product q, factor 0
      uint32_t x[W], y[W];
      if (term < 2) {
        load_src(x, f + term * half * W, shared);
        load_src(y, f + (stride + term * half) * W, shared);
      } else {
        uint32_t u[W], v[W];
        load_src(x, f, shared);
        load_src(y, f + stride * W, shared);
        load_src(u, f + half * W, shared);
        load_src(v, f + (stride + half) * W, shared);
        mont::sub<W>(x, u, x, M);
        mont::add<W>(x, u, x, M);
        mont::sub<W>(y, v, y, M);
        mont::add<W>(y, v, y, M);
      }
      mont::mul<W>(pr[q], x, y, M);
    }
    mont::add<W>(pr[0], pr[0], pr[1], M);
    add_term(term, pr[0]);
  }
}

// The threads of a block that have a term of its run: the first ones
MT_FN int terms_live(sums::Run run) {
  const long long n = 3 * (run.end - run.begin);
  return n < kThreads ? (int)n : kThreads;
}

// The finish's thread j of the group of flat column k = row C + column: its
// share of the column over the nbr blocks' partials (the group then adds its
// shares)
MT_FN uint64_t finish_share(const uint64_t* partials, int k, int j, int nbr) {
  return sums::group_share<kGroup>(partials, k / C, k % C, C, j, nbr);
}

// row (W + 1 clean words) from its C column sums
MT_FN void finish_row(uint32_t* row, const uint64_t* cols) { sums::ripple<W, C>(row, cols); }

// The last fold of a phase: w = [0][0] table's entry 0 folded with entry 1 at
// r, the table in the block's shared memory or in device memory
MT_FN void last_fold(uint32_t* w, const uint32_t* table, bool shared, const uint32_t (&r)[W],
                     const mont::Modulus<W>& M) {
  uint32_t a[W], b[W];
  load_src(a, table, shared);
  load_src(b, table + W, shared);
  mont::lerp<W>(a, a, b, r, M);
  mont::store<W>(w, a);
}

// The stride of the block rounds' tables in the block's shared memory: the
// folded table of a tail's first fold, at most block_max entries
GP_HD long long shared_stride(long long in_size, long long block_max) {
  const long long half = in_size / 2;
  return half < block_max ? half : block_max;
}

// A phase tail's round k: its step, on the caller's stack (in, in_size
// entries a table in use, in_size apart), on the work buffer (work, in_size /
// 2 apart) or on the block's shared memory (shared, shared_stride apart), with
// a fold in every round but a phase's first (pending false: no challenge
// before round 0). A round whose summed table has at most block_max entries is
// a block round, its fold into shared memory; the round before it summed the
// table it folds, so that table is there too where that round was one.
GP_HD Step tail_step(const uint32_t* in, long long in_size, uint32_t* work, uint32_t* shared,
                     bool pending, long long block_max, int k) {
  // rounds that folded before this one: k, or k - 1 when round 0 did not
  const int folds_before = pending ? k : (k > 0 ? k - 1 : 0);
  Step s;
  s.fold = pending || k > 0;
  s.size = in_size >> folds_before;
  s.block = step_summed(s) <= block_max;
  s.dst = s.block ? shared : work;
  s.dst_stride = s.block ? shared_stride(in_size, block_max) : in_size / 2;
  s.src_shared = folds_before > 0 && s.size <= block_max;
  if (folds_before == 0) {
    s.src = in;
    s.src_stride = in_size;
  } else if (s.src_shared) {
    s.src = shared;
    s.src_stride = shared_stride(in_size, block_max);
  } else {
    s.src = work;
    s.src_stride = in_size / 2;
  }
  return s;
}

// The rounds of a phase tail on a stack of in_size entries a table: every round
// until the summed table has two entries
GP_HD int tail_rounds(long long in_size, bool pending) {
  int log = 0;
  while ((1LL << log) < in_size) ++log;
  return pending ? log - 1 : log;
}

// The digest a steady round k of a tail absorbs first: the caller's state's
// (the last big round's) in round 0, else round k - 1's state's (states: 25
// lanes a round)
MT_FN const uint64_t* tail_digest(const uint64_t* prefix, const uint64_t* states, int k) {
  return k == 0 ? prefix : states + (k - 1) * keccak::kLanes;
}

// The table that a tail's last round summed, which the last fold takes: the
// one it folded into, or the caller's stack where it did not fold (a phase of
// one round); whether it lies in the block's shared memory
MT_FN const uint32_t* last_table(const Step& last) { return last.fold ? last.dst : last.src; }
MT_FN bool last_shared(const Step& last) { return last.fold && last.block; }

}  // namespace gkr_phase
