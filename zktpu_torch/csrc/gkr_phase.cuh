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
//   2. the blocks' partials: each block sums its threads' terms into 64-bit
//      column sums, three rows of W + 1 columns, laid out [row][column][block]
//      (sums::partial_at).
//   3. the finishing step, on one block: the partials' columns added (groups
//      of threads, sums::group_share) and rippled into the (3, W + 1) lazy
//      rows (sums::ripple), then transcript::round_step<3, First> on one warp
//      of that block: the canonical coefficients into the round's slot, the
//      absorb, the new state and the next challenge.
// After the phase's last round the [0][0] table of two entries is folded at
// the last challenge into its one entry, w(r_b) after phase 1.
//
// Index i's loads and stores touch entries of i alone, so a fold in place (the
// source and the folded stack in one buffer, one stride) races with nothing
// within a step. Table words are read through L2 (load_l2): another block may
// have written them since this SM last saw them.
//
// Built with nvcc the functions are device code; built with a host C++ compiler
// (tests/test_torch_gkr_phase_kernels.py) the same functions run block by block
// and thread by thread on the host, the grid sync a boundary between steps and
// round_step's warp on warp.cuh's fibers.

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

// One step of a phase: fold `src` (size entries in use) at r into `dst`, or,
// in a phase's first round (fold false), sum `src` as it is: then its stride
// is its size (the caller's stack).
struct Step {
  const uint32_t* src;
  long long src_stride;
  uint32_t* dst;
  long long dst_stride;
  long long size;
  bool fold;
};

// the indices of a step: a folded pair each, or a pair of the stack each
MT_FN long long step_indices(const Step& s) { return s.fold ? s.size / 4 : s.size / 2; }

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

// The finish's thread j of the group of flat column k = row C + column: its
// share of the column over the nbr blocks' partials (the group then adds its
// shares)
MT_FN uint64_t finish_share(const uint64_t* partials, int k, int j, int nbr) {
  return sums::group_share<kGroup>(partials, k / C, k % C, C, j, nbr);
}

// row (W + 1 clean words) from its C column sums
MT_FN void finish_row(uint32_t* row, const uint64_t* cols) { sums::ripple<W, C>(row, cols); }

// The last fold of a phase: w = [0][0] table's entry 0 folded with entry 1 at r
MT_FN void last_fold(uint32_t* w, const uint32_t* table, const uint32_t (&r)[W],
                     const mont::Modulus<W>& M) {
  uint32_t a[W], b[W];
  load_l2(a, table);
  load_l2(b, table + W);
  mont::lerp<W>(a, a, b, r, M);
  mont::store<W>(w, a);
}

// A phase tail's round k (of `rounds`): its step, from the caller's stack
// (in, in_size entries of each table in use, in_stride apart) or the work
// buffer (work, work_stride), with a fold in every round but a phase's first
// (pending false: no challenge before round 0).
MT_FN Step tail_step(const uint32_t* in, long long in_size, long long in_stride, uint32_t* work,
                     long long work_stride, bool pending, int k) {
  // rounds that folded before this one: k, or k - 1 when round 0 did not
  const int folds_before = pending ? k : (k > 0 ? k - 1 : 0);
  const bool fold = pending || k > 0;
  Step s;
  s.fold = fold;
  s.size = in_size >> folds_before;
  s.dst = work;
  s.dst_stride = work_stride;
  if (folds_before == 0) {
    s.src = in;
    s.src_stride = in_stride;
  } else {
    s.src = work;
    s.src_stride = work_stride;
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
// work buffer, or the caller's stack where that round did not fold (a phase
// of one round)
MT_FN const uint32_t* last_table(const uint32_t* in, const uint32_t* work, bool pending,
                                 int rounds) {
  return pending || rounds > 1 ? work : in;
}

}  // namespace gkr_phase
