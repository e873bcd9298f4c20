// The per-thread work of the two summing kernels of the plain sumcheck,
// halves_sums and fold_and_halves (sumcheck_kernels.cu), the runs of a table
// that each block takes, and the index arithmetic of their epilogue and their
// one-launch finish: the shared columns, the partials' layout, the finish's
// groups and the carry ripple. Only the shuffles, the fences and the ticket
// are the kernels' own.
//
// Both kernels produce two lazy rows of W + 1 words: exact integer sums of a
// table's two halves (halves_sums), or of the folded table's two halves
// (fold_and_halves). Two grids:
//   * (nbr, 2): blockIdx.y is the row, and the nbr blocks of a row share it
//     (halves_sums: the row's threads sweep it together, a grid-stride loop;
//     fold_and_halves: each block a contiguous run, block_run), so a block
//     feeds one row. A block sums its threads' work into C column sums of 64
//     bits (C = W for
//     halves_sums, W + 1 for fold_and_halves) and writes them to the partials,
//     laid out [row][column][block]; the last block of the row to finish adds
//     them column by column and ripples the row into clean words (ripple).
//   * (1, 1), for small tables: the block's first half of threads takes row 0
//     whole, its second half row 1, and the block ripples both rows itself.
// lane_of says which row and which part of it a thread takes. Integer addition
// is associative, so the rows are the same whatever order the blocks run in.
//
// Built with nvcc the functions are device code; built with a host C++ compiler
// (tests/test_torch_sums.py) the same functions run block by block and thread
// by thread on the host, with the arithmetic of carry.cuh's emulation.

#pragma once

#include <cstddef>
#include <cstdint>

#include "mont.cuh"

namespace sums {

using namespace carry;

// Threads a block of halves_sums: 32 W is a multiple of the W / 4 vectors of an
// element, so the vectors a thread reads sit on one word quad (halves_thread).
template <int W>
constexpr int kHalvesThreads = 32 * W;

// Threads a block of fold_and_halves.
constexpr int kFoldThreads = 256;

// A block's run is a whole number of this many entries (but the last of a
// row), so a warp's vectors start on a 512-byte boundary where the row does.
constexpr long long kRunAlign = 32;

struct Run {
  long long begin, end;
};

// A thread's row, its index among the threads of its row in the block, and
// their count (the stride of its loop), in a block of kT threads.
struct Lane {
  int h, t, threads;
};

MT_FN Lane lane_of(bool one_block, int block_row, int t, int kT) {
  if (one_block) return {t >= kT / 2, t % (kT / 2), kT / 2};
  return {block_row, t, kT};
}

// Block b's part of the entries [lo, hi) that nbr blocks share: equal runs of
// whole kRunAlign entries, in order; the last runs may be short or empty.
MT_FN Run block_run(long long lo, long long hi, int b, int nbr) {
  const long long len = hi - lo;
  long long per = (len + nbr - 1) / nbr;
  per = (per + kRunAlign - 1) / kRunAlign * kRunAlign;
  long long begin = (long long)b * per;
  if (begin > len) begin = len;
  long long end = begin + per;
  if (end > len) end = len;
  return {lo + begin, lo + end};
}

// ----------------------------------------------------------------------
// halves_sums: row h sums the table's entries [h half, (h + 1) half)
// ----------------------------------------------------------------------

// The column of word k of the vectors thread t reads.
template <int W>
MT_FN int halves_column(int t, int k) {
  return 4 * (t % (W / 4)) + k;
}

// s[k] += word k of every 16-byte vector of row h that thread t of block b
// reads, `threads` threads a block and nbr blocks a row: the row's vectors g,
// g + S, g + 2S, .. with g = b threads + t and S = nbr threads, so the row's
// threads sweep it together, a warp's load covers 512 contiguous bytes and, S
// being a multiple of W / 4, every vector a thread reads holds the same word
// quad of its element (halves_column). Four loads are issued before their
// words are added, the row's ragged end included (a vector past it reads as
// zeros).
template <int W>
MT_FN void halves_thread(uint64_t (&s)[4], const uint32_t* __restrict__ table, long long half,
                         int h, int b, int nbr, int t, int threads) {
  constexpr int Q = W / 4;
  const uint4* v = reinterpret_cast<const uint4*>(table) + h * half * Q;
  const long long end = half * Q;
  const long long stride = (long long)nbr * threads;
  for (long long i = (long long)b * threads + t; i < end; i += 4 * stride) {
    uint4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long at = i + u * stride;
      x[u] = at < end ? v[at] : uint4{0, 0, 0, 0};
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[0] += x[u].x;
      s[1] += x[u].y;
      s[2] += x[u].z;
      s[3] += x[u].w;
    }
  }
}

// ----------------------------------------------------------------------
// fold_and_halves: output entry i < half = size / 2 is folded from table
// entries i and i + half; row h sums the outputs [h quarter, h ? half :
// quarter), quarter = half / 2 (at size 2 row 0 is empty, row 1 the one output)
// ----------------------------------------------------------------------

MT_FN Run fold_run(int h, long long half, int b, int nbr) {
  const long long quarter = half / 2;
  return block_run(h * quarter, h ? half : quarter, b, nbr);
}

// Thread t's outputs of the run, i = begin + t, + threads, ..: out[i] =
// a + r (b - a) with mont::lerp, and acc, an exact integer of W + 1 words, +=
// out[i]. The next output's two elements are loaded before this one's
// product, so the loads are in flight while the carry chain runs. a, b and r
// canonical, as the prover's tables and challenges are.
template <int W>
MT_FN void fold_thread(uint32_t (&acc)[W + 1], const uint32_t* __restrict__ table,
                       const uint32_t (&r)[W], uint32_t* __restrict__ out, long long half, Run run,
                       int t, int threads, const mont::Modulus<W>& M) {
  long long i = run.begin + t;
  if (i >= run.end) return;
  uint32_t a[W], b[W];
  mont::load<W>(a, table + i * W);
  mont::load<W>(b, table + (i + half) * W);
  for (;;) {
    const long long next = i + threads;
    const bool more = next < run.end;
    uint32_t na[W], nb[W];
    if (more) {
      mont::load<W>(na, table + next * W);
      mont::load<W>(nb, table + (next + half) * W);
    }
    mont::lerp<W>(a, a, b, r, M);
    mont::store<W>(out + i * W, a);
    mont::acc_add<W>(acc, a);
    if (!more) break;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      a[j] = na[j];
      b[j] = nb[j];
    }
    i = next;
  }
}

// ----------------------------------------------------------------------
// the block's epilogue and the finish
// ----------------------------------------------------------------------

// The slot of halves_sums thread t in its block's shared columns: its sum of
// word k goes to column halves_column(t, k) at this slot. A column has kT / (W
// / 4) = 128 slots, and those below 64 come from the first half of the block's
// threads (row 0's on the one-block grid).
template <int W>
MT_FN int halves_slot(int t) {
  return t / (W / 4);
}

// A lane's shares of one column of N per-thread values in shared memory (N a
// multiple of 64, the first N / 2 from the first half of the block's threads):
// lo sums col[lane + 32 q] over the first half, hi over the second. A warp's
// reads hit 32 consecutive words. The warp then adds its lanes' shares
// (shuffles on the card).
template <int N, typename T>
MT_FN void lane_shares(const T* col, int lane, uint64_t& lo, uint64_t& hi) {
  lo = hi = 0;
#pragma unroll
  for (int q = 0; q < N / 64; ++q) {
    lo += col[lane + 32 * q];
    hi += col[lane + 32 * q + N / 2];
  }
}

// Where block b's sum of column c of row h lies among the partials of a grid
// of nbr blocks a row, C columns: [row][column][block], so the blocks of a
// column are contiguous for the finish.
MT_FN size_t partial_at(int h, int c, int b, int C, int nbr) {
  return ((size_t)h * C + c) * nbr + b;
}

// Threads that add one column of the partials in the finish of a block of kT
// threads, C columns (a power of two that divides 32).
template <int C, int kT>
constexpr int kGroup = kT / C >= 32 ? 32 : kT / C >= 16 ? 16 : 8;

// A partial read through L2 only (no stale L1 line of another block's writes).
MT_FN uint64_t load_l2(const uint64_t* p) {
#ifdef __CUDACC__
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
#else
  return *p;
#endif
}

// Thread j of the group of column c, row h, in the finish: its share of the
// column, the blocks j, j + G, .. of nbr (eight loads in flight). The group
// then adds its threads' shares (shuffles on the card).
template <int G>
MT_FN uint64_t group_share(const uint64_t* partials, int h, int c, int C, int j, int nbr) {
  const uint64_t* part = partials + partial_at(h, c, 0, C, nbr);
  uint64_t s = 0;
#pragma unroll 8
  for (int b = j; b < nbr; b += G) s += load_l2(part + b);
  return s;
}

// row (W + 1 clean words) = the integer whose word j has column sum cols[j], j
// < C (C = W or W + 1): the carries rippled up. Each column sum is below 2^63,
// so a column plus the carry into it fits 64 bits.
template <int W, int C>
MT_FN void ripple(uint32_t* row, const uint64_t* cols) {
  uint64_t c = 0;
  for (int j = 0; j <= W; ++j) {
    const uint64_t v = (j < C ? cols[j] : 0) + c;
    row[j] = (uint32_t)v;
    c = v >> 32;
  }
}

}  // namespace sums
