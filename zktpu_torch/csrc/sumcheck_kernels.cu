// The sumcheck / multilinear hot loops as CUDA kernels for Hopper (sm_90a).
//
// Five kernels, each the counterpart of one Pallas TPU kernel of
// zktpu/field/pallas_kernels.py, on two arithmetic cores. mont_mul and fold
// keep the first design: one thread per field element, the element's W words
// moved as 16-byte vectors and held in registers, arithmetic from field.cuh
// (64-bit C++ products), a grid-stride loop. gkr_round and fold_and_halves run
// on mont.cuh's carry-chain products, and halves_sums does no modular
// arithmetic at all. The three summing kernels reduce across blocks:
// gkr_round by a second launch (finish_rows), halves_sums and fold_and_halves
// in one launch, whose last block of each row finishes it, or whose one block
// finishes both rows on a small table (sums.cuh has their per-thread work).
// Tables are (size, W) uint32 words, element-major; every power-of-two size
// from 2 up is taken.
//
// Plain C interface (loaded with ctypes): every function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for a word count it was not built for). The challenge
// `r` is a DEVICE pointer to W words: in the fused prover it is computed on the
// card from the Keccak digest and never visits the host.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"
#include "mont.cuh"
#include "sums.cuh"

namespace {

constexpr int kThreads = 256;


using zk::Modulus;

// zk::Modulus<W> (field.cuh) or mont::Modulus<W> (mont.cuh): the same words
template <int W, template <int> class Mod = Modulus>
Mod<W> make_modulus(const uint32_t* p_host, uint32_t n0) {
  Mod<W> m;
  for (int j = 0; j < W; ++j) m.p[j] = p_host[j];
  m.n0 = n0;
  return m;
}

// ---------------------------------------------------------------------------
// mont_mul -- replaces zktpu/field/pallas_kernels.py:mont_mul_pallas (:110).
// out[i] = a[i] * b[i] * R^-1 mod p; with b_stride = 0, b is one element that
// multiplies every a[i] (to_mont and from_mont of a whole table).
// Bound on this card: bytes. An element moves 3 * 4W bytes for 2W^2 + W wide
// multiply-adds; at W = 8 that is 96 bytes for 136 products, and the card does
// integer multiply-adds faster than memory delivers the words. The design just
// keeps every word in registers and every access a 16-byte vector.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, long long n, long long b_stride,
                const Modulus<W> m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t x[W], y[W], z[W];
    zk::load_words<W>(x, a + i * W);
    zk::load_words<W>(y, b + i * b_stride);
    zk::mont_mul<W>(z, x, y, m);
    zk::store_words<W>(out + i * W, z);
  }
}

// ---------------------------------------------------------------------------
// fold -- replaces pallas_kernels.py:fold_pallas (:140).
// table (lead, size, W) -> out (lead, size/2, W): out[l, i] = a + r * (b - a)
// with a = table[l, i], b = table[l, i + size/2].
// Bound: bytes (two elements read, one written, one Montgomery product). The
// leading dimension is flattened into the thread index, so one launch folds a
// whole stack of tables (the GKR dense fold will need that).
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ r_ptr,
            uint32_t* __restrict__ out, long long lead, long long half, int log_half,
            const Modulus<W> m) {
  uint32_t r[W];
  zk::load_words<W>(r, r_ptr);
  const long long total = lead * half;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total; g += stride) {
    const long long l = g >> log_half;
    const long long i = g & (half - 1);
    const uint32_t* base = table + (l * 2 * half + i) * W;
    uint32_t a[W], b[W], f[W];
    zk::load_words<W>(a, base);
    zk::load_words<W>(b, base + half * W);
    zk::lerp<W>(f, a, b, r, m);
    zk::store_words<W>(out + g * W, f);
  }
}

// ---------------------------------------------------------------------------
// Reductions. The TPU kernels carry the running sum from grid step to grid step
// in a resident output block; here blocks run in any order and nothing carries
// over. Each block reduces its threads' sums to one row of per-block column
// sums of 64 bits (a 32-bit column over fewer than 2^31 entries fits). Then
// either a small finishing kernel (finish_rows, after gkr_round) or, in
// halves_sums and fold_and_halves, the last block of each row (finish) adds
// the partials and ripples the column sums into clean words. Integer addition
// is associative, so the result is exact and the same on every run.
// ---------------------------------------------------------------------------
template <int W>
__device__ __forceinline__ void block_reduce_store(uint64_t (&acc)[W], uint64_t* dst) {
  __shared__ uint64_t warp_sums[W][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    unsigned long long v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < W) {
    uint64_t s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[threadIdx.x][w];
    dst[threadIdx.x] = s;
  }
}

// partials (k, nb, C) uint64 column sums -> rows (k, W + 1) clean words, C = W
// + 1 columns (gkr_round's). One block per row.
template <int W, int C>
__global__ void __launch_bounds__(kThreads)
finish_rows_kernel(const uint64_t* __restrict__ partials, int nb, uint32_t* __restrict__ rows) {
  __shared__ uint64_t cols[C];
  const int h = blockIdx.x;
  uint64_t acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const uint64_t* row = partials + ((size_t)h * nb + b) * C;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] += row[j];
  }
  block_reduce_store<C>(acc, cols);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t c = 0;
    for (int j = 0; j <= W; ++j) {
      const uint64_t v = (j < C ? cols[j] : 0) + c;
      rows[h * (W + 1) + j] = (uint32_t)v;
      c = v >> 32;
    }
  }
}

// The one-launch summing kernels' epilogue: the shuffles, the fences and the
// ticket (sums.cuh has their two grids and this epilogue's index arithmetic).
//
// column_out: the block's sum of column c, from each lane's shares lo and hi
// (lo from the first half of the block's threads, hi from the second). On the
// (nbr, 2) grid both are the block's row's: their sum goes to the partials. On
// the (1, 1) grid lo is row 0's and hi row 1's, kept in shared memory.
template <int C>
__device__ __forceinline__ void column_out(unsigned long long lo, unsigned long long hi, int c,
                                           uint64_t (&both)[2][C], uint64_t* partials) {
  const bool one_block = gridDim.y == 1;
  if (!one_block) lo += hi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) lo += __shfl_down_sync(0xffffffffu, lo, off);
  if (one_block) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) hi += __shfl_down_sync(0xffffffffu, hi, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (one_block) {
      both[0][c] = lo;
      both[1][c] = hi;
    } else {
      partials[sums::partial_at(blockIdx.y, c, blockIdx.x, C, gridDim.x)] = lo;
    }
  }
}

// finish: on the (1, 1) grid the block ripples both rows into W + 1 clean
// words, with no ticket and no fence (for a small table they would cost more
// than its read). On the (nbr, 2) grid the block takes a ticket of its row,
// and the one that takes the row's last adds the row's partials
// (sums::partial_at) and ripples them, then resets the ticket for the next launch on the
// stream. There a group of G threads adds each column, its thread j the blocks
// j, j + G, .. (eight loads in flight, from L2: no stale L1 line), and shuffles
// within the group finish it. Ordering: the barrier puts the block's partials
// before thread 0's fence and ticket (a fence is cumulative over what the
// barrier ordered), and the last block's fence puts the ticket before its
// reads; without the fences the last block could read stale partials. A ticket
// a row halves the atomics on each and lets the rows finish side by side.
template <int W, int C, int kT>
__device__ __forceinline__ void finish(const uint64_t (&both)[2][C], const uint64_t* partials,
                                       uint32_t* __restrict__ rows,
                                       unsigned* __restrict__ tickets) {
  __shared__ bool last;
  __shared__ uint64_t cols[C];
  __syncthreads();
  if (gridDim.y == 1) {
    if (threadIdx.x < 2) sums::ripple<W, C>(rows + threadIdx.x * (W + 1), both[threadIdx.x]);
    return;
  }
  const int h = blockIdx.y, nbr = gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(tickets + h, 1u) == (unsigned)nbr - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  constexpr int G = sums::kGroup<C, kT>;  // threads a column
  static_assert(G * C <= kT, "a group of threads for every column");
  const int c = threadIdx.x / G, j = threadIdx.x % G;
  unsigned long long s = c < C ? sums::group_share<G>(partials, h, c, C, j, nbr) : 0;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (c < C && j == 0) cols[c] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    sums::ripple<W, C>(rows + h * (W + 1), cols);
    tickets[h] = 0;
  }
}

// ---------------------------------------------------------------------------
// halves_sums -- replaces pallas_kernels.py:halves_sums_pallas (:184).
// Exact integer sums of the first and the second half of a (size, W) table, as
// two rows of W + 1 words. Bound: bytes (the table is read once, nothing but
// 2 (W + 1) words is written); no modular arithmetic.
// Design: a streaming column reduction in one launch. A row's blocks sweep it
// together (a grid-stride loop within the row), four vectors a thread a step,
// at most one wave of resident blocks (the wrapper sizes the grid by the
// card's occupancy). A warp's loads cover 512 contiguous bytes, four loads in
// flight a thread, and a thread's vectors always hold the same word quad of
// their elements, so it keeps four column sums, not W (sums::halves_thread).
// The block gathers the sums in shared memory by column (128 threads a
// column), a warp a column adds them, and the last block of each row finishes
// it. A small table (at most 2^11 entries, the wrapper decides) takes one
// block, half of it a row, which finishes both rows itself.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(sums::kHalvesThreads<W>)
halves_sums_kernel(const uint32_t* __restrict__ table, long long half, uint64_t* partials,
                   uint32_t* __restrict__ rows, unsigned* __restrict__ tickets) {
  constexpr int kT = sums::kHalvesThreads<W>;
  constexpr int kPerColumn = kT / (W / 4);  // 128 threads add into each column
  __shared__ uint64_t cols[W][kPerColumn + 1];
  __shared__ uint64_t both[2][W];
  const int t = threadIdx.x;
  const sums::Lane me = sums::lane_of(gridDim.y == 1, blockIdx.y, t, kT);
  uint64_t s[4] = {0, 0, 0, 0};
  sums::halves_thread<W>(s, table, half, me.h, blockIdx.x, gridDim.x, me.t, me.threads);
#pragma unroll
  for (int k = 0; k < 4; ++k) cols[sums::halves_column<W>(t, k)][sums::halves_slot<W>(t)] = s[k];
  __syncthreads();
  // kT / 32 = W warps: warp w adds column w
  const int w = t >> 5;
  uint64_t lo, hi;
  sums::lane_shares<kPerColumn>(cols[w], t & 31, lo, hi);
  column_out<W>(lo, hi, w, both, partials);
  finish<W, W, kT>(both, partials, rows, tickets);
}

// ---------------------------------------------------------------------------
// fold_and_halves -- replaces pallas_kernels.py:fold_and_halves_pallas (:227).
// One sumcheck round in one pass over the table: fold (size, W) at r into
// (size/2, W), and sum the FOLDED table's two halves on the way out, so the
// folded words are never read back. Bound: bytes (size elements read, size/2
// written), not by much: at W = 8 the products take about 0.6 of the bytes'
// time. Which half a folded element belongs to is decided by its index in the
// folded table (i < size/4).
// Design: one launch on mont.cuh. A row's blocks each take a contiguous run of
// output indices that never straddles size/4 (sums::fold_run), a thread an
// output at a time (sums::fold_thread: mont::lerp, the next output's loads
// issued before this one's product). A thread's running sum is an exact
// integer of W + 1 words carried by addc (mont::acc_add): nine registers and
// nine instructions an element at W = 8, where 64-bit columns take sixteen of
// each. The block gathers the words in shared memory by column, a warp adds a
// column, and the last block of each row finishes it. A small table (at most
// 2^10 entries, the wrapper decides) takes one block, half of it a row, which
// finishes both rows itself. W = 8 takes at most 128 registers (two blocks an
// SM); W = 12, which no path runs, may take more.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(sums::kFoldThreads, W == 8 ? 2 : 1)
fold_and_halves_kernel(const uint32_t* __restrict__ table, const uint32_t* __restrict__ r_ptr,
                       uint32_t* __restrict__ out, long long half, uint64_t* partials,
                       uint32_t* __restrict__ rows, unsigned* __restrict__ tickets,
                       const mont::Modulus<W> m) {
  constexpr int C = W + 1;
  constexpr int kT = sums::kFoldThreads;
  __shared__ uint32_t words[C][kT];
  __shared__ uint64_t both[2][C];
  const int t = threadIdx.x;
  const sums::Lane me = sums::lane_of(gridDim.y == 1, blockIdx.y, t, kT);
  uint32_t r[W];
  mont::load<W>(r, r_ptr);
  uint32_t acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0;
  sums::fold_thread<W>(acc, table, r, out, half, sums::fold_run(me.h, half, blockIdx.x, gridDim.x),
                       me.t, me.threads, m);
#pragma unroll
  for (int j = 0; j < C; ++j) words[j][t] = acc[j];
  __syncthreads();
  for (int c = t >> 5; c < C; c += kT / 32) {
    uint64_t lo, hi;
    sums::lane_shares<kT>(words[c], t & 31, lo, hi);
    column_out<C>(lo, hi, c, both, partials);
  }
  finish<W, C, kT>(both, partials, rows, tickets);
}

// ---------------------------------------------------------------------------
// gkr_round -- replaces pallas_kernels.py:gkr_round_pallas (:292).
// tables (2, 2, size, W): product p, factor f, entry, word. For every index
// i < half = size/2 and every (p, f): a = tables[p][f][i], b = tables[p][f][i + half],
// v_0 = a, v_1 = b, v_2 = b + (b - a) mod p. Row t is the exact integer sum over
// i of term_t(i) = v_t[0][0] * v_t[0][1] + v_t[1][0] * v_t[1][1] mod p (two
// Montgomery products, one modular add), as W + 1 clean words.
// Bound on this card: operations, narrowly. An index costs six Montgomery
// products against 8 elements read; at W = 8 the bytes take about 3/4 as long
// as the multiply-adds (0.040 against 0.053 ms at 2^20 entries).
// Design: one pass. A thread takes an index, loads its eight elements once
// and forms all three round values (mont.cuh, gkr_round_index: product 0's
// three values first, v_2 in a's registers, then product 1's, each term
// summed at once), so the stack crosses memory once. A table too small to fill
// the card is latency-bound instead: where the grid holds a thread for each
// of the 3 half (index, t) pairs (the wrapper sizes it so while the pairs fit
// in one wave of resident threads: up to 2^15 entries on 132 SMs), a thread
// takes one pair (gkr_round_term), two products, not six, in its chain.
// Products run on PTX carry chains (mont.cuh), every value canonical. A
// thread's three running sums are exact integers of W + 1 words carried by
// addc, kept in shared memory (a column of words a thread: no bank conflict),
// not in registers: held there they took the 27 registers that made W = 8
// spill under a 128 cap. The block sums them by columns there (3 (W + 1)
// columns of 64-bit sums) and writes one row of partials per t, which
// finish_rows ripples into clean words. W = 8 takes at most 128 registers (two
// blocks an SM); W = 12, which no path runs, may take the whole register file.
// ---------------------------------------------------------------------------
template <int W>
__global__ void __launch_bounds__(kThreads, W == 8 ? 2 : 1)
gkr_round_kernel(const uint32_t* __restrict__ tables, uint64_t* __restrict__ partials,
                 long long half, const mont::Modulus<W> m) {
  constexpr int C = W + 1;
  // each thread's three running sums, word j of row t at [t][j][thread]
  __shared__ uint32_t sums[3][C][kThreads];
  const int me = threadIdx.x;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < C; ++j) sums[t][j][me] = 0;
  auto add_term = [&](int t, const uint32_t (&term)[W]) {
    uint32_t acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = sums[t][j][me];
    mont::acc_add<W>(acc, term);
#pragma unroll
    for (int j = 0; j < C; ++j) sums[t][j][me] = acc[j];
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + me;
  if (3 * half <= stride) {  // a small table: a thread an (index, t) pair
    if (first < 3 * half)
      mont::gkr_round_term<W>(add_term, (int)(first / half), tables, 2 * half, first % half, m);
  } else {
    for (long long i = first; i < half; i += stride)
      mont::gkr_round_index<W>(add_term, tables, 2 * half, i, m);
  }

  // The block's column sums, from shared memory: column c = t C + j holds
  // kThreads words; eight threads sum a run of 32 each (staggered, so a warp's
  // 32 reads hit 32 banks), and shuffles within the eight add the runs.
  __syncthreads();
  constexpr int kCols = 3 * C;
  constexpr int kRuns = kThreads / 32;
  const uint32_t* flat = &sums[0][0][0];
  for (int base = 0; base < kCols * kRuns; base += kThreads) {
    const int idx = base + me;
    unsigned long long s = 0;
    if (idx < kCols * kRuns) {
      const uint32_t* run = flat + (idx / kRuns) * kThreads + (idx % kRuns) * 32;
#pragma unroll 8
      for (int q = 0; q < 32; ++q) s += run[(q + me) & 31];
    }
#pragma unroll
    for (int off = kRuns / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (idx < kCols * kRuns && idx % kRuns == 0) {
      const int c = idx / kRuns;
      partials[((size_t)(c / C) * gridDim.x + blockIdx.x) * C + c % C] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
int blocks_for(long long n, int cap) {
  long long nb = (n + kThreads - 1) / kThreads;
  if (nb < 1) nb = 1;
  if (nb > cap) nb = cap;
  return (int)nb;
}

// enough resident blocks to fill 132 SMs several times over
constexpr int kMaxBlocks = 132 * 16;

template <int W>
int launch_mont_mul(const void* a, const void* b, void* out, long long n, long long b_stride,
                    const uint32_t* p, uint32_t n0, cudaStream_t s) {
  mont_mul_kernel<W><<<blocks_for(n, kMaxBlocks), kThreads, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, b_stride,
      make_modulus<W>(p, n0));
  return (int)cudaGetLastError();
}

template <int W>
int launch_fold(const void* table, const void* r, void* out, long long lead, long long size,
                const uint32_t* p, uint32_t n0, cudaStream_t s) {
  const long long half = size / 2;
  int log_half = 0;
  while ((1LL << log_half) < half) ++log_half;
  fold_kernel<W><<<blocks_for(lead * half, kMaxBlocks), kThreads, 0, s>>>(
      (const uint32_t*)table, (const uint32_t*)r, (uint32_t*)out, lead, half, log_half,
      make_modulus<W>(p, n0));
  return (int)cudaGetLastError();
}

// The scratch of the one-launch summing kernels, uint64 words: word 0 holds
// the two rows' tickets (uint32 each), zeroed once by the wrapper and reset by
// each row's last block; the partials start at word 2.
constexpr int kScratchPartials = 2;

// nbr blocks a row, or 0 for the one-block grid
dim3 sum_grid(int nbr) { return nbr ? dim3(nbr, 2) : dim3(1, 1); }

template <int W>
int launch_halves_sums(const void* table, void* scratch, void* rows, long long size, int nbr,
                       cudaStream_t s) {
  halves_sums_kernel<W><<<sum_grid(nbr), sums::kHalvesThreads<W>, 0, s>>>(
      (const uint32_t*)table, size / 2, (uint64_t*)scratch + kScratchPartials, (uint32_t*)rows,
      (unsigned*)scratch);
  return (int)cudaGetLastError();
}

template <int W>
int launch_fold_and_halves(const void* table, const void* r, void* out, void* scratch,
                           void* rows, long long size, int nbr, const uint32_t* p, uint32_t n0,
                           cudaStream_t s) {
  fold_and_halves_kernel<W><<<sum_grid(nbr), sums::kFoldThreads, 0, s>>>(
      (const uint32_t*)table, (const uint32_t*)r, (uint32_t*)out, size / 2,
      (uint64_t*)scratch + kScratchPartials, (uint32_t*)rows, (unsigned*)scratch,
      make_modulus<W, mont::Modulus>(p, n0));
  return (int)cudaGetLastError();
}

// Blocks of a summing kernel (which: 0 halves_sums, 1 fold_and_halves, 2
// gkr_round) that the current device holds at once: blocks an SM by the
// kernel's registers and shared memory, times the SMs; a negative CUDA error.
template <int W>
int resident_blocks(int which) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err =
      which == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, halves_sums_kernel<W>, sums::kHalvesThreads<W>, 0)
      : which == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, fold_and_halves_kernel<W>, sums::kFoldThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gkr_round_kernel<W>,
                                                                   kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

template <int W>
int launch_gkr_round(const void* tables, void* partials, void* rows, long long size, int nb,
                     const uint32_t* p, uint32_t n0, cudaStream_t s) {
  gkr_round_kernel<W><<<nb, kThreads, 0, s>>>(
      (const uint32_t*)tables, (uint64_t*)partials, size / 2, make_modulus<W, mont::Modulus>(p, n0));
  int err = (int)cudaGetLastError();
  if (err) return err;
  finish_rows_kernel<W, W + 1><<<3, kThreads, 0, s>>>((const uint64_t*)partials, nb,
                                                      (uint32_t*)rows);
  return (int)cudaGetLastError();
}

}  // namespace

#define ZK_DISPATCH_W(W, CALL8, CALL12) \
  do {                                  \
    if ((W) == 8) return CALL8;         \
    if ((W) == 12) return CALL12;       \
    return -1;                          \
  } while (0)

extern "C" {

// threads per block of mont_mul, fold and gkr_round; the wrappers size the
// partials of gkr_round by it
int zk_block_threads() { return kThreads; }

// threads per block of halves_sums (which = 0) and fold_and_halves (1)
int zk_sum_threads(int which, int W) {
  if (which != 0) return sums::kFoldThreads;
  ZK_DISPATCH_W(W, sums::kHalvesThreads<8>, sums::kHalvesThreads<12>);
}

// resident_blocks above (which: 0 halves_sums, 1 fold_and_halves, 2
// gkr_round), for the current device
int zk_resident_blocks(int which, int W) {
  ZK_DISPATCH_W(W, resident_blocks<8>(which), resident_blocks<12>(which));
}

// uint64 words of scratch that one launch of halves_sums (which = 0) or
// fold_and_halves (1) needs with nbr blocks a row: the tickets, then the
// partials of 2 nbr blocks of W or W + 1 column sums
int zk_sum_scratch_words(int which, int W, int nbr) {
  return kScratchPartials + 2 * (which == 0 ? W : W + 1) * nbr;
}

// b_stride: W for an (n, W) table, 0 for a single element
int zk_mont_mul(const void* a, const void* b, void* out, long long n, long long b_stride, int W,
                const uint32_t* p, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_mont_mul<8>(a, b, out, n, b_stride, p, n0, s),
                launch_mont_mul<12>(a, b, out, n, b_stride, p, n0, s));
}

int zk_fold(const void* table, const void* r, void* out, long long lead, long long size, int W,
            const uint32_t* p, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_fold<8>(table, r, out, lead, size, p, n0, s),
                launch_fold<12>(table, r, out, lead, size, p, n0, s));
}

// scratch: zk_sum_scratch_words(0, W, nbr) uint64 words at least, word 0
// zero (the tickets); rows: (2, W + 1) uint32; nbr blocks a row, at most
// resident_blocks / 2, or 0 for one block that takes both rows (a small
// table's grid)
int zk_halves_sums(const void* table, void* scratch, void* rows, long long size, int nbr, int W,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_halves_sums<8>(table, scratch, rows, size, nbr, s),
                launch_halves_sums<12>(table, scratch, rows, size, nbr, s));
}

// scratch: as for zk_halves_sums, zk_sum_scratch_words(1, W, nbr) words at
// least; out: (size/2, W)
int zk_fold_and_halves(const void* table, const void* r, void* out, void* scratch, void* rows,
                       long long size, int nbr, int W, const uint32_t* p, uint32_t n0,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_fold_and_halves<8>(table, r, out, scratch, rows, size, nbr, p, n0, s),
                launch_fold_and_halves<12>(table, r, out, scratch, rows, size, nbr, p, n0, s));
}

// tables: (2, 2, size, W); partials: (3, nb, W + 1) uint64 scratch; rows: (3, W + 1) uint32
int zk_gkr_round(const void* tables, void* partials, void* rows, long long size, int nb, int W,
                 const uint32_t* p, uint32_t n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ZK_DISPATCH_W(W, launch_gkr_round<8>(tables, partials, rows, size, nb, p, n0, s),
                launch_gkr_round<12>(tables, partials, rows, size, nb, p, n0, s));
}

}  // extern "C"
