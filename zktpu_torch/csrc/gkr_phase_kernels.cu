// zktpu's fused GKR phase program as two CUDA kernels for Hopper (sm_90a).
//
// zktpu runs each sumcheck phase of a lazy GKR layer as a handful of compiled
// XLA programs (zktpu/gkr/fused_lazy.py): one _big_round (:216) for each round
// whose table is above its SCAN_SIZE, then one _scan_phase_fixed (:155) for
// every remaining round of the phase. Here:
//
//   * gkr_big_round -- replaces _big_round. One round in one launch: fold the
//     stack at the last round's challenge, sum the folded stack's lazy rows on
//     the way out, and in the last block to finish (elected by a ticket) add
//     the blocks' partials and run round_step on one warp. Bound: bytes and
//     operations of the fold and sums, by operations at W = 8 (fourteen
//     Montgomery products an index, against 16 elements read and 8 written),
//     plus round_step's one-warp chain, which no other block shares.
//   * gkr_phase_tail -- replaces _scan_phase_fixed. Every round of a phase from
//     a table at or below the caller's threshold down to one entry, in one
//     cooperative launch: per round the fused step on every block, a grid
//     sync, the finishing step on block 0, another grid sync; then the last
//     fold gives w(r_b). Bound: latency. Each round's work is a few thousand
//     indices at most, so its time is two grid syncs and round_step's chain.
//     The stack is folded in place in a work buffer (gkr_phase.cuh: an index
//     touches its own entries only). The grid is at most the blocks the card
//     holds at once (the occupancy query); a launch the card cannot hold is
//     refused, and the wrapper raises. One block an SM: under the 128
//     registers of two, the round loop beside the fused step spilled.
//
// gkr_phase.cuh has the per-thread and finishing work (it builds for the host
// too); the shuffles, the ticket, the fences and the grid syncs are the
// kernels'. Both take BLS12-381 Fr or any 8-word field by value
// (transcript::Consts: p, n0, R^2 mod p, 1/2).
//
// Plain C interface (loaded with ctypes): every function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for arguments it does not take). Challenges and
// states are device buffers that never alias: a launch reads the last round's
// and writes its own.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "gkr_phase.cuh"

namespace {

namespace cg = cooperative_groups;
using gkr_phase::C;
using gkr_phase::kRows;
using gkr_phase::kThreads;
using gkr_phase::W;

// the scratch of both kernels, uint64 words: word 0 the big round's ticket
// (zero between launches: the last block resets it), the partials from word 2
constexpr int kScratchPartials = 2;

// The fused step's terms of this thread, kept in shared memory (row t, word j
// of the thread's exact sum at [t][j][thread]), then the block's 3 C column
// sums into the partials: eight threads sum a run of 32 threads' words each
// (staggered: a warp's reads hit 32 banks) and shuffles add the runs (the
// scheme of gkr_round_kernel).
struct BlockSums {
  uint32_t words[kRows][C][kThreads];
};

__device__ __forceinline__ void step_block(BlockSums& sh, const gkr_phase::Step& s,
                                           const uint32_t (&r)[W], const mont::Modulus<W>& M,
                                           uint64_t* partials) {
  const int me = threadIdx.x;
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int j = 0; j < C; ++j) sh.words[t][j][me] = 0;
  auto add_term = [&](int t, const uint32_t (&term)[W]) {
    uint32_t acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = sh.words[t][j][me];
    mont::acc_add<W>(acc, term);
#pragma unroll
    for (int j = 0; j < C; ++j) sh.words[t][j][me] = acc[j];
  };
  gkr_phase::step_thread(add_term, s, blockIdx.x, gridDim.x, me, r, M);
  __syncthreads();
  constexpr int kCols = kRows * C;
  constexpr int kRuns = kThreads / 32;
  const uint32_t* flat = &sh.words[0][0][0];
  for (int base = 0; base < kCols * kRuns; base += kThreads) {
    const int idx = base + me;
    unsigned long long v = 0;
    if (idx < kCols * kRuns) {
      const uint32_t* run = flat + (idx / kRuns) * kThreads + (idx % kRuns) * 32;
#pragma unroll 8
      for (int q = 0; q < 32; ++q) v += run[(q + me) & 31];
    }
#pragma unroll
    for (int off = kRuns / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (idx < kCols * kRuns && idx % kRuns == 0) {
      const int k = idx / kRuns;
      partials[sums::partial_at(k / C, k % C, blockIdx.x, C, gridDim.x)] = v;
    }
  }
}

// The finishing step's rows: the partials' 3 C columns added by groups of
// kGroup threads, each group's lane 0 keeping its column, then one thread a
// row ripples it. rows: (3, C) words in shared memory.
__device__ __forceinline__ void finish_rows(const uint64_t* partials, uint64_t (&cols)[kRows * C],
                                            uint32_t (&rows)[kRows * C]) {
  constexpr int G = gkr_phase::kGroup;
  const int k = threadIdx.x / G, j = threadIdx.x % G;
  unsigned long long v = k < kRows * C ? gkr_phase::finish_share(partials, k, j, gridDim.x) : 0;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (k < kRows * C && j == 0) cols[k] = v;
  __syncthreads();
  if (threadIdx.x < kRows) gkr_phase::finish_row(rows + threadIdx.x * C, cols + threadIdx.x * C);
  __syncthreads();
}

// round_step on warp 0 of the block
template <bool First>
__device__ __forceinline__ void round_on_warp0(const uint32_t* rows, const uint64_t* state_in,
                                               const uint64_t* prefix, int prefix_lanes,
                                               const transcript::Consts& consts,
                                               uint32_t* out_rows, uint64_t* state_out,
                                               uint32_t* challenge) {
  if (threadIdx.x < 32) {
    transcript::round_step<kRows, First>(warp::Group<32>{threadIdx.x}, rows, state_in, prefix,
                                         prefix_lanes, consts, out_rows, state_out, challenge);
  }
}

// ---------------------------------------------------------------------------
// gkr_big_round: one round, one launch
// ---------------------------------------------------------------------------
struct BigArgs {
  gkr_phase::Step step;
  const uint32_t* r_in;       // the last round's challenge (a fold), else unused
  const uint64_t* state_in;   // the host's sponge (a phase's first round)
  const uint64_t* prefix;     // the pending tail, or the last state's digest
  int prefix_lanes;
  uint32_t* out_rows;         // (3, W): the round's canonical coefficients
  uint64_t* state_out;        // 25 lanes
  uint32_t* challenge;        // W words, Montgomery form
  uint64_t* scratch;          // the ticket, then the partials
  transcript::Consts consts;
};

// Ordering, as in sumcheck_kernels.cu's finish: the barrier puts the block's
// partials before thread 0's fence and ticket, and the last block's fence puts
// the ticket before its reads of the partials (through L2). One instantiation
// a kind of round (Fold: a.step.fold), so each holds one step's code: both in
// one kernel spilled under the 128 registers of two blocks an SM.
template <bool Fold>
__global__ void __launch_bounds__(kThreads, 2) gkr_big_round_kernel(const BigArgs a) {
  __shared__ BlockSums sh;
  __shared__ uint64_t cols[kRows * C];
  __shared__ uint32_t rows[kRows * C];
  __shared__ bool last;
  gkr_phase::Step step = a.step;
  step.fold = Fold;
  uint32_t r[W];
  if constexpr (Fold) gkr_phase::load_l2(r, a.r_in);
  uint64_t* partials = a.scratch + kScratchPartials;
  step_block(sh, step, r, a.consts.M, partials);
  __syncthreads();
  unsigned* ticket = reinterpret_cast<unsigned*>(a.scratch);
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  finish_rows(partials, cols, rows);
  if (threadIdx.x == 0) *ticket = 0;
  if constexpr (Fold) {
    round_on_warp0<false>(rows, a.state_in, a.prefix, W / 2, a.consts, a.out_rows, a.state_out,
                          a.challenge);
  } else {
    round_on_warp0<true>(rows, a.state_in, a.prefix, a.prefix_lanes, a.consts, a.out_rows,
                         a.state_out, a.challenge);
  }
}

// ---------------------------------------------------------------------------
// gkr_phase_tail: the rest of a phase, one cooperative launch
// ---------------------------------------------------------------------------
struct TailArgs {
  const uint32_t* in;         // the caller's stack, in_size entries a table
  long long in_size, in_stride;
  uint32_t* work;             // (4, in_size / 2) entries: the folds, in place
  bool pending;               // a challenge waits: round 0 folds at r_in
  const uint32_t* r_in;
  const uint64_t* state_in;   // the host's sponge (pending false)
  const uint64_t* prefix;     // the pending tail, or the last state's digest
  int prefix_lanes;
  int rounds;
  uint32_t* out_rows;         // (rounds, 3, W)
  uint64_t* states;           // (rounds, 25): round k's state
  uint32_t* challenges;       // (rounds, W): round k's challenge
  uint32_t* wb;               // W words: the [0][0] table folded to one entry
  uint64_t* scratch;          // the partials from word 2
  transcript::Consts consts;
};

__global__ void __launch_bounds__(kThreads, 1) gkr_phase_tail_kernel(const TailArgs a) {
  __shared__ BlockSums sh;
  __shared__ uint64_t cols[kRows * C];
  __shared__ uint32_t rows[kRows * C];
  cg::grid_group grid = cg::this_grid();
  uint64_t* partials = a.scratch + kScratchPartials;
  const long long work_stride = a.in_size / 2;
  for (int k = 0; k < a.rounds; ++k) {
    const gkr_phase::Step s =
        gkr_phase::tail_step(a.in, a.in_size, a.in_stride, a.work, work_stride, a.pending, k);
    uint32_t r[W];
    if (s.fold) gkr_phase::load_l2(r, k == 0 ? a.r_in : a.challenges + (k - 1) * W);
    step_block(sh, s, r, a.consts.M, partials);
    grid.sync();
    if (blockIdx.x == 0) {
      finish_rows(partials, cols, rows);
      uint32_t* out = a.out_rows + k * kRows * W;
      uint64_t* state = a.states + k * keccak::kLanes;
      uint32_t* challenge = a.challenges + k * W;
      if (s.fold) {
        const uint64_t* digest = gkr_phase::tail_digest(a.prefix, a.states, k);
        round_on_warp0<false>(rows, digest, digest, W / 2, a.consts, out, state, challenge);
      } else {
        round_on_warp0<true>(rows, a.state_in, a.prefix, a.prefix_lanes, a.consts, out, state,
                             challenge);
      }
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    uint32_t r[W];
    gkr_phase::load_l2(r, a.challenges + (a.rounds - 1) * W);
    gkr_phase::last_fold(a.wb, gkr_phase::last_table(a.in, a.work, a.pending, a.rounds), r,
                         a.consts.M);
  }
}

transcript::Consts make_consts(const uint32_t* p, uint32_t n0, const uint32_t* r2,
                               const uint32_t* inv2) {
  transcript::Consts c;
  for (int j = 0; j < W; ++j) {
    c.M.p[j] = p[j];
    c.r2[j] = r2[j];
    c.inv2[j] = inv2[j];
  }
  c.M.n0 = n0;
  return c;
}

bool pow2_at_least(long long n, long long least) { return n >= least && (n & (n - 1)) == 0; }

}  // namespace

extern "C" {

// threads a block of both kernels
int zk_gkr_phase_threads() { return kThreads; }

// blocks of gkr_phase_tail (which = 1) or a steady gkr_big_round (0) that the
// current device holds at once; a negative CUDA error
int zk_gkr_phase_resident(int which) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = which ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                &per_sm, gkr_phase_tail_kernel, kThreads, 0)
                          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                &per_sm, gkr_big_round_kernel<true>, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// uint64 words of scratch for nbr blocks: the ticket, then 3 (W + 1) partials a block
int zk_gkr_phase_scratch_words(int nbr) { return kScratchPartials + kRows * C * nbr; }

// tables: (2, 2, size, 8) uint32 words, size >= 4 with a fold (r not null),
// >= 2 without (a phase's first round: state_in the host's sponge, prefix its
// pending tail of prefix_lanes lanes); out: (size/2 entries a table, the same
// layout) the folded stack (unused without a fold). With a fold, prefix is the
// last round's state (its digest). out_rows (3, 8); state_out 25 lanes;
// challenge 8 words; scratch zk_gkr_phase_scratch_words(nbr) words, word 0
// zero. nbr blocks, at most what the scratch holds.
int zk_gkr_big_round(const void* tables, long long size, const void* r, void* out,
                     const void* state_in, const void* prefix, int prefix_lanes, const uint32_t* p,
                     uint32_t n0, const uint32_t* r2, const uint32_t* inv2, void* out_rows,
                     void* state_out, void* challenge, void* scratch, int nbr, void* stream) {
  const bool fold = r != nullptr;
  if (!pow2_at_least(size, fold ? 4 : 2) || nbr < 1 || prefix_lanes < 0 ||
      prefix_lanes > transcript::kMaxPrefixLanes) {
    return -1;
  }
  BigArgs a;
  a.step.src = (const uint32_t*)tables;
  a.step.src_stride = size;
  a.step.dst = (uint32_t*)out;
  a.step.dst_stride = size / 2;
  a.step.size = size;
  a.step.fold = fold;
  a.r_in = (const uint32_t*)r;
  a.state_in = (const uint64_t*)state_in;
  a.prefix = (const uint64_t*)prefix;
  a.prefix_lanes = prefix_lanes;
  a.out_rows = (uint32_t*)out_rows;
  a.state_out = (uint64_t*)state_out;
  a.challenge = (uint32_t*)challenge;
  a.scratch = (uint64_t*)scratch;
  a.consts = make_consts(p, n0, r2, inv2);
  if (fold) {
    gkr_big_round_kernel<true><<<nbr, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    gkr_big_round_kernel<false><<<nbr, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// tables: (2, 2, size, 8); work: (2, 2, size/2, 8), folded in place; r the
// pending challenge (size >= 4), or null for a phase's first round (size >= 2:
// state_in the host's sponge, prefix its pending tail); with r, prefix is the
// last round's state. out_rows: (rounds, 3, 8) for rounds = log2(size) - 1 with
// r, log2(size) without; states (rounds, 25) lanes; challenges (rounds, 8); wb
// 8 words; scratch zk_gkr_phase_scratch_words(nbr) words. nbr blocks, at most
// zk_gkr_phase_resident(1): a cooperative launch.
int zk_gkr_phase_tail(const void* tables, long long size, void* work, const void* r,
                      const void* state_in, const void* prefix, int prefix_lanes,
                      const uint32_t* p, uint32_t n0, const uint32_t* r2, const uint32_t* inv2,
                      void* out_rows, void* states, void* challenges, void* wb, void* scratch,
                      int nbr, void* stream) {
  const bool pending = r != nullptr;
  if (!pow2_at_least(size, pending ? 4 : 2) || nbr < 1 || prefix_lanes < 0 ||
      prefix_lanes > transcript::kMaxPrefixLanes) {
    return -1;
  }
  TailArgs a;
  a.in = (const uint32_t*)tables;
  a.in_size = size;
  a.in_stride = size;
  a.work = (uint32_t*)work;
  a.pending = pending;
  a.r_in = (const uint32_t*)r;
  a.state_in = (const uint64_t*)state_in;
  a.prefix = (const uint64_t*)prefix;
  a.prefix_lanes = prefix_lanes;
  a.rounds = gkr_phase::tail_rounds(size, pending);
  a.out_rows = (uint32_t*)out_rows;
  a.states = (uint64_t*)states;
  a.challenges = (uint32_t*)challenges;
  a.wb = (uint32_t*)wb;
  a.scratch = (uint64_t*)scratch;
  a.consts = make_consts(p, n0, r2, inv2);
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)gkr_phase_tail_kernel, dim3(nbr),
                                                dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
