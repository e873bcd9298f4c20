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
//     launch, then the last fold, which gives w(r_b). Bound: latency. A
//     round's work is small beside its synchronisation and round_step's
//     chain, so a round's step runs in two passes over each block's run of
//     indices (a thread an entry of the fold, a barrier, a thread a term of
//     the sums: about three products deep, not fourteen), in two tiers
//     (gkr_phase.cuh):
//       - grid rounds (more than block_max entries a table summed): the
//         round's busy blocks fold in place in a work buffer and write their
//         partials; each then adds one to an arrival counter (a release), block
//         0 waits for the round's count (acquires), finishes the round and
//         runs round_step, then publishes the round's number (a release) that
//         the other blocks wait for before the next round. A block that the
//         next round leaves idle returns: the rounds' blocks only shrink.
//       - block rounds: block 0 alone, the stack in its shared memory (16 KB
//         at block_max = 2^7, at most 128 KB), its barriers __syncthreads
//         only, its column sums straight into the finish.
//     A tail whose first round is a block round is one block; a wider one
//     takes its first round's busy blocks, at most the blocks the card holds
//     at once (the occupancy query, with the largest shared memory). The
//     launch is cooperative, so every block that spins is resident; a launch
//     the card cannot hold is refused, and the wrapper raises. One block an
//     SM (142 registers).
//
// gkr_phase.cuh has the per-thread and finishing work and the tiers' plan (it
// builds for the host too); the shuffles, the ticket, the counter and flag,
// the fences and the shared-memory staging are the kernels'. Both take
// BLS12-381 Fr or any 8-word field by value (transcript::Consts: p, n0, R^2
// mod p, 1/2).
//
// Plain C interface (loaded with ctypes): every function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for arguments it does not take). Challenges and
// states are device buffers that never alias: a launch reads the last round's
// and writes its own.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

#include "gkr_phase.cuh"

namespace {

using gkr_phase::C;
using gkr_phase::kRows;
using gkr_phase::kThreads;
using gkr_phase::W;

// the scratch of both kernels, uint64 words, zero between launches: word 0 the
// big round's ticket (its last block resets it), word 1 the tail's arrival
// counter and word 2 its finished rounds (block 0 resets both); the partials
// from word 4
constexpr int kTicket = 0;
constexpr int kArrived = 1;
constexpr int kRoundsDone = 2;
constexpr int kScratchPartials = 4;
// dynamic shared memory of a tail: its block rounds' stack, 4 tables
constexpr size_t kSharedBytesCap = 4 * gkr_phase::kBlockMaxCap * W * sizeof(uint32_t);

using DeviceCounter = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

// A step's terms on this block: work(add_term) hands each of this thread's
// terms on, kept in shared memory (row t, word j of the thread's exact sum
// at [t][j][thread]); then the block's 3 C column sums go to
// out[sums::partial_at(row, column, b, C, nbr)]: the partials of block b of
// nbr, or, with b = 0 and nbr = 1, the columns of a block round. Eight
// threads sum a run of 32 threads' words each (staggered: a warp's reads hit
// 32 banks) and shuffles add the runs (the scheme of gkr_round_kernel); only
// the first `live` threads have terms, and the runs past them are neither
// zeroed nor read.
struct BlockSums {
  uint32_t words[kRows][C][kThreads];
};

template <class Work>
__device__ __forceinline__ void sum_block(BlockSums& sh, int live, int b, int nbr, uint64_t* out,
                                          Work&& work) {
  const int me = threadIdx.x;
  constexpr int kRuns = kThreads / 32;
  const int runs = (live + 31) / 32;
  if (me < 32 * runs) {
#pragma unroll
    for (int t = 0; t < kRows; ++t)
#pragma unroll
      for (int j = 0; j < C; ++j) sh.words[t][j][me] = 0;
  }
  auto add_term = [&](int t, const uint32_t (&term)[W]) {
    uint32_t acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = sh.words[t][j][me];
    mont::acc_add<W>(acc, term);
#pragma unroll
    for (int j = 0; j < C; ++j) sh.words[t][j][me] = acc[j];
  };
  work(add_term);
  __syncthreads();
  constexpr int kCols = kRows * C;
  const uint32_t* flat = &sh.words[0][0][0];
  for (int base = 0; base < kCols * kRuns; base += kThreads) {
    const int idx = base + me;
    unsigned long long v = 0;
    if (idx < kCols * kRuns && idx % kRuns < runs) {
      const uint32_t* run = flat + (idx / kRuns) * kThreads + (idx % kRuns) * 32;
#pragma unroll 8
      for (int q = 0; q < 32; ++q) v += run[(q + me) & 31];
    }
#pragma unroll
    for (int off = kRuns / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (idx < kCols * kRuns && idx % kRuns == 0) {
      const int k = idx / kRuns;
      out[sums::partial_at(k / C, k % C, b, C, nbr)] = v;
    }
  }
}

// The finish's columns: the partials of nbr blocks added by groups of kGroup
// threads, each group's lane 0 keeping its column.
__device__ __forceinline__ void finish_cols(const uint64_t* partials, int nbr,
                                            uint64_t (&cols)[kRows * C]) {
  constexpr int G = gkr_phase::kGroup;
  const int k = threadIdx.x / G, j = threadIdx.x % G;
  unsigned long long v = k < kRows * C ? gkr_phase::finish_share(partials, k, j, nbr) : 0;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (k < kRows * C && j == 0) cols[k] = v;
}

// The finishing step's rows: the columns (3 C in shared memory) added, then
// one thread a row ripples it. rows: (3, C) words in shared memory.
__device__ __forceinline__ void finish_rows(const uint64_t* partials, uint64_t (&cols)[kRows * C],
                                            uint32_t (&rows)[kRows * C]) {
  finish_cols(partials, gridDim.x, cols);
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
  sum_block(sh, kThreads, blockIdx.x, gridDim.x, partials,
            [&](auto& add_term) {
              gkr_phase::step_thread(add_term, step, blockIdx.x, gridDim.x, threadIdx.x, r,
                                     a.consts.M);
            });
  __syncthreads();
  unsigned* ticket = reinterpret_cast<unsigned*>(a.scratch + kTicket);
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
// gkr_phase_tail: the rest of a phase, one launch
// ---------------------------------------------------------------------------
struct TailArgs {
  const uint32_t* in;         // the caller's stack, in_size entries a table
  long long in_size;
  uint32_t* work;             // (4, in_size / 2) entries: the grid rounds' folds, in place
  long long block_max;        // rounds that sum at most this many entries a table: block rounds
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
  uint64_t* scratch;          // the counter and flag, then the partials
  transcript::Consts consts;
};

// Ordering of a grid round: a block's partials and folds, a barrier, thread
// 0's fence and release add to the counter; block 0's thread 0 acquires the
// round's count, a barrier, then its finish reads the partials through L2.
// Block 0's challenge, state and rows, a barrier, thread 0's fence and release
// store of the round's number; a block's thread 0 acquires it, a barrier, then
// its threads read the challenge and the folded stack through L2. Thread 0
// spins alone, on acquire loads (no L1 line), and only on blocks of its own
// launch, all resident.
__global__ void __launch_bounds__(kThreads, 1) gkr_phase_tail_kernel(const TailArgs a) {
  extern __shared__ uint4 block_stack[];  // the block rounds' (4, stride, W) stack
  __shared__ BlockSums sh;
  __shared__ uint64_t cols[kRows * C];
  __shared__ uint32_t rows[kRows * C];
  uint32_t* shared = reinterpret_cast<uint32_t*>(block_stack);
  uint64_t* partials = a.scratch + kScratchPartials;
  DeviceCounter arrived(*reinterpret_cast<unsigned*>(a.scratch + kArrived));
  DeviceCounter rounds_done(*reinterpret_cast<unsigned*>(a.scratch + kRoundsDone));
  const int b = blockIdx.x;
  unsigned expected = 0;  // block 0: the arrivals of the grid rounds so far
  gkr_phase::Step s;
  for (int k = 0; k < a.rounds; ++k) {
    s = gkr_phase::tail_step(a.in, a.in_size, a.work, shared, a.pending, a.block_max, k);
    const int nbr = s.block ? 1 : gkr_phase::step_blocks(s, gridDim.x);
    if (b >= nbr) return;  // idle from here on: a round's blocks never grow
    if (b != 0 && k > 0) {
      if (threadIdx.x == 0) {
        while (rounds_done.load(cuda::memory_order_acquire) < (unsigned)k) {
        }
      }
      __syncthreads();
    }
    uint32_t r[W];
    if (s.fold) gkr_phase::load_l2(r, k == 0 ? a.r_in : a.challenges + (k - 1) * W);
    const sums::Run run = gkr_phase::tail_run(s, b, nbr);
    sum_block(sh, gkr_phase::terms_live(run), b, nbr, s.block ? cols : partials,
              [&](auto& add_term) {
                gkr_phase::fold_thread(s, run, threadIdx.x, r, a.consts.M);
                __syncthreads();
                gkr_phase::terms_thread(add_term, s, run, threadIdx.x, a.consts.M);
              });
    __syncthreads();
    if (!s.block) {
      if (threadIdx.x == 0) {
        __threadfence();
        arrived.fetch_add(1u, cuda::memory_order_release);
      }
      if (b != 0) continue;
      expected += nbr;
      if (threadIdx.x == 0) {
        while (arrived.load(cuda::memory_order_acquire) < expected) {
        }
      }
      __syncthreads();
      finish_cols(partials, nbr, cols);
      __syncthreads();
    }
    if (threadIdx.x < 32) {
      if (threadIdx.x < kRows) {
        gkr_phase::finish_row(rows + threadIdx.x * C, cols + threadIdx.x * C);
      }
      __syncwarp();
      uint32_t* out = a.out_rows + k * kRows * W;
      uint64_t* state = a.states + k * keccak::kLanes;
      uint32_t* challenge = a.challenges + k * W;
      const warp::Group<32> g{threadIdx.x};
      if (s.fold) {
        const uint64_t* digest = gkr_phase::tail_digest(a.prefix, a.states, k);
        transcript::round_step<kRows, false>(g, rows, digest, digest, W / 2, a.consts, out, state,
                                             challenge);
      } else {
        transcript::round_step<kRows, true>(g, rows, a.state_in, a.prefix, a.prefix_lanes,
                                            a.consts, out, state, challenge);
      }
    }
    __syncthreads();
    if (!s.block && threadIdx.x == 0) {
      __threadfence();
      rounds_done.store((unsigned)k + 1, cuda::memory_order_release);
    }
  }
  if (b != 0 || threadIdx.x != 0) return;
  if (expected != 0) {  // every block is past its last wait: zero for the next launch
    arrived.store(0u, cuda::memory_order_relaxed);
    rounds_done.store(0u, cuda::memory_order_relaxed);
  }
  uint32_t r[W];
  gkr_phase::load_l2(r, a.challenges + (a.rounds - 1) * W);
  gkr_phase::last_fold(a.wb, gkr_phase::last_table(s), gkr_phase::last_shared(s), r, a.consts.M);
}

// Allow the tail its largest shared memory (on the current device)
cudaError_t allow_tail_shared() {
  return cudaFuncSetAttribute(gkr_phase_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSharedBytesCap);
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

// blocks of gkr_phase_tail (which = 1; with its largest shared memory) or a
// steady gkr_big_round (0) that the current device holds at once; a negative
// CUDA error
int zk_gkr_phase_resident(int which) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = which ? allow_tail_shared() : cudaSuccess;
  if (err == cudaSuccess) {
    err = which ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, gkr_phase_tail_kernel, kThreads, kSharedBytesCap)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, gkr_big_round_kernel<true>, kThreads, 0);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// uint64 words of scratch for nbr blocks: the ticket, the tail's counter and
// flag, then 3 (W + 1) partials a block
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
  a.step.block = false;
  a.step.src_shared = false;
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

// tables: (2, 2, size, 8); work: (2, 2, size/2, 8), the grid rounds' folds in
// place; r the pending challenge (size >= 4), or null for a phase's first
// round (size >= 2: state_in the host's sponge, prefix its pending tail); with
// r, prefix is the last round's state. out_rows: (rounds, 3, 8) for rounds =
// log2(size) - 1 with r, log2(size) without; states (rounds, 25) lanes;
// challenges (rounds, 8); wb 8 words; scratch zk_gkr_phase_scratch_words(nbr)
// words, words 0-2 zero. A round that sums at most block_max entries a table
// (a power of two, 1 to 2^10; 1: none) runs on one block, in its shared
// memory. A cooperative launch of at most nbr blocks, at most
// zk_gkr_phase_resident(1): one where the first round is a block round, else
// the first round's busy blocks.
int zk_gkr_phase_tail(const void* tables, long long size, void* work, const void* r,
                      const void* state_in, const void* prefix, int prefix_lanes,
                      const uint32_t* p, uint32_t n0, const uint32_t* r2, const uint32_t* inv2,
                      void* out_rows, void* states, void* challenges, void* wb, void* scratch,
                      int nbr, long long block_max, void* stream) {
  const bool pending = r != nullptr;
  if (!pow2_at_least(size, pending ? 4 : 2) || nbr < 1 || prefix_lanes < 0 ||
      prefix_lanes > transcript::kMaxPrefixLanes || !pow2_at_least(block_max, 1) ||
      block_max > gkr_phase::kBlockMaxCap) {
    return -1;
  }
  TailArgs a;
  a.in = (const uint32_t*)tables;
  a.in_size = size;
  a.work = (uint32_t*)work;
  a.block_max = block_max;
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
  const gkr_phase::Step first =
      gkr_phase::tail_step(a.in, size, a.work, nullptr, pending, block_max, 0);
  const int grid = first.block ? 1 : gkr_phase::step_blocks(first, nbr);
  const size_t shared =
      4 * gkr_phase::shared_stride(size, block_max) * W * sizeof(uint32_t);
  cudaError_t err = allow_tail_shared();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)gkr_phase_tail_kernel, dim3(grid), dim3(kThreads),
                                    args, shared, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
