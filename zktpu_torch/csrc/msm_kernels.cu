// Pippenger's compaction round and window combine as CUDA kernels for Hopper
// (sm_90a).
//
// zktpu compiles two of its MSM's steps into one XLA program each around the
// Pallas point kernels; the port ran them as eager launches (a cummax, a
// cumsum, a searchsorted, two 144-byte point gathers, a point_add at full width
// and two selects a round; two point launches a window). Here:
//
//   * run_scan -- replaces the scan of zktpu/msm/pippenger.py:_compact_round
//     (:154, jitted at :289) and _max_run (:295): over n sorted int32 keys, each
//     key's rank in its run of equal keys, the survivors' positions (survivor j
//     is the (j + 1)-th rank-even key: srcpos[j], for j < l_next; slots past
//     the survivors get n - 1, as the clamped search gives), the survivor count
//     and the longest run, the last two as device scalars (no read-back). Three
//     passes (compact.cuh has the logic): each block reduces its tiles to one
//     aggregate; one block scans the aggregates; each block scans its tiles
//     again from its prefix and writes the survivors' positions. Bound: bytes
//     (the keys, read twice, and the positions written), no multiply-adds.
//   * compact_add -- replaces the rest of _compact_round (:178-184: the gathers,
//     point_add_px and the selects). A block takes a tile of 256 slots and
//     sorts them by what they do (compact.cuh): survivor j's key and its left
//     and right neighbour's Z words decide a copy of the left, a copy of the
//     right, an addition (fq381::point_add_lane's selection, read where the
//     points lie) or, past the count, a pad (infinity under _MAXKEY). The
//     tile's additions and copies are listed in shared memory in slot order;
//     copies and pads then move 16 bytes a lane on neighbouring addresses, and
//     the additions run densely, one a lane, so lanes that copy never wait on
//     lanes that add. The count is read on the card. Neither the gathered
//     halves nor the full-width sum exist. Bound: operations where slots add
//     finite points (the first round), else bytes (a slot's reads and its 148
//     bytes written).
//   * horner -- replaces _horner_multi (:448, jitted at :466; _horner_single,
//     :431): one launch runs a table of chains, each its own segment's window
//     sums, windows and c (all of a proof's quotient commitments at once), a
//     block a chain: (W - 1) x (c doublings and an addition), the point in
//     the registers of 8 cooperating lanes that split each product
//     (coop381.cuh), canonical between steps. One thread a chain, its state in
//     registers, was slower (PERF.md). Bound: the dependent chain of one
//     segment (the proof has some forty, so the card's rate, nanoseconds, does
//     not bind): 240 doublings and 15 additions at c = 16.
//   * fq_mul_coop -- no TPU counterpart: coop381.cuh's product on its own, a
//     group a product, so that the card's cooperative arithmetic can be held
//     against the field oracle.
//
// Making the scan fast is later work: a single pass with a look-back.
//
// Points are (n, 12) uint32 tables X, Y, Z of canonical Montgomery words over
// BLS12-381 Fq, infinity Z == 0; the modulus is compiled in (fq381.cuh) and the
// launchers check the caller's.
//
// Plain C interface (loaded with ctypes): each function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (-1 for a bad size or count, -2 for a modulus other than
// BLS12-381 Fq's). Outputs must not alias inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "compact.cuh"
#include "coop381.cuh"
#include "fq381.cuh"

namespace {

using compact::Agg;

constexpr int W = fq381::W;
// run_scan: keys a thread, threads a block, keys a block
constexpr int kScanItems = 16;
constexpr int kScanThreads = 256;
constexpr int kScanTile = kScanItems * kScanThreads;
// run_scan's second pass: one block
constexpr int kBlocksThreads = 1024;
// compact_add: threads a block, as point_add (168 registers a thread at most:
// no spill), and slots a thread: a tile of 256 slots. Smaller tiles spread the
// additions, which crowd where the keys' runs are long, over more blocks
// (PERF.md: 16 slots a thread took 2.2x as long on a steady round)
constexpr int kAddThreads = 128;
constexpr int kAddMinBlocks = 3;
constexpr int kAddItems = 2;
constexpr int kAddTile = kAddThreads * kAddItems;
constexpr int kAddNoted = kAddTile + kAddTile / 32;
// 16-byte chunks a thread copies at once (its loads in flight together)
constexpr int kCopyBatch = 6;
// horner and fq_mul_coop: a chain's lanes, 8, each two words of an element (4
// lanes of three words were slower on every chain shape: PERF.md)
constexpr int kDigitWords = 2;
using ChainGroup = coop381::Group<coop381::Lanes<kDigitWords>::G>;
constexpr int kChainLanes = coop381::Lanes<kDigitWords>::G;

__device__ __forceinline__ Agg scan_op(const Agg& a, const Agg& b) {
  return compact::combine(a, b);
}
__device__ __forceinline__ uint32_t scan_op(uint32_t a, uint32_t b) { return a + b; }

// Hillis-Steele inclusive scan of s[0, T) in shared memory, in order
template <int T, typename V>
__device__ void block_scan(V* s) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int d = 1; d < T; d *= 2) {
    const V v = t >= d ? scan_op(s[t - d], s[t]) : s[t];
    __syncthreads();
    s[t] = v;
    __syncthreads();
  }
}

// the aggregate of this thread's tile (identity past the keys)
__device__ Agg thread_tile(const int32_t* key, int32_t n, long long lo) {
  if (lo >= n) return compact::identity();
  const long long hi = lo + kScanItems < n ? lo + kScanItems : n;
  return compact::tile_aggregate(key, (int32_t)lo, (int32_t)hi);
}

// pass 1: the block's aggregate
__global__ void __launch_bounds__(kScanThreads)
run_scan_reduce_kernel(const int32_t* __restrict__ key, int32_t n, Agg* __restrict__ agg) {
  __shared__ Agg s[kScanThreads];
  const int t = threadIdx.x;
  s[t] = thread_tile(key, n, (long long)blockIdx.x * kScanTile + (long long)t * kScanItems);
  __syncthreads();
#pragma unroll 1
  for (int stride = 1; stride < kScanThreads; stride *= 2) {
    if ((t & (2 * stride - 1)) == 0) s[t] = compact::combine(s[t], s[t + stride]);
    __syncthreads();
  }
  if (t == 0) agg[blockIdx.x] = s[0];
}

// pass 2, one block: the blocks' aggregates become their exclusive prefixes,
// in place; the survivor count and a zero longest run for pass 3
__global__ void __launch_bounds__(kBlocksThreads)
run_scan_blocks_kernel(Agg* __restrict__ agg, int32_t blocks, int32_t* __restrict__ count,
                       int32_t* __restrict__ longest) {
  __shared__ Agg s[kBlocksThreads];
  const int t = threadIdx.x;
  Agg carry = compact::identity();
#pragma unroll 1
  for (int32_t base = 0; base < blocks; base += kBlocksThreads) {
    const int32_t b = base + t;
    s[t] = b < blocks ? agg[b] : compact::identity();
    __syncthreads();
    block_scan<kBlocksThreads>(s);
    if (b < blocks) agg[b] = compact::combine(carry, t > 0 ? s[t - 1] : compact::identity());
    carry = compact::combine(carry, s[kBlocksThreads - 1]);
    __syncthreads();
  }
  if (t == 0) {
    *count = carry.lefts[0];
    *longest = 0;
  }
}

// pass 3: each tile from its prefix; the block's longest run into `longest`;
// the slots no survivor reaches get n - 1
__global__ void __launch_bounds__(kScanThreads)
run_scan_apply_kernel(const int32_t* __restrict__ key, int32_t n, const Agg* __restrict__ prefix,
                      int32_t* __restrict__ srcpos, int32_t l_next,
                      const int32_t* __restrict__ count, int32_t* __restrict__ longest) {
  __shared__ Agg s[kScanThreads];
  __shared__ int32_t warp_longest[kScanThreads / 32];
  const int t = threadIdx.x;
  const long long lo = (long long)blockIdx.x * kScanTile + (long long)t * kScanItems;
  s[t] = thread_tile(key, n, lo);
  __syncthreads();
  block_scan<kScanThreads>(s);
  int32_t run = 0;
  if (lo < n) {
    const Agg before =
        compact::combine(prefix[blockIdx.x], t > 0 ? s[t - 1] : compact::identity());
    const long long hi = lo + kScanItems < n ? lo + kScanItems : n;
    run = compact::apply_tile(key, (int32_t)lo, (int32_t)hi, before, srcpos, l_next);
  }
#pragma unroll
  for (int d = 16; d > 0; d /= 2) run = max(run, __shfl_xor_sync(0xffffffffu, run, d));
  if ((t & 31) == 0) warp_longest[t / 32] = run;
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kScanThreads / 32; ++w) run = max(run, warp_longest[w]);
    atomicMax(longest, run);
  }
  const long long stride = (long long)gridDim.x * kScanThreads;
  for (long long j = (long long)*count + (long long)blockIdx.x * kScanThreads + t; j < l_next;
       j += stride) {
    srcpos[j] = n - 1;
  }
}

// a tile of kAddTile slots a block (compact.cuh has the steps)
__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
compact_add_kernel(const int32_t* __restrict__ key, const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y, const uint32_t* __restrict__ z, int32_t n,
                   const int32_t* __restrict__ srcpos, const int32_t* __restrict__ count,
                   int32_t l_next, int32_t max_key, int32_t* __restrict__ okey,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz) {
  __shared__ int32_t kinds[kAddNoted];
  __shared__ int32_t rows[kAddNoted];
  __shared__ uint32_t runs[kAddThreads];
  __shared__ int16_t slot[kAddTile];
  __shared__ int32_t row[kAddTile];
  const int t = threadIdx.x;
  const long long lo = (long long)blockIdx.x * kAddTile;
  const int32_t survivors = *count;
  // each slot's kind, key and source row; neighbouring threads, neighbouring slots
#pragma unroll
  for (int k = 0; k < kAddItems; ++k) {
    const int s = k * kAddThreads + t;
    int32_t k_out, r;
    const uint8_t kind = compact::slot_kind(lo + s, key, z, n, srcpos, survivors, l_next, max_key,
                                            k_out, r);
    if (kind != compact::kNone) okey[lo + s] = k_out;
    kinds[compact::noted(s)] = kind;
    rows[compact::noted(s)] = r;
  }
  __syncthreads();
  // the tile's list: additions at the front, copies at the back, in slot order
  runs[t] = compact::run_counts(kinds, t * kAddItems, kAddItems);
  __syncthreads();
  block_scan<kAddThreads>(runs);
  const uint32_t total = runs[kAddThreads - 1];
  const int adds = (int)(total & (compact::kCopyUnit - 1)), copies = (int)(total >> 16);
  compact::list_run(kinds, rows, t * kAddItems, kAddItems, t > 0 ? runs[t - 1] : 0u, kAddTile,
                    copies, slot, row);
  __syncthreads();
  for (int q = t; q < 9 * copies; q += kAddThreads * kCopyBatch) {
    compact::copy_chunks<kCopyBatch>(q, kAddThreads, copies, slot, row, kAddTile - copies, lo, x,
                                     y, z, ox, oy, oz);
  }
  const long long pad_lo = lo > survivors ? lo : (long long)survivors;
  const long long pad_hi = lo + kAddTile < l_next ? lo + kAddTile : (long long)l_next;
  const int pads = pad_hi > pad_lo ? (int)(pad_hi - pad_lo) : 0;
  for (int q = t; q < 9 * pads; q += kAddThreads) compact::pad_chunk(q, pads, pad_lo, ox, oy, oz);
  for (int e = t; e < adds; e += kAddThreads) {
    compact::add_entry(e, slot, row, lo, x, y, z, ox, oy, oz);
  }
}

// a block a chain: chains[3 b .. 3 b + 2] = its first window's row, its
// windows and c; kChainLanes lanes a chain
__global__ void __launch_bounds__(kChainLanes)
horner_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, const int32_t* __restrict__ chains,
              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz) {
  const int32_t* ch = chains + 3 * blockIdx.x;
  const long long in = (long long)ch[0] * W;
  const long long out = (long long)blockIdx.x * W;
  const auto s = coop381::make_lanes<kDigitWords>(ChainGroup{threadIdx.x});
  coop381::horner_group(s, x + in, y + in, z + in, ch[1], ch[2], ox + out, oy + out, oz + out);
}

// out = a b / R mod p, canonical, a group a product
__global__ void __launch_bounds__(kChainLanes)
fq_mul_coop_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   uint32_t* __restrict__ out) {
  const auto s = coop381::make_lanes<kDigitWords>(ChainGroup{threadIdx.x});
  const long long o = (long long)blockIdx.x * W;
  coop381::Fe<kDigitWords> u, v;
  coop381::load(s, u, a + o);
  coop381::load(s, v, b + o);
  coop381::mul(s, u, u, v);
  coop381::store(s, out + o, u);
}

bool is_fq381(const uint32_t* p_host, uint32_t n0) {
  for (int j = 0; j < W; ++j) {
    if (p_host[j] != fq381::P(j)) return false;
  }
  return n0 == fq381::N0;
}

long long scan_blocks(long long n) { return (n + kScanTile - 1) / kScanTile; }

}  // namespace

extern "C" {

// the int32 words of scratch run_scan needs for n keys (an aggregate a block)
long long zk_run_scan_scratch_words(long long n) {
  return scan_blocks(n) * (long long)(sizeof(Agg) / sizeof(int32_t));
}

// key: n sorted int32 keys, 1 <= n < 2^31; scratch: zk_run_scan_scratch_words(n)
// int32; srcpos: l_next int32, 1 <= l_next < 2^31; count, longest: one int32 each
int zk_run_scan(const void* key, long long n, void* scratch, void* srcpos, long long l_next,
                void* count, void* longest, void* stream) {
  if (n < 1 || n >= (1LL << 31) || l_next < 1 || l_next >= (1LL << 31)) return -1;
  const long long blocks = scan_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  run_scan_reduce_kernel<<<(unsigned)blocks, kScanThreads, 0, st>>>(
      (const int32_t*)key, (int32_t)n, (Agg*)scratch);
  run_scan_blocks_kernel<<<1, kBlocksThreads, 0, st>>>((Agg*)scratch, (int32_t)blocks,
                                                       (int32_t*)count, (int32_t*)longest);
  run_scan_apply_kernel<<<(unsigned)blocks, kScanThreads, 0, st>>>(
      (const int32_t*)key, (int32_t)n, (const Agg*)scratch, (int32_t*)srcpos, (int32_t)l_next,
      (const int32_t*)count, (int32_t*)longest);
  return (int)cudaGetLastError();
}

// key: n int32; x, y, z: n x 12 words; srcpos: l_next int32 (run_scan's);
// count: one int32 on the card; okey: l_next int32; ox, oy, oz: l_next x 12
// words; every point table 16-byte aligned
int zk_compact_add(const void* key, const void* x, const void* y, const void* z, long long n,
                   const void* srcpos, const void* count, long long l_next, int max_key,
                   void* okey, void* ox, void* oy, void* oz, const uint32_t* p, uint32_t n0,
                   void* stream) {
  if (n < 1 || n >= (1LL << 31) || l_next < 1 || l_next >= (1LL << 31)) return -1;
  if (!is_fq381(p, n0)) return -2;
  const long long blocks = (l_next + kAddTile - 1) / kAddTile;
  compact_add_kernel<<<(unsigned)blocks, kAddThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)key, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (int32_t)n, (const int32_t*)srcpos, (const int32_t*)count, (int32_t)l_next, max_key,
      (int32_t*)okey, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

// x, y, z: rows x 12 words, every chain's windows; chains: 3 n_chains int32 on
// the card (a chain's first row, windows >= 1 and c >= 1, its rows inside the
// table); ox, oy, oz: n_chains x 12 words
int zk_horner(const void* x, const void* y, const void* z, long long rows, const void* chains,
              long long n_chains, void* ox, void* oy, void* oz, const uint32_t* p, uint32_t n0,
              void* stream) {
  if (rows < 1 || rows >= (1LL << 31) || n_chains < 1 || n_chains >= (1LL << 31)) return -1;
  if (!is_fq381(p, n0)) return -2;
  horner_kernel<<<(unsigned)n_chains, kChainLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (const int32_t*)chains,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

// a, b, out: n x 12 words (Montgomery, canonical)
int zk_fq_mul_coop(const void* a, const void* b, void* out, long long n, const uint32_t* p,
                   uint32_t n0, void* stream) {
  if (n < 1 || n >= (1LL << 31)) return -1;
  if (!is_fq381(p, n0)) return -2;
  fq_mul_coop_kernel<<<(unsigned)n, kChainLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
