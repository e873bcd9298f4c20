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
//     and the longest run, the last two as device scalars (no read-back). One
//     pass over the keys with a decoupled look-back (compact.cuh has the
//     logic): a block of 128 threads takes a tile of 4,096 keys by ticket,
//     loads them 16 bytes a thread into shared memory, each thread takes its
//     run of 32 into registers; the block scans its threads' aggregates with
//     warp shuffles, publishes the tile's aggregate and, after a look-back over
//     its predecessors on one warp, its prefix; then writes its survivors'
//     positions through shared memory, in order. The tile of the last key
//     writes the count. A second, small kernel fills the slots past the count,
//     moves the longest run out and leaves the scan's state (tickets, records,
//     the running longest run) zero for the next launch: that state lives in a
//     scratch buffer the caller keeps, zero between launches. Bound: bytes (the
//     keys read once, the positions written), no multiply-adds; the kernel is
//     held back by each thread's dependent chain over its keys.
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
// run_scan: keys a thread, threads a block, keys a tile (a block's), its keys
// noted in shared memory after the key before it, its survivors' positions
// staged, noted (4 warps of 32 keys a thread were faster than 256 x 16, 256 x
// 32, 128 x 16, 64 x 32 or 64 x 64: PERF.md)
constexpr int kScanItems = 32;
constexpr int kScanThreads = 128;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanTile = kScanItems * kScanThreads;
constexpr int kScanNoted = kScanTile + 1 + (kScanTile + 1) / 32 + 1;
constexpr int kScanStaged = kScanTile + kScanTile / 32;
// run_scan's fill: threads a block, slots a thread at the least
constexpr int kFillThreads = 256;
constexpr int kFillItems = 4;
constexpr int kFillMaxBlocks = 1024;
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

// The scan's state across its tiles, in the caller's scratch (zero between
// launches): the ticket counter, the running longest run, then a 16-byte
// record a tile, at the same place whatever the key count. A record is one
// Agg with the tile's status in its first word beside has_head, written and
// read as one volatile 16-byte access (the 16-byte tile descriptor of CUB's
// look-back), so a reader that sees a status sees the value published with it,
// and no fence stands between them: a status word behind a fence, read then
// fenced then the value, was a quarter slower (PERF.md). The accesses are
// volatile: a weak load (ld.cg) may be hoisted out of the spin in part by the
// assembler, and the reader then saw the new status beside the old value.
struct ScanState {
  int32_t* ticket;
  int32_t* longest;
  int4* tile;

  __device__ void publish(int32_t t, int32_t s, const Agg& a) const {
    asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(tile + t),
                 "r"(a.has_head | s << 1), "r"(a.last_head), "r"(a.lefts[0]), "r"(a.lefts[1])
                 : "memory");
  }
  __device__ int32_t peek(int32_t t, Agg& v) const {
    int32_t w0, w1, w2, w3;
    asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w0), "=r"(w1), "=r"(w2), "=r"(w3)
                 : "l"(tile + t)
                 : "memory");
    v = Agg{w0 & 1, w1, {w2, w3}};
    return w0 >> 1;
  }
};

// the int32 words of ScanState's scratch for `tiles` tiles
long long scan_state_words(long long tiles) { return 4 + 4 * tiles; }

ScanState scan_state(int32_t* scratch) {
  return ScanState{scratch, scratch + 1, reinterpret_cast<int4*>(scratch + 4)};
}

// one tile a block, taken by ticket (compact.cuh has the steps)
__global__ void __launch_bounds__(kScanThreads)
run_scan_tiles_kernel(const int32_t* __restrict__ key, int32_t n, const ScanState st,
                      int32_t* __restrict__ srcpos, int32_t l_next, int32_t* __restrict__ count) {
  constexpr int T = kScanThreads, I = kScanItems, kTile = kScanTile, kWarps = kScanWarps;
  __shared__ int32_t keys[kScanNoted];
  __shared__ int32_t stage[kScanStaged];
  __shared__ Agg warp_total[kWarps];
  __shared__ Agg tile_before;
  __shared__ int32_t tile_ticket;
  __shared__ int32_t warp_longest[kWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) tile_ticket = atomicAdd(st.ticket, 1);
  __syncthreads();
  const int32_t tile = tile_ticket;
  const int32_t lo = tile * kTile;
  const int32_t hi = n - lo < kTile ? n : lo + kTile;
  // the keys, 16 bytes a thread on neighbouring addresses where the tile is whole
  // and aligned, then each thread's run of I from shared memory
  if (t == 0) keys[0] = lo > 0 ? key[lo - 1] : 0;
  if (hi - lo == kTile && (reinterpret_cast<uintptr_t>(key) & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(key + lo);
#pragma unroll
    for (int r = 0; r < kTile / 4 / T; ++r) {
      const int q = r * T + t;
      const int4 v = __ldg(src + q);
      keys[compact::noted(4 * q + 1)] = v.x;
      keys[compact::noted(4 * q + 2)] = v.y;
      keys[compact::noted(4 * q + 3)] = v.z;
      keys[compact::noted(4 * q + 4)] = v.w;
    }
  } else {
    for (int i = t; i < hi - lo; i += T) keys[compact::noted(i + 1)] = key[lo + i];
  }
  __syncthreads();
  // each thread's run of I keys in registers, the key before it first
  const int32_t t_lo = lo + t * I;
  const int32_t t_hi = hi - t_lo < I ? hi : t_lo + I;
  compact::RunKeys<I> rk;
  rk.lo = t_lo;
#pragma unroll
  for (int j = 0; j <= I; ++j) rk.k[j] = keys[compact::noted(t * I + j)];
  const Agg mine = t_lo < hi ? compact::tile_aggregate<I>(rk, t_lo, t_hi) : compact::identity();
  // the block's scan: each warp's lanes, then the warps' totals in order
  const warp::Group<32> g{(uint32_t)lane};
  const Agg incl = compact::scan_lanes<32>(g, mine);
  const Agg below = compact::shfl_agg(g, incl, lane - 1);
  if (lane == 31) warp_total[w] = incl;
  __syncthreads();
  Agg warps_before = compact::identity(), total = compact::identity();
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    if (v < w) warps_before = compact::combine(warps_before, warp_total[v]);
    total = compact::combine(total, warp_total[v]);
  }
  // the tile's prefix: publish the aggregate, look back, publish the prefix
  if (w == 0) {
    Agg before = compact::identity();
    if (tile == 0) {
      if (lane == 0) st.publish(0, compact::kPrefix, total);
    } else {
      if (lane == 0) st.publish(tile, compact::kAggregate, total);
      before = compact::look_back<32>(g, st, tile);
      if (lane == 0) st.publish(tile, compact::kPrefix, compact::combine(before, total));
    }
    if (lane == 0) {
      tile_before = before;
      if (hi == n) *count = compact::combine(before, total).lefts[0];
    }
  }
  __syncthreads();
  const Agg before = tile_before;
  const int32_t first = before.lefts[0];
  const int32_t end = compact::combine(before, total).lefts[0];
  int32_t run = 0;
  if (t_lo < hi) {
    const Agg mine_before = compact::combine(
        compact::combine(before, warps_before), lane > 0 ? below : compact::identity());
    run = compact::apply_tile<I>(rk, t_lo, t_hi, mine_before, compact::Staged{stage, first},
                                 l_next);
  }
  __syncthreads();
  // the tile's survivors, slots [first, end) below l_next, in order
  const int32_t stop = end < l_next ? end : l_next;
  for (int32_t s = first + t; s < stop; s += T) srcpos[s] = stage[compact::noted(s - first)];
#pragma unroll
  for (int d = 16; d > 0; d /= 2) run = max(run, __shfl_xor_sync(0xffffffffu, run, d));
  if (lane == 0) warp_longest[w] = run;
  __syncthreads();
  if (t == 0) {
    for (int v = 1; v < kWarps; ++v) run = max(run, warp_longest[v]);
    atomicMax(st.longest, run);
  }
}

// after the tiles: the slots no survivor reaches get n - 1; the longest run
// moves out; the scan's state is left zero
__global__ void __launch_bounds__(kFillThreads)
run_scan_fill_kernel(const ScanState st, int32_t tiles, int32_t n, int32_t* __restrict__ srcpos,
                     int32_t l_next, const int32_t* __restrict__ count,
                     int32_t* __restrict__ longest) {
  const long long i = (long long)blockIdx.x * kFillThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kFillThreads;
  for (long long j = *count + i; j < l_next; j += stride) srcpos[j] = n - 1;
  for (long long t = i; t < tiles; t += stride) st.tile[t] = make_int4(0, 0, 0, 0);
  if (i == 0) {
    *longest = *st.longest;
    *st.longest = 0;
    *st.ticket = 0;
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

long long scan_tiles(long long n) { return (n + kScanTile - 1) / kScanTile; }

}  // namespace

extern "C" {

// the int32 words of the scratch run_scan needs for n keys (a 16-byte record
// a tile)
long long zk_run_scan_scratch_words(long long n) { return scan_state_words(scan_tiles(n)); }

// key: n sorted int32 keys, 1 <= n < 2^31; scratch: at least
// zk_run_scan_scratch_words(n) int32, 16-byte aligned, zero (each launch leaves
// it zero again; launches that share it run one after another); srcpos: l_next
// int32, 1 <= l_next < 2^31; count, longest: one int32 each
int zk_run_scan(const void* key, long long n, void* scratch, void* srcpos, long long l_next,
                void* count, void* longest, void* stream) {
  if (n < 1 || n >= (1LL << 31) || l_next < 1 || l_next >= (1LL << 31)) return -1;
  if ((reinterpret_cast<uintptr_t>(scratch) & 15) != 0) return -1;
  const ScanState st = scan_state((int32_t*)scratch);
  const long long tiles = scan_tiles(n);
  cudaStream_t s = (cudaStream_t)stream;
  run_scan_tiles_kernel<<<(unsigned)tiles, kScanThreads, 0, s>>>(
      (const int32_t*)key, (int32_t)n, st, (int32_t*)srcpos, (int32_t)l_next, (int32_t*)count);
  const long long most = l_next > tiles ? l_next : tiles;
  long long fill_blocks = (most + kFillThreads * kFillItems - 1) / (kFillThreads * kFillItems);
  if (fill_blocks > kFillMaxBlocks) fill_blocks = kFillMaxBlocks;
  run_scan_fill_kernel<<<(unsigned)fill_blocks, kFillThreads, 0, s>>>(
      st, (int32_t)tiles, (int32_t)n, (int32_t*)srcpos, (int32_t)l_next, (const int32_t*)count,
      (int32_t*)longest);
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
