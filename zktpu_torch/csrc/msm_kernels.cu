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
//     point_add_px and the selects). One thread a slot: survivor j's left and
//     right neighbour read where they lie and added when their keys match
//     (fq381::point_add_lane), else the left copied; slots past the count get
//     infinity and _MAXKEY. The count is read on the card. Neither the gathered
//     halves nor the full-width sum exist. Bound: operations where lanes add
//     finite points, else bytes (a slot's reads and its 148 bytes written).
//   * horner -- replaces _horner_multi (:448, jitted at :466; _horner_single,
//     :431): one thread a segment runs the whole chain, (W - 1) x (c doublings
//     and an addition), between steps through canonical words (fq381.cuh's
//     horner_lane). Bound: one thread's dependent chain of products (a few
//     segments a launch): 240 doublings and 15 additions at c = 16.
//
// Making them fast is later work: a single-pass scan with a look-back, a Horner
// chain spread over a warp.
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
// compact_add: as point_add (168 registers a thread at most: no spill)
constexpr int kSlotThreads = 128;
constexpr int kSlotMinBlocks = 3;
constexpr int kHornerThreads = 32;

// Hillis-Steele inclusive scan of s[0, T) in shared memory, in order
template <int T>
__device__ void block_scan(Agg* s) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int d = 1; d < T; d *= 2) {
    const Agg v = t >= d ? compact::combine(s[t - d], s[t]) : s[t];
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

__global__ void __launch_bounds__(kSlotThreads, kSlotMinBlocks)
compact_add_kernel(const int32_t* __restrict__ key, const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y, const uint32_t* __restrict__ z, int32_t n,
                   const int32_t* __restrict__ srcpos, const int32_t* __restrict__ count,
                   int32_t l_next, int32_t max_key, int32_t* __restrict__ okey,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= l_next) return;
  compact::compact_slot((int32_t)j, key, x, y, z, n, srcpos, *count, max_key, okey, ox, oy, oz);
}

__global__ void __launch_bounds__(kHornerThreads)
horner_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const uint32_t* __restrict__ z, int32_t segments, int windows, int c,
              uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= segments) return;
  const long long in = s * windows * W;
  const long long out = s * W;
  fq381::horner_lane(x + in, y + in, z + in, windows, c, ox + out, oy + out, oz + out);
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
  const long long blocks = (l_next + kSlotThreads - 1) / kSlotThreads;
  compact_add_kernel<<<(unsigned)blocks, kSlotThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)key, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (int32_t)n, (const int32_t*)srcpos, (const int32_t*)count, (int32_t)l_next, max_key,
      (int32_t*)okey, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

// x, y, z: (segments, windows, 12) words; ox, oy, oz: (segments, 12) words;
// segments x windows < 2^31, c >= 1
int zk_horner(const void* x, const void* y, const void* z, long long segments, int windows, int c,
              void* ox, void* oy, void* oz, const uint32_t* p, uint32_t n0, void* stream) {
  if (segments < 1 || windows < 1 || c < 1 || segments * windows >= (1LL << 31)) return -1;
  if (!is_fq381(p, n0)) return -2;
  const long long blocks = (segments + kHornerThreads - 1) / kHornerThreads;
  horner_kernel<<<(unsigned)blocks, kHornerThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (int32_t)segments, windows, c,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz);
  return (int)cudaGetLastError();
}

}  // extern "C"
