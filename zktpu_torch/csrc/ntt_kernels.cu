// The radix-2 NTT as two CUDA kernels for Hopper (sm_90a).
//
// The counterparts of the two Pallas TPU kernels of zktpu/ntt/pallas_ntt.py:
// ntt_phase1 replaces _phase1_kernel (:107), ntt_stage replaces _phase2_stage
// (:154). A transform of n = 2^log_n entries is one ntt_phase1 (the bit-reversal
// gather and stages 1..log_tile inside a tile of 2^log_tile <= 1024 entries)
// followed by one ntt_stage for each stage log_tile + 1 .. log_n.
//
// Tables are (n, 8) uint32 Montgomery words, element-major (the 256-bit fields
// with a two-adic root: BN254 Fr, BLS12-381 Fr). The twiddles are ONE table of
// the n/2 Montgomery powers w^k of the n-th root w (or of its inverse): the
// stage of span m = 2^s reads w_m^j = w^(j n/m) at stride n/m. (The TPU kernels
// take per-stage tables concatenated or tiled up to a tile, which Mosaic's
// BlockSpecs need; nothing here does.) Every power of two from 1 is taken.
//
// A butterfly is u' = u + w v, v' = u - w v with the twiddle on the left of the
// Montgomery product and every output reduced, so the words equal the plain
// PyTorch version's.
//
// Plain C interface (loaded with ctypes): each function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for arguments it does not take). Outputs must not
// alias inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int W = 8;
constexpr int kLogMaxTile = 10;
constexpr int kMaxTile = 1 << kLogMaxTile;
constexpr int kStageThreads = 256;
constexpr int kMaxLogN = 30;

using Mod = zk::Modulus<W>;

// u, v -> u + w v, u - w v (all reduced)
__device__ __forceinline__ void butterfly(uint32_t (&u)[W], uint32_t (&v)[W],
                                          const uint32_t (&w)[W], const Mod& m) {
  uint32_t t[W];
  zk::mont_mul<W>(t, w, v, m);
  zk::sub_mod<W>(v, u, t, m);
  zk::add_mod<W>(u, u, t, m);
}

// ---------------------------------------------------------------------------
// ntt_phase1 -- replaces zktpu/ntt/pallas_ntt.py:_phase1_kernel (:107).
// One block a tile of T = 2^log_tile entries, T/2 threads (one butterfly each a
// stage). Row base + k of the bit-reversed table is x[brev(base + k)]: the block
// gathers its tile straight from x into shared memory (no separate gather pass,
// no uploaded permutation), runs stages 1..log_tile there with a barrier
// between stages, and writes the tile back in one coalesced pass.
// Bound on this card: operations. log_tile products an entry pair against 64
// bytes an entry pair moved; at T = 1024 that is 10 x 272 32-bit multiply-adds
// for 64 bytes. The design keeps the tile in shared memory (32 KB at T = 1024,
// under the 48 KB static limit) so the table crosses device memory once for
// all ten stages; the twiddles (T/2 distinct ones) come from L2.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kMaxTile / 2)
ntt_phase1_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                  uint32_t* __restrict__ out, int log_n, int log_tile, const Mod m) {
  __shared__ __align__(16) uint32_t tile[kMaxTile * W];
  const int size = 1 << log_tile;
  const long long base = (long long)blockIdx.x << log_tile;
  uint32_t a[W];
  for (int k = threadIdx.x; k < size; k += blockDim.x) {
    // a 64-bit shift: log_n = 0 shifts by 32 and gives row 0
    const long long src =
        (long long)((unsigned long long)__brev((unsigned)(base + k)) >> (32 - log_n));
    zk::load_words<W>(a, x + src * W);
    zk::store_words<W>(tile + k * W, a);
  }
  __syncthreads();
  for (int s = 1; s <= log_tile; ++s) {
    const int half = 1 << (s - 1);
    for (int j = threadIdx.x; j < size / 2; j += blockDim.x) {
      const int pos = j & (half - 1);
      const int i0 = ((j >> (s - 1)) << s) + pos;
      uint32_t u[W], v[W], w[W];
      zk::load_words<W>(u, tile + i0 * W);
      zk::load_words<W>(v, tile + (i0 + half) * W);
      zk::load_words<W>(w, tw + ((long long)pos << (log_n - s)) * W);
      butterfly(u, v, w, m);
      zk::store_words<W>(tile + i0 * W, u);
      zk::store_words<W>(tile + (i0 + half) * W, v);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < size; k += blockDim.x) {
    zk::load_words<W>(a, tile + k * W);
    zk::store_words<W>(out + (base + k) * W, a);
  }
}

// ---------------------------------------------------------------------------
// ntt_stage -- replaces pallas_ntt.py:_phase2_stage (:154).
// One stage of span m = 2^stage over the whole table, one thread a butterfly:
// thread j of group g = j / (m/2) reads u = x[g m + pos], v = x[g m + pos + m/2]
// (pos = j mod m/2) and writes u + w v and u - w v to the same rows of `out`,
// so no reassembly follows (the TPU kernel writes two half tables and
// concatenates them per group). Neighbouring threads touch neighbouring rows.
// Bound on this card: bytes. One product against 64 bytes read and 64 written
// a butterfly, plus the stage's m/2 distinct twiddles. The design reads and
// writes every element once as two 16-byte vectors.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kStageThreads)
ntt_stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                 uint32_t* __restrict__ out, long long half_n, int log_n, int stage,
                 const Mod m) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= half_n) return;
  const long long half = 1LL << (stage - 1);
  const long long pos = j & (half - 1);
  const long long i0 = ((j >> (stage - 1)) << stage) + pos;
  uint32_t u[W], v[W], w[W];
  zk::load_words<W>(u, x + i0 * W);
  zk::load_words<W>(v, x + (i0 + half) * W);
  zk::load_words<W>(w, tw + (pos << (log_n - stage)) * W);
  butterfly(u, v, w, m);
  zk::store_words<W>(out + i0 * W, u);
  zk::store_words<W>(out + (i0 + half) * W, v);
}

Mod make_modulus(const uint32_t* p_host, uint32_t n0) {
  Mod m;
  for (int j = 0; j < W; ++j) m.p[j] = p_host[j];
  m.n0 = n0;
  return m;
}

}  // namespace

extern "C" {

// x, out: (2^log_n, 8) words; tw: (2^(log_n - 1), 8) words (unread when
// log_tile = 0); 0 <= log_tile <= min(10, log_n), log_n <= 30
int zk_ntt_phase1(const void* x, const void* tw, void* out, int log_n, int log_tile,
                  const uint32_t* p, uint32_t n0, void* stream) {
  if (log_n < 0 || log_n > kMaxLogN || log_tile < 0 || log_tile > kLogMaxTile ||
      log_tile > log_n)
    return -1;
  const unsigned blocks = 1u << (log_n - log_tile);
  const unsigned threads = log_tile ? 1u << (log_tile - 1) : 1u;
  ntt_phase1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)out, log_n, log_tile,
      make_modulus(p, n0));
  return (int)cudaGetLastError();
}

// x, out: (2^log_n, 8) words; tw: (2^(log_n - 1), 8) words; 1 <= stage <= log_n <= 30
int zk_ntt_stage(const void* x, const void* tw, void* out, int log_n, int stage,
                 const uint32_t* p, uint32_t n0, void* stream) {
  if (log_n > kMaxLogN || stage < 1 || stage > log_n) return -1;
  const long long half_n = 1LL << (log_n - 1);
  const unsigned blocks = (unsigned)((half_n + kStageThreads - 1) / kStageThreads);
  ntt_stage_kernel<<<blocks, kStageThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)out, half_n, log_n, stage,
      make_modulus(p, n0));
  return (int)cudaGetLastError();
}

}  // extern "C"
