// The radix-2 NTT as two CUDA kernels for Hopper (sm_90a).
//
// The counterparts of the two Pallas TPU kernels of zktpu/ntt/pallas_ntt.py:
// ntt_phase1 replaces _phase1_kernel (:107), ntt_stage replaces _phase2_stage
// (:154). A transform of n = 2^log_n entries is one ntt_phase1 (the bit-reversal
// gather and stages 1..log_tile inside a tile of 2^log_tile <= 1024 entries)
// followed by one ntt_stage for each stage log_tile + 1 .. log_n.
//
// Tables are (n, 8) uint32 Montgomery words, element-major (the 256-bit fields
// with a two-adic root: BN254 Fr, BLS12-381 Fr). ntt_stage reads ONE table of
// the n/2 Montgomery powers w^k of the n-th root w (or of its inverse): the
// stage of span m = 2^s reads w_m^j = w^(j n/m) at stride n/m. ntt_phase1 reads
// the compact table of the powers of the 2^c-th root, c = min(10, log_n), that
// its stages need: entry j = w^(j n / 2^c), j < 2^(c-1), which ntt_kernels.py
// gathers from the big one. (The TPU kernels take per-stage tables
// concatenated or tiled up to a tile, which Mosaic's BlockSpecs need; nothing
// here does.) Every power of two from 1 is taken.
//
// A butterfly is u' = u + w v, v' = u - w v with every output reduced, so the
// words equal the plain PyTorch version's. ntt_phase1 runs on mont.cuh's
// carry-chain core, ntt_stage on field.cuh's 64-bit C++ products.
//
// Plain C interface (loaded with ctypes): each function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for arguments it does not take). Outputs must not
// alias inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"
#include "mont.cuh"

namespace {

constexpr int W = 8;
constexpr int kLogMaxTile = ntt_tile::kLogChunk;
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
// One block a chunk of 2^c rows of the bit-reversed table, c = min(10, log_n),
// 128 threads (2^c / 8, at least one) of eight rows each; stages 1..log_tile
// (log_tile <= c) run over the chunk, which holds whole tiles.
// Bound on this card: operations. log_tile products an entry pair against 64
// bytes an entry pair moved; at a 1024-entry tile that is 10 x 272 32-bit
// multiply-adds for 64 bytes.
// Design (mont.cuh, ntt_tile, has the steps and the layout): the first pass
// gathers its rows from x into registers, runs stages 1-3 there (radix 8),
// and later passes run up to three stages each between exchanges through
// shared memory, the last one storing to `out`: at a 1024-entry tile four
// passes and three exchanges. Shared memory holds the tile in word planes with
// a swizzle that leaves no bank conflict (32 KB) and the chunk's twiddles,
// staged once a block from the compact table (16 KB); twiddle w^0 takes no
// product. Products on mont.cuh's carry chains. 48 KB a block: four blocks an
// SM, 16 warps, so a thread may hold 128 registers.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(ntt_tile::kThreads, 4)
ntt_phase1_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ ctw,
                  uint32_t* __restrict__ out, int log_n, int log_chunk, int log_tile,
                  const ntt_tile::Mod m) {
  __shared__ ntt_tile::TilePlanes tile;
  __shared__ ntt_tile::TwPlanes tw;
  const int t = threadIdx.x;
  const int lx = log_chunk > 3 ? log_chunk : 3;  // log2 of the rows the threads cover
  const long long base = (long long)blockIdx.x << log_chunk;
  ntt_tile::Rows e;
  ntt_tile::gather(e, x, t, base, log_n, log_chunk);
  ntt_tile::stage_twiddles(tw, ctw, t, blockDim.x, log_chunk);
  __syncthreads();
  int b = 0;
  bool exchanged = false;
  for (int first = 1; first <= log_tile; first += 3) {
    const int nb = ntt_tile::window(first, lx);
    if (nb != b) {
      if (exchanged) __syncthreads();  // every thread has loaded the last exchange
      ntt_tile::store_rows(tile, e, t, b);
      __syncthreads();
      ntt_tile::load_rows(e, tile, t, nb);
      b = nb;
      exchanged = true;
    }
    const int last = first + 2 < log_tile ? first + 2 : log_tile;
    ntt_tile::run_stages(e, tw, t, b, first, last, log_chunk, m);
  }
  ntt_tile::scatter(out, e, t, b, base, log_chunk);
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

// x, out: (2^log_n, 8) words; ctw: the compact twiddles, (2^(c - 1), 8) words,
// c = min(10, log_n) (unread when log_tile = 0); 0 <= log_tile <= c,
// log_n <= 30
int zk_ntt_phase1(const void* x, const void* ctw, void* out, int log_n, int log_tile,
                  const uint32_t* p, uint32_t n0, void* stream) {
  if (log_n < 0 || log_n > kMaxLogN || log_tile < 0 || log_tile > kLogMaxTile ||
      log_tile > log_n)
    return -1;
  static const cudaError_t carveout = cudaFuncSetAttribute(
      ntt_phase1_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);  // room for four 48 KB blocks an SM
  if (carveout != cudaSuccess) return (int)carveout;
  const int log_chunk = log_n < kLogMaxTile ? log_n : kLogMaxTile;
  const unsigned blocks = 1u << (log_n - log_chunk);
  const unsigned threads = log_chunk > 3 ? 1u << (log_chunk - 3) : 1u;
  ntt_tile::Mod m;
  for (int j = 0; j < W; ++j) m.p[j] = p[j];
  m.n0 = n0;
  ntt_phase1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)ctw, (uint32_t*)out, log_n, log_chunk, log_tile, m);
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
