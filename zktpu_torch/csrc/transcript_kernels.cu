// The fused provers' device transcript as two CUDA kernels for Hopper (sm_90a).
//
// zktpu runs its Fiat-Shamir transcript on the chip inside each prover's
// compiled program, as plain XLA (no Pallas kernel): one XLA program is the
// whole sumcheck prover (zktpu/sumcheck/fused.py:_device_prove) or one GKR round
// (zktpu/gkr/fused_lazy.py:_big_round), and its Keccak is
// zktpu/hash/keccak_device.py:keccak_f. The port ran the same functions
// eagerly: 552 launches a permutation, some 1,300 a GKR round. Here:
//
//   * keccak_f -- replaces zktpu/hash/keccak_device.py:keccak_f (:78). Keccak-f
//     [1600] on each of B states (B, 25) uint64, one thread a state, the 25
//     lanes in registers and the 24 rounds unrolled (keccak.cuh). Bound: the
//     dependent chain of 24 rounds (a few thousand 32-bit operations one after
//     another), not bytes (200 a state each way): at B = 1 the launch is its
//     latency.
//   * round_step -- replaces the round of zktpu/gkr/fused_lazy.py:_big_round
//     (:215) and of zktpu/sumcheck/fused.py:_device_prove (:192), all but the
//     Pallas kernel and the fold: canonical values of the lazy rows, for GKR
//     the interpolation and the trimmed length, the padded absorb of one or two
//     blocks, the new state and the next challenge in Montgomery form
//     (transcript.cuh has the steps). One warp: the rows' products on their
//     own lanes, the absorbed lanes built a lane each, the permutation a state
//     lane a lane with shuffles. A round is templated on its rows (2 or 3) and
//     its kind (steady, or first with a pending tail), so every index is a
//     constant: no stack frame. Latency-bound: at most three Montgomery
//     products and two permutations one after another.
//
// The field comes by value (transcript::Consts: p, n0, R^2 mod p, 1/2), so one
// binary serves BN254 Fq and BLS12-381 Fr; both fused provers need a 32-byte
// field (W = 8).
//
// Plain C interface (loaded with ctypes): every function launches on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or -1 for arguments it does not take).

#include <cstdint>
#include <cuda_runtime.h>

#include "keccak.cuh"
#include "transcript.cuh"

namespace {

constexpr int kKeccakThreads = 128;
// round_step: one warp
constexpr int kRoundThreads = 32;

__global__ void __launch_bounds__(kKeccakThreads)
keccak_f_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t s[keccak::kLanes];
#pragma unroll
  for (int l = 0; l < keccak::kLanes; ++l) s[l] = in[i * keccak::kLanes + l];
  keccak::permute(s);
#pragma unroll
  for (int l = 0; l < keccak::kLanes; ++l) out[i * keccak::kLanes + l] = s[l];
}

// a warp a round (transcript.cuh has the steps)
template <int K, bool First>
__global__ void __launch_bounds__(kRoundThreads)
round_step_kernel(const uint32_t* __restrict__ rows, const uint64_t* __restrict__ state_in,
                  const uint64_t* __restrict__ prefix, int prefix_lanes,
                  const transcript::Consts consts, uint32_t* __restrict__ out_rows,
                  uint64_t* __restrict__ state_out, uint32_t* __restrict__ challenge) {
  transcript::round_step<K, First>(warp::Group<kRoundThreads>{threadIdx.x}, rows, state_in, prefix,
                                   prefix_lanes, consts, out_rows, state_out, challenge);
}

template <int K, bool First>
void launch_round_step(const void* rows, const void* state_in, const void* prefix,
                       int prefix_lanes, const transcript::Consts& consts, void* out_rows,
                       void* state_out, void* challenge, cudaStream_t stream) {
  round_step_kernel<K, First><<<1, kRoundThreads, 0, stream>>>(
      (const uint32_t*)rows, (const uint64_t*)state_in, (const uint64_t*)prefix, prefix_lanes,
      consts, (uint32_t*)out_rows, (uint64_t*)state_out, (uint32_t*)challenge);
}

}  // namespace

extern "C" {

// in, out: (n, 25) uint64 lanes (out may not alias in)
int zk_keccak_f(const void* in, void* out, long long n, void* stream) {
  if (n < 1) return -1;
  const long long blocks = (n + kKeccakThreads - 1) / kKeccakThreads;
  keccak_f_kernel<<<(unsigned)blocks, kKeccakThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

// rows: (k, 9) uint32 lazy words, k = 2 or 3; state_in: 25 uint64 lanes (not
// read when fresh); prefix: prefix_lanes uint64 lanes, at most 16; p, r2, inv2:
// 8 host words each; out_rows: (k, 8) uint32; state_out: 25 uint64 lanes;
// challenge: 8 uint32 words. The outputs may not alias the inputs.
int zk_round_step(const void* rows, int k, const void* state_in, int fresh, const void* prefix,
                  int prefix_lanes, const uint32_t* p, uint32_t n0, const uint32_t* r2,
                  const uint32_t* inv2, void* out_rows, void* state_out, void* challenge,
                  void* stream) {
  if ((k != 2 && k != 3) || prefix_lanes < 0 || prefix_lanes > transcript::kMaxPrefixLanes) {
    return -1;
  }
  transcript::Consts consts;
  for (int j = 0; j < transcript::W; ++j) {
    consts.M.p[j] = p[j];
    consts.r2[j] = r2[j];
    consts.inv2[j] = inv2[j];
  }
  consts.M.n0 = n0;
  auto launch = k == 2 ? (fresh ? launch_round_step<2, false> : launch_round_step<2, true>)
                       : (fresh ? launch_round_step<3, false> : launch_round_step<3, true>);
  launch(rows, state_in, prefix, prefix_lanes, consts, out_rows, state_out, challenge,
         (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
