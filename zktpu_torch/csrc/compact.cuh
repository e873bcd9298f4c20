// Pippenger's compaction round: the run scan's per-key and per-tile logic, and
// compact_add's per-slot work (the kernels are in msm_kernels.cu).
//
// The keys of a window group are sorted, so equal keys form runs. A key's rank
// is its distance from the start of its run, rank(i) = i - run_start(i), where
// run_start(i) is the last head at or before i (a head: i == 0 or key[i] !=
// key[i - 1]). A round pairs each rank-even key (a "left") with its right
// neighbour where that has the same key, and survivor j of the round is the
// (j + 1)-th left. zktpu/msm/pippenger.py:_compact_round (:154) finds the
// ranks by a cummax of the heads and the survivors by a cumsum and a
// searchsorted; here one scan does both.
//
// The scan runs over tiles of consecutive keys (on the card, a thread's tile).
// What a tile contributes depends on what precedes it only through the run its
// leading keys (those before its first head) continue, and only through the
// parity of that run's start: a leading key i is a left exactly when i and the
// start have the same parity. So a tile's aggregate holds two counts of lefts,
// one for each parity of that start, beside whether it holds a head and where
// its last head is. Aggregates compose in order (`combine`: associative, not
// commutative), so a block and the grid can scan them in any bracketing. The
// aggregate of a prefix that holds key 0, a head, has no leading keys: its two
// counts agree, and its last head is the run start of the key after it.
// Padding keys (_MAXKEY) get no special case: they form a run like any other,
// as in both packages.
//
// Built with nvcc the scan's functions are host and device code and
// compact_slot device code; built with a host C++ compiler (as
// tests/test_torch_msm_kernels.py does) the same code runs on the host.

#pragma once

#include <cstdint>

#include "fq381.cuh"

#ifdef __CUDACC__
#define CM_HD __host__ __device__ __forceinline__
#else
#define CM_HD inline
#endif

namespace compact {

struct Agg {
  int32_t has_head;   // 1 when the span holds a head
  int32_t last_head;  // the position of its last head (when it has one)
  int32_t lefts[2];   // its lefts if the run its leading keys continue starts
                      // at an even (0) or an odd (1) position
};

CM_HD Agg identity() { return Agg{0, 0, {0, 0}}; }

// the span of `a` followed by the span of `b`
CM_HD Agg combine(const Agg& a, const Agg& b) {
  Agg o;
  o.has_head = a.has_head | b.has_head;
  o.last_head = b.has_head ? b.last_head : a.last_head;
  for (int q = 0; q < 2; ++q) {
    // the run b's leading keys continue starts at a's last head, or where a's did
    o.lefts[q] = a.lefts[q] + b.lefts[a.has_head ? a.last_head & 1 : q];
  }
  return o;
}

// the aggregate of keys [lo, hi), lo < hi
CM_HD Agg tile_aggregate(const int32_t* key, int32_t lo, int32_t hi) {
  Agg a = identity();
  int32_t prev = lo > 0 ? key[lo - 1] : 0;
  for (int32_t i = lo; i < hi; ++i) {
    const int32_t k = key[i];
    if (i == 0 || k != prev) {
      a.has_head = 1;
      a.last_head = i;
    }
    if (a.has_head) {
      const int32_t left = ((i - a.last_head) & 1) == 0;
      a.lefts[0] += left;
      a.lefts[1] += left;
    } else {
      a.lefts[i & 1] += 1;
    }
    prev = k;
  }
  return a;
}

// Keys [lo, hi) with `before`, the aggregate of keys [0, lo): each left's
// survivor slot is the count of lefts before it, and the left at i goes to
// srcpos[slot] when the slot is below l_next. Returns the tile's longest run
// so far (the largest rank + 1).
CM_HD int32_t apply_tile(const int32_t* key, int32_t lo, int32_t hi, const Agg& before,
                         int32_t* srcpos, int32_t l_next) {
  int32_t run_start = before.last_head;
  int32_t slot = before.lefts[0];
  int32_t longest = 0;
  int32_t prev = lo > 0 ? key[lo - 1] : 0;
  for (int32_t i = lo; i < hi; ++i) {
    const int32_t k = key[i];
    if (i == 0 || k != prev) run_start = i;
    const int32_t rank = i - run_start;
    longest = rank + 1 > longest ? rank + 1 : longest;
    if ((rank & 1) == 0) {
      if (slot < l_next) srcpos[slot] = i;
      ++slot;
    }
    prev = k;
  }
  return longest;
}

// Output slot j of a round over n keys and points (x, y, z: n x 12 words):
// below `count`, the left at i = srcpos[j] plus its right neighbour where that
// has the same key (a point_add_lane that reads its operands where they lie),
// else the left's words, under the left's key; from `count` on, infinity
// (0, 1 in Montgomery form, 0) under `max_key`.
FQ_FN void compact_slot(int32_t j, const int32_t* key, const uint32_t* x, const uint32_t* y,
                        const uint32_t* z, int32_t n, const int32_t* srcpos, int32_t count,
                        int32_t max_key, int32_t* okey, uint32_t* ox, uint32_t* oy,
                        uint32_t* oz) {
  constexpr int W = fq381::W;
  const long long o = (long long)j * W;
  if (j >= count) {
    okey[j] = max_key;
    for (int w = 0; w < W; ++w) {
      ox[o + w] = 0;
      oy[o + w] = fq381::ONE(w);
      oz[o + w] = 0;
    }
    return;
  }
  const int32_t i = srcpos[j];
  const long long a = (long long)i * W;
  okey[j] = key[i];
  if (i + 1 < n && key[i + 1] == key[i]) {
    fq381::point_add_lane(x + a, y + a, z + a, x + a + W, y + a + W, z + a + W, ox + o, oy + o,
                          oz + o);
  } else {
    fq381::copy_words(ox + o, x + a);
    fq381::copy_words(oy + o, y + a);
    fq381::copy_words(oz + o, z + a);
  }
}

}  // namespace compact
