// Pippenger's compaction round: the run scan's per-key and per-tile logic, and
// compact_add's tile of slots (the kernels are in msm_kernels.cu).
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
// The kernel scans in one pass (Merrill and Garland's decoupled look-back): a
// block takes its tile of keys by ticket, scans its threads' aggregates on its
// warps' lanes (`scan_lanes`), publishes the tile's aggregate, finds the
// tile's prefix from its predecessors' published aggregates and prefixes
// (`look_back`, a warp looking at as many predecessors at once), publishes its
// own prefix and writes its survivors. The tile's keys pass through shared
// memory into each thread's registers (`RunKeys`) and its survivor slots
// through shared memory (`Staged`), so the keys leave device memory once and
// the slots are written in order.
//
// Built with nvcc the scan's and the tile's functions are host and device
// code and add_entry device code; built with a host C++ compiler (as
// tests/test_torch_msm_kernels.py does) the same code runs on the host.

#pragma once

#include <cstdint>

#include "fq381.cuh"
#include "warp.cuh"

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

// Where slot s of a tile is noted in shared memory: a word of padding every
// 32, so that a warp meets few banks twice both when its threads take
// neighbouring slots and when each takes a run of them
CM_HD int noted(int s) { return s + (s >> 5); }

// A thread's run of at most N keys [lo, ...) in registers, the key before it
// first: key i at k[i - lo + 1]
template <int N>
struct RunKeys {
  int32_t k[N + 1];
  int32_t lo;
  CM_HD int32_t operator[](int32_t i) const { return k[i - lo + 1]; }
};

// A tile's survivor slots [first, ...) staged in shared memory, noted
struct Staged {
  int32_t* stage;
  int32_t first;
  CM_HD int32_t& operator[](int32_t slot) const { return stage[noted(slot - first)]; }
};

// the aggregate of keys [lo, hi), 0 < hi - lo <= N (key: anything indexed by
// position; every step a constant distance from lo, so a RunKeys stays in
// registers)
template <int N, class Keys>
CM_HD Agg tile_aggregate(const Keys& key, int32_t lo, int32_t hi) {
  Agg a = identity();
  int32_t prev = lo > 0 ? key[lo - 1] : 0;
#pragma unroll
  for (int32_t j = 0; j < N; ++j) {
    const int32_t i = lo + j;
    if (i >= hi) break;
    const int32_t k = key[i];
    const bool head = i == 0 || k != prev;
    a.last_head = head ? i : a.last_head;
    a.has_head |= head;
    const int32_t left = ((i - a.last_head) & 1) == 0;
    a.lefts[0] += a.has_head ? left : (i & 1) == 0;
    a.lefts[1] += a.has_head ? left : (i & 1) == 1;
    prev = k;
  }
  return a;
}

// Keys [lo, hi), 0 < hi - lo <= N, with `before`, the aggregate of keys [0,
// lo): each left's survivor slot is the count of lefts before it, and the left
// at i goes to srcpos[slot] when the slot is below l_next. Returns the tile's
// longest run so far (the largest rank + 1).
template <int N, class Keys, class Slots>
CM_HD int32_t apply_tile(const Keys& key, int32_t lo, int32_t hi, const Agg& before,
                         const Slots& srcpos, int32_t l_next) {
  int32_t run_start = before.last_head;
  int32_t slot = before.lefts[0];
  int32_t longest = 0;
  int32_t prev = lo > 0 ? key[lo - 1] : 0;
#pragma unroll
  for (int32_t j = 0; j < N; ++j) {
    const int32_t i = lo + j;
    if (i >= hi) break;
    const int32_t k = key[i];
    run_start = i == 0 || k != prev ? i : run_start;
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

// ----------------------------------------------------------------------
// the one-pass scan across a group's lanes and across tiles
// ----------------------------------------------------------------------

template <class Gr>
WP_FN Agg shfl_agg(const Gr& g, const Agg& a, uint32_t src) {
  return Agg{(int32_t)g.shfl((uint32_t)a.has_head, src), (int32_t)g.shfl((uint32_t)a.last_head, src),
             {(int32_t)g.shfl((uint32_t)a.lefts[0], src), (int32_t)g.shfl((uint32_t)a.lefts[1], src)}};
}

// the inclusive scan of the group's aggregates in lane order
template <int G, class Gr>
WP_FN Agg scan_lanes(const Gr& g, Agg v) {
#pragma unroll
  for (int d = 1; d < G; d *= 2) {
    const Agg u = shfl_agg(g, v, g.lane - d);
    if ((int)g.lane >= d) v = combine(u, v);
  }
  return v;
}

// a tile's status: nothing published yet, its aggregate, its inclusive prefix
enum : int32_t { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

// The exclusive prefix of tile `tile` > 0 from what its predecessors
// published, G at a time: lane l looks at tile end - G + l until it has
// published something. The nearest predecessor with a prefix ends the
// look-back; its prefix and the aggregates of the tiles after it, combined in
// order (lane 0 gathers them in log G steps), precede what was found before.
// `st` is the tiles' published state: peek(t, v) returns tile t's status and
// in v what it published with it.
template <int G, class States, class Gr>
WP_FN Agg look_back(const Gr& g, const States& st, int32_t tile) {
  Agg prefix = identity();
  for (int32_t end = tile;; end -= G) {
    const int32_t t = end - G + (int32_t)g.lane;
    Agg v = identity();
    int32_t status = kPrefix;
    if (t >= 0) {
      do {
        status = st.peek(t, v);
      } while (status == kInvalid);
    }
    const uint32_t done = g.ballot(status == kPrefix);
    if (done != 0 && (int32_t)g.lane < warp::top_bit(done)) v = identity();
#pragma unroll
    for (int d = 1; d < G; d *= 2) v = combine(v, shfl_agg(g, v, g.lane + d));
    prefix = combine(shfl_agg(g, v, 0), prefix);
    if (done != 0) return prefix;
  }
}

// ----------------------------------------------------------------------
// compact_add: a tile of output slots sorted by what each does
// ----------------------------------------------------------------------
//
// Output slot j < l_next of a round over n keys and points (x, y, z: n x 12
// words) holds, below `count`, the left at i = srcpos[j] plus its right
// neighbour where that has the same key, under the left's key; from `count`
// on, infinity (0, 1 in Montgomery form, 0) under `max_key`. What a slot below
// the count does follows fq381::point_add_lane's selection: no neighbour of
// the same key, or an infinite right -> the left's words; an infinite left
// (and a finite right) -> the right's; both finite -> an addition (equal and
// opposite points are its branches).
//
// A block takes a tile of slots. Each thread classifies its share of them
// (slot k * threads + t: neighbouring threads on neighbouring slots), writes
// their keys and notes each slot's kind and source row. Then each thread
// counts the kinds of as many consecutive slots (its run), the block scans the
// counts, and each thread lists its run's additions at the front of the
// tile's list and its copies at the back, both in slot order. Copies and pads
// then move 16 bytes a lane on neighbouring addresses, several loads in flight
// a lane, and the additions run densely, one a lane.

enum : uint8_t { kNone = 0, kPad = 1, kCopy = 2, kAdd = 3 };

// counts of a run packed in a word: additions low, copies high (a tile holds
// fewer than 2^16 slots)
constexpr uint32_t kCopyUnit = 1u << 16;

#ifdef __CUDACC__
using Quad = ::uint4;
#else
using Quad = carry::uint4;
#endif

// canonical words all zero: the point is infinity (three 16-byte loads, all in
// flight together)
CM_HD bool z_is_zero(const uint32_t* z) {
  const Quad* q = reinterpret_cast<const Quad*>(z);
  uint32_t any = 0;
#pragma unroll
  for (int k = 0; k < fq381::W / 4; ++k) {
    const Quad v = q[k];
    any |= v.x | v.y | v.z | v.w;
  }
  return any == 0;
}

// The kind of output slot j, its key and its source row (a copy's: the row
// whose words it takes; an addition's: the left). Slots at or past l_next do
// nothing.
CM_HD uint8_t slot_kind(long long j, const int32_t* key, const uint32_t* z, int32_t n,
                        const int32_t* srcpos, int32_t count, int32_t l_next, int32_t max_key,
                        int32_t& okey, int32_t& row) {
  constexpr int W = fq381::W;
  row = 0;
  if (j >= l_next) return kNone;
  if (j >= count) {
    okey = max_key;
    return kPad;
  }
  const int32_t i = srcpos[j];
  okey = key[i];
  row = i;
  if (i + 1 >= n || key[i + 1] != key[i]) return kCopy;
  if (z_is_zero(z + (long long)(i + 1) * W)) return kCopy;  // the right infinite
  if (z_is_zero(z + (long long)i * W)) {                    // the left infinite
    row = i + 1;
    return kCopy;
  }
  return kAdd;
}

// the counts of slots [first, first + items) of the tile's kinds (noted at
// noted(s)), packed
CM_HD uint32_t run_counts(const int32_t* kinds, int first, int items) {
  uint32_t c = 0;
  for (int s = first; s < first + items; ++s) {
    const int32_t kind = kinds[noted(s)];
    c += kind == kAdd ? 1u : kind == kCopy ? kCopyUnit : 0u;
  }
  return c;
}

// List slots [first, first + items) (kinds and rows noted at noted(s)):
// additions from `before`'s low half on, copies from tile - copies +
// `before`'s high half on, `copies` the tile's total; an entry is a slot of
// the tile and its source row.
CM_HD void list_run(const int32_t* kinds, const int32_t* rows, int first, int items,
                    uint32_t before, int tile, int copies, int16_t* slot, int32_t* row) {
  int a = (int)(before & (kCopyUnit - 1));
  int c = tile - copies + (int)(before >> 16);
  for (int s = first; s < first + items; ++s) {
    const int32_t kind = kinds[noted(s)];
    if (kind == kAdd) {
      slot[a] = (int16_t)s;
      row[a++] = rows[noted(s)];
    } else if (kind == kCopy) {
      slot[c] = (int16_t)s;
      row[c++] = rows[noted(s)];
    }
  }
}

// Chunks q0 + b stride, b < B, of the tile's copies (those below 9 copies):
// coordinate by coordinate, an entry's three 16-byte quarters on neighbouring
// chunks, so neighbouring lanes move neighbouring bytes where the slots are
// neighbours. All B loads are issued before the stores. `lo` is the tile's
// first slot, the list's copies start at `at`.
template <int B>
CM_HD void copy_chunks(int q0, int stride, int copies, const int16_t* slot, const int32_t* row,
                       int at, long long lo, const uint32_t* x, const uint32_t* y,
                       const uint32_t* z, uint32_t* ox, uint32_t* oy, uint32_t* oz) {
  constexpr int W = fq381::W;
  const int per = 3 * copies;
  Quad v[B];
  Quad* to[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int q = q0 + b * stride;
    to[b] = nullptr;
    if (q < 3 * per) {
      const int coord = q / per, r = q % per, e = at + r / 3, part = r % 3;
      const uint32_t* src = coord == 0 ? x : coord == 1 ? y : z;
      uint32_t* dst = coord == 0 ? ox : coord == 1 ? oy : oz;
      v[b] = *(reinterpret_cast<const Quad*>(src + (long long)row[e] * W) + part);
      to[b] = reinterpret_cast<Quad*>(dst + (lo + slot[e]) * W) + part;
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if (to[b] != nullptr) *to[b] = v[b];
  }
}

// Chunk q of the pads [first, first + pads), q < 9 pads, laid out as copies
CM_HD void pad_chunk(int q, int pads, long long first, uint32_t* ox, uint32_t* oy,
                     uint32_t* oz) {
  constexpr int W = fq381::W;
  const int per = 3 * pads;
  const int coord = q / per, r = q % per, part = r % 3;
  uint32_t* dst = coord == 0 ? ox : coord == 1 ? oy : oz;
  Quad v{0, 0, 0, 0};
  if (coord == 1) {
    const int w = 4 * part;
    v = Quad{fq381::ONE(w), fq381::ONE(w + 1), fq381::ONE(w + 2), fq381::ONE(w + 3)};
  }
  *(reinterpret_cast<Quad*>(dst + (first + r / 3) * W) + part) = v;
}

// Addition e of the tile's list: the left at row[e] plus its right neighbour
// into slot lo + slot[e]
FQ_FN void add_entry(int e, const int16_t* slot, const int32_t* row, long long lo,
                     const uint32_t* x, const uint32_t* y, const uint32_t* z, uint32_t* ox,
                     uint32_t* oy, uint32_t* oz) {
  constexpr int W = fq381::W;
  const long long a = (long long)row[e] * W;
  const long long o = (lo + slot[e]) * W;
  fq381::point_add_lane(x + a, y + a, z + a, x + a + W, y + a + W, z + a + W, ox + o, oy + o,
                        oz + o);
}

}  // namespace compact
