"""Pippenger's compaction round and window combine (``zktpu_torch.msm.kernels``)
against zktpu's, on the CPU.

On the card these are three hand-written kernels, ``run_scan``, ``compact_add``
and ``horner`` (``csrc/msm_kernels.cu``). Held here, tolerance 0 (integer
arithmetic), on inputs made from numpy seeds:

  * ``run_scan_plain`` against zktpu's own steps of ``_compact_round`` (the
    ``cummax`` rank, ``cumsum`` and ``searchsorted``, as its lines compute them)
    and ``_max_run``, on keys of 1, 2 and 3 entries, random runs, all equal, all
    distinct, runs of every length from 1 to 17 across tile edges and
    ``MAXKEY`` tails, with ``l_next`` below, at and above the survivor count;
  * the scan's own code, ``csrc/compact.cuh`` built with g++, run in the one
    pass of the kernel (a tile's keys noted as in shared memory, its threads'
    aggregates scanned on each warp's lanes, fibers that meet at a barrier for
    each shuffle, the look-back on a warp's lanes, the survivors
    staged) with tiles of 4 to 24 keys, so that runs cross one, two and many
    tiles, the tiles' steps in a shuffled order (a look-back meets
    predecessors with only an aggregate, or none yet), against
    ``run_scan_plain``;
  * ``compact_add_plain`` after ``run_scan_plain`` against zktpu's
    ``_compact_round`` on 16 keys whose runs meet the doubling branch, an
    infinite operand on either side, P == -Q, a lone left and padding keys, in
    Jacobian words and keys; ``compact.cuh``'s slot (on ``fq381.cuh``) against
    ``compact_add_plain`` with ``l_next`` below, at and above the count;
  * ``horner_plain`` against zktpu's ``_horner_multi`` at two segments, three
    windows, c = 4, infinities mixed in; the kernel's chain (``coop381.cuh``
    built with g++, a group's lanes fibers of one host thread that meet at a
    barrier for each shuffle and vote) against ``horner_plain``;
  * ``horner_groups_plain`` against zktpu's ``_horner_multi`` group by group,
    on ragged groups of c = 4, 8 and 16, one and two segments, infinite
    windows; the kernel's blocks over ``chain_table``'s rows, a chain on a
    group of 8 lanes, against it;
  * ``coop381.cuh``'s product against ``field/host.py`` and the words of
    ``fq381.cuh``'s one-thread product, at 0, 1, p - 1, R mod p, lazy values
    and random ones;
  * ``compact.cuh``'s tile steps (a slot's kind, the tile's lists of copies
    and additions, the 16-byte chunks) run as the kernel runs them, with tiles
    of 8, 6 and 2048 slots, against ``compact_add_plain`` on the round above
    and on planted neighbours (infinite left, right and both, P and P, P and
    -P, runs across tile edges, tiles of additions only and of none);
  * ``KZG._commit_quotients``, one window combine for all quotient steps,
    against each step's ``msm_pippenger_multi``;
  * the wrappers: CPU tensors take the plain versions; what the kernels do not
    take raises.

zktpu's programs are compiled once a shape (its plain-XLA point addition on the
CPU, as its own tests run it). The kernels themselves run only on the card:
``chip_smoke.py`` holds them there against the same plain versions.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.msm import pippenger as jp

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.field import host
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.msm import kernels as mk
from zktpu_torch.msm import pippenger as pp
from zktpu_torch.pcs.kzg import KZG
from zktpu_torch.poly.multilinear import MultilinearPoly

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(mk.__file__), "..", "csrc")
fq = dc.fq_ctx("cpu")

HARNESS = r"""
#include <algorithm>
#include <functional>
#include <vector>

#include "compact.cuh"
#include "coop381.cuh"

using compact::Agg;

namespace {

// the most keys a thread's run takes here
constexpr int kRunKeys = 8;

// a thread's run of keys from a noted tile (the key before the tile in slot
// 0), starting `at` keys into the tile, the key before it first
compact::RunKeys<kRunKeys> run_keys(const std::vector<int32_t>& s, int32_t lo, int at) {
  compact::RunKeys<kRunKeys> rk;
  rk.lo = lo;
  for (int j = 0; j <= kRunKeys; ++j) {
    const int slot = compact::noted(at + j);
    rk.k[j] = slot < (int)s.size() ? s[slot] : 0;
  }
  return rk;
}

// a group of G lanes (fibers) running body(group)
template <int G, class Body>
void on_group(const Body& body) {
  warp::run_lanes<G>(body);
}

// What the scan's tiles have published, as the kernel's blocks see it. A tile
// a look-back meets before it has published anything runs its first step
// then, as a block that waits sees it finish.
struct HostTiles {
  std::vector<int32_t> status;
  std::vector<Agg> aggregate, prefix;
  std::function<void(int32_t)>* first_step;
  int32_t peek(int32_t t, Agg& v) const {
    if (status[t] == compact::kInvalid) (*first_step)(t);
    v = status[t] == compact::kPrefix ? prefix[t] : aggregate[t];
    return status[t];
  }
  void publish(int32_t t, int32_t s, const Agg& a) {
    (s == compact::kPrefix ? prefix : aggregate)[t] = a;
    status[t] = s;
  }
};

// run_scan's one pass, tile by tile as the kernel's blocks run it: tiles of
// warps x G threads of `items` keys; a tile's first step (its keys noted, its
// threads' aggregates scanned on each warp's G lanes (fibers), then
// across its warps; its aggregate published) and its second (the look-back on
// G lanes, its prefix published, its survivors staged and written) run in the
// order `order` gives (event 2 t: tile t's first step, 2 t + 1: its second);
// then the fill of the slots past the count. A thread's run of keys is read
// from the noted tile into registers, as the kernel reads it.
template <int G>
void single_pass(const int32_t* key, int n, int items, int warps, const int32_t* order,
                 int32_t* srcpos, int l_next, int32_t* count, int32_t* longest) {
  const int threads = warps * G, tile_keys = threads * items;
  const int tiles = (n + tile_keys - 1) / tile_keys;
  std::vector<std::vector<int32_t>> noted(tiles);
  std::vector<std::vector<Agg>> below(tiles), warps_before(tiles);
  std::vector<Agg> total(tiles);
  std::function<void(int32_t)> first;
  HostTiles st{std::vector<int32_t>(tiles, compact::kInvalid), std::vector<Agg>(tiles),
               std::vector<Agg>(tiles), &first};
  auto bounds = [&](int t, int j, int32_t& lo, int32_t& hi) {
    const int32_t tile_lo = t * tile_keys, tile_hi = std::min(tile_lo + tile_keys, n);
    lo = std::min(tile_lo + j * items, tile_hi);
    hi = std::min(lo + items, tile_hi);
  };
  first = [&](int32_t t) {
    const int32_t lo = t * tile_keys, hi = std::min(lo + tile_keys, n);
    auto& s = noted[t];
    s.assign(compact::noted(tile_keys + 1) + 1, 0);
    s[0] = lo > 0 ? key[lo - 1] : 0;
    for (int32_t i = 0; i < hi - lo; ++i) s[compact::noted(i + 1)] = key[lo + i];
    std::vector<Agg> incl(threads);
    below[t].assign(threads, compact::identity());
    for (int w = 0; w < warps; ++w) {
      on_group<G>([&, w](const warp::Group<G>& g) {
        const int j = w * G + (int)g.lane;
        int32_t t_lo, t_hi;
        bounds(t, j, t_lo, t_hi);
        const auto rk = run_keys(s, t_lo, j * items);
        const Agg mine = t_lo < t_hi ? compact::tile_aggregate<kRunKeys>(rk, t_lo, t_hi)
                                     : compact::identity();
        const Agg in = compact::scan_lanes<G>(g, mine);
        const Agg b = compact::shfl_agg(g, in, g.lane - 1);
        incl[j] = in;
        if (g.lane > 0) below[t][j] = b;
      });
    }
    warps_before[t].assign(warps, compact::identity());
    Agg all = compact::identity();
    for (int w = 0; w < warps; ++w) {
      warps_before[t][w] = all;
      all = compact::combine(all, incl[w * G + G - 1]);
    }
    total[t] = all;
    st.publish(t, t == 0 ? compact::kPrefix : compact::kAggregate, all);
  };
  auto ensure_first = [&](int32_t t) {
    if (st.status[t] == compact::kInvalid) first(t);
  };
  auto second = [&](int32_t t) {
    ensure_first(t);
    Agg before = compact::identity();
    if (t > 0) {
      on_group<G>([&](const warp::Group<G>& g) {
        const Agg p = compact::look_back<G>(g, st, t);
        if (g.lane == 0) before = p;
      });
      st.publish(t, compact::kPrefix, compact::combine(before, total[t]));
    }
    const int32_t lo = t * tile_keys, hi = std::min(lo + tile_keys, n);
    const int32_t end = compact::combine(before, total[t]).lefts[0];
    if (hi == n) *count = end;
    std::vector<int32_t> stage(compact::noted(tile_keys), -9);
    const int32_t first_slot = before.lefts[0];
    for (int j = 0; j < threads; ++j) {
      int32_t t_lo, t_hi;
      bounds(t, j, t_lo, t_hi);
      if (t_lo >= t_hi) continue;
      const Agg mine_before = compact::combine(compact::combine(before, warps_before[t][j / G]),
                                               below[t][j]);
      const auto rk = run_keys(noted[t], t_lo, j * items);
      *longest = std::max(*longest, compact::apply_tile<kRunKeys>(
                                        rk, t_lo, t_hi, mine_before,
                                        compact::Staged{stage.data(), first_slot}, l_next));
    }
    for (int32_t s = first_slot; s < std::min(end, (int32_t)l_next); ++s) {
      srcpos[s] = stage[compact::noted(s - first_slot)];
    }
  };
  *longest = 0;
  for (int e = 0; e < 2 * tiles; ++e) {
    if (order[e] % 2 == 0) {
      ensure_first(order[e] / 2);
    } else {
      second(order[e] / 2);
    }
  }
  for (long j = *count; j < l_next; ++j) srcpos[j] = n - 1;
}


// the kernels' lanes: two words of an element each, 8 a group
constexpr int L = 2;

// one chain of the horner kernel on a group of lanes (fibers)
void coop_chain(const uint32_t* const* pw, const int32_t* ch, uint32_t* const* out, int b) {
  using coop381::Lanes;
  warp::run_lanes<Lanes<L>::G>([=](const coop381::Group<Lanes<L>::G>& g) {
    const auto s = coop381::make_lanes<L>(g);
    const long in = (long)ch[0] * 12;
    coop381::horner_group(s, pw[0] + in, pw[1] + in, pw[2] + in, ch[1], ch[2], out[0] + 12 * b,
                          out[1] + 12 * b, out[2] + 12 * b);
  });
}

void mul_group(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  using coop381::Lanes;
  warp::run_lanes<Lanes<L>::G>([=](const coop381::Group<Lanes<L>::G>& g) {
    const auto s = coop381::make_lanes<L>(g);
    for (int i = 0; i < n; ++i) {
      coop381::Fe<L> x, y;
      coop381::load(s, x, a + 12 * i);
      coop381::load(s, y, b + 12 * i);
      coop381::mul(s, x, x, y);
      if (s.active) {
        for (int k = 0; k < L; ++k) out[12 * i + L * g.lane + k] = x[k];
      }
    }
  });
}

}  // namespace

extern "C" {

// run_scan's one pass with tiles of warps x lanes threads of `items` (at most
// kRunKeys) keys, lanes 1, 2, 4 or 8
void scan(const int32_t* key, int n, int items, int warps, int lanes, const int32_t* order,
          int32_t* srcpos, int l_next, int32_t* count, int32_t* longest) {
  auto run = lanes == 1   ? single_pass<1>
             : lanes == 2 ? single_pass<2>
             : lanes == 4 ? single_pass<4>
                          : single_pass<8>;
  run(key, n, items, warps, order, srcpos, l_next, count, longest);
}

// compact_add's kernel, block by block and thread by thread: tiles of
// threads x items slots, the scan of the runs' counts in order, copies kBatch
// chunks at a time
constexpr int kBatch = 3;

void slots(const int32_t* key, const uint32_t* const* pt, int n, const int32_t* srcpos,
           int32_t count, int l_next, int max_key, int threads, int items, int32_t* okey,
           uint32_t* const* out) {
  const int tile = threads * items;
  std::vector<int32_t> kinds(compact::noted(tile)), rows(compact::noted(tile)), row(tile);
  std::vector<uint32_t> run(threads);
  std::vector<int16_t> slot(tile);
  for (long long lo = 0; lo < l_next; lo += tile) {
    for (int k = 0; k < items; ++k) {
      for (int t = 0; t < threads; ++t) {
        const int s = k * threads + t;
        int32_t k_out = 0, r = 0;
        const uint8_t kind = compact::slot_kind(lo + s, key, pt[2], n, srcpos, count, l_next,
                                                max_key, k_out, r);
        if (kind != compact::kNone) okey[lo + s] = k_out;
        kinds[compact::noted(s)] = kind;
        rows[compact::noted(s)] = r;
      }
    }
    for (int t = 0; t < threads; ++t) run[t] = compact::run_counts(kinds.data(), t * items, items);
    for (int t = 1; t < threads; ++t) run[t] += run[t - 1];
    const uint32_t total = run[threads - 1];
    const int adds = (int)(total & (compact::kCopyUnit - 1)), copies = (int)(total >> 16);
    for (int t = 0; t < threads; ++t) {
      compact::list_run(kinds.data(), rows.data(), t * items, items, t > 0 ? run[t - 1] : 0u,
                        tile, copies, slot.data(), row.data());
    }
    for (int t = 0; t < threads; ++t) {
      for (int q = t; q < 9 * copies; q += threads * kBatch) {
        compact::copy_chunks<kBatch>(q, threads, copies, slot.data(), row.data(), tile - copies,
                                     lo, pt[0], pt[1], pt[2], out[0], out[1], out[2]);
      }
    }
    const long long pad_lo = std::max<long long>(lo, count);
    const long long pad_hi = std::min<long long>(lo + tile, l_next);
    const int pads = pad_hi > pad_lo ? (int)(pad_hi - pad_lo) : 0;
    for (int q = 0; q < 9 * pads; ++q) compact::pad_chunk(q, pads, pad_lo, out[0], out[1], out[2]);
    for (int e = 0; e < adds; ++e) {
      compact::add_entry(e, slot.data(), row.data(), lo, pt[0], pt[1], pt[2], out[0], out[1],
                         out[2]);
    }
  }
}

// a chain on a group of lanes (fibers) a segment
void horner(const uint32_t* const* pw, int segments, int windows, int c, uint32_t* const* out) {
  for (int s = 0; s < segments; ++s) {
    const int32_t ch[3] = {s * windows, windows, c};
    coop_chain(pw, ch, out, s);
  }
}

// the horner kernel's blocks over a chain table (a chain: first row, windows,
// c), a group of lanes (fibers) a chain
void horner_chains(const uint32_t* const* pw, const int32_t* chains, int n_chains,
                   uint32_t* const* out) {
  for (int b = 0; b < n_chains; ++b) coop_chain(pw, chains + 3 * b, out, b);
}

// n products of raw words (lazy, below 2p): fq381::mul's, and coop381::mul's
// on a group of L-word lanes
void mul_one(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    fq381::Fe x, y, r;
    for (int j = 0; j < 12; ++j) {
      x[j] = a[12 * i + j];
      y[j] = b[12 * i + j];
    }
    fq381::mul(r, x, y);
    for (int j = 0; j < 12; ++j) out[12 * i + j] = r[j];
  }
}

void mul_coop(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  mul_group(a, b, out, n);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("msm_kernels")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libmsm_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    str(src), "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.scan.argtypes = [_P, _I, _I, _I, _I, _P, _P, _I, _P, _P]
    lib.slots.argtypes = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.horner.argtypes = [_P, _I, _I, _I, _P]
    lib.horner_chains.argtypes = [_P, _P, _I, _P]
    lib.mul_one.argtypes = [_P, _P, _P, _I]
    lib.mul_coop.argtypes = [_P, _P, _P, _I]
    return lib


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _ptrs(pt):
    return (ctypes.c_void_p * 3)(*(t.data_ptr() for t in pt))


def _i32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, dtype=np.int64), dtype=torch.int32)


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------

def _key_sets() -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(21)
    runs = np.concatenate([np.full(r, k) for k, r in enumerate(list(range(1, 18)) * 2)])
    tail = np.sort(rng.integers(0, 9, size=40))
    return {k: _i32(v) for k, v in {
        "one key": [5],
        "two equal": [3, 3],
        "two distinct": [3, 4],
        "three equal": [7, 7, 7],
        "three, a run of two": [1, 1, 2],
        "random runs": np.sort(rng.integers(0, 24, size=127)),
        "all equal": np.full(130, 9),
        "all distinct": np.arange(129) * 3,
        "runs of 1 to 17, twice": runs,
        "MAXKEY tail": np.concatenate([tail, np.full(23, mk.MAXKEY)]),
    }.items()}


KEY_SETS = _key_sets()


def _l_nexts(key) -> list[int]:
    """Below, at and above the survivor count, and the key count."""
    count = int(mk.run_scan_plain(key, 1)[1])
    return sorted({max(1, count - 1), count, count + 1, key.shape[0]})


def _zktpu_scan(key, l_next: int):
    """zktpu's steps of ``_compact_round`` up to the gathers, as its lines
    compute them, and ``_max_run``."""
    k = jnp.asarray(key.numpy())
    n = k.shape[0]
    pos = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    head = jnp.concatenate([jnp.ones((1,), bool), k[1:] != k[:-1]])
    run_start = jax.lax.cummax(jnp.where(head, pos, 0))
    is_left = ((pos - run_start) & 1) == 0
    csum = jnp.cumsum(is_left.astype(jnp.int32))
    wanted = jax.lax.broadcasted_iota(jnp.int32, (l_next,), 0) + 1
    srcpos = jnp.clip(jnp.searchsorted(csum, wanted, side="left"), 0, n - 1)
    return np.asarray(srcpos), int(csum[-1]), int(jp._max_run(k))


@pytest.mark.parametrize("name", sorted(KEY_SETS))
def test_run_scan_plain_matches_zktpu_steps(name):
    key = KEY_SETS[name]
    for l_next in _l_nexts(key):
        srcpos, count, longest = mk.run_scan_plain(key, l_next)
        assert srcpos.dtype == count.dtype == longest.dtype == torch.int32
        assert tuple(srcpos.shape) == (l_next,) and tuple(count.shape) == tuple(longest.shape) == (1,)
        want_pos, want_count, want_longest = _zktpu_scan(key, l_next)
        assert np.array_equal(srcpos.numpy(), want_pos)
        assert (int(count), int(longest)) == (want_count, want_longest)


#: run_scan's one pass on the host: (keys a thread, warps a tile, lanes a warp)
SCAN_TILES = ((4, 1, 1), (5, 2, 2), (3, 1, 4), (2, 2, 4), (1, 3, 8), (8, 1, 2))


@pytest.mark.parametrize("items, warps, lanes", SCAN_TILES)
def test_compact_cuh_scan_matches_plain(lib, items, warps, lanes):
    """compact.cuh's one pass (tiles of 1 to 24 keys, so that runs cross one,
    two and many tiles) against ``run_scan_plain``, its tiles' two steps in a
    shuffled order: a look-back meets predecessors that have published only
    their aggregate, their prefix, or nothing yet (it then waits for them),
    and the nearest prefix may lie several look-back windows back. l_next
    below, at and above the count, and every key: the slots past the count
    are filled."""
    rng = np.random.default_rng(100 * items + 10 * warps + lanes)
    tile_keys = items * warps * lanes
    waits = 0
    for key in KEY_SETS.values():
        n = key.shape[0]
        tiles = -(-n // tile_keys)
        for l_next in _l_nexts(key):
            order = _i32(rng.permutation(2 * tiles))
            ranks = np.argsort(order.numpy())
            waits += int(np.sum(ranks[1::2][1:] < ranks[0::2][:-1]))
            srcpos = torch.full((l_next,), -7, dtype=torch.int32)
            count = torch.zeros(1, dtype=torch.int32)
            longest = torch.zeros(1, dtype=torch.int32)
            lib.scan(_ptr(key), n, items, warps, lanes, _ptr(order), _ptr(srcpos), l_next,
                     _ptr(count), _ptr(longest))
            want = mk.run_scan_plain(key, l_next)
            assert all(torch.equal(g, w) for g, w in zip((srcpos, count, longest), want))
    assert waits > 0  # some tile looked back before its predecessor had published


# ----------------------------------------------------------------------
# the round
# ----------------------------------------------------------------------

def _host(k: int):
    return hc.multiply(hc.G1_GEN, k)


@pytest.fixture(scope="module")
def round_case():
    """16 sorted keys and their points (some with Z != 1): in key 0 a pair of
    equal points (the doubling branch) and a lone left, P + (-P), infinity on
    the left and on the right, a generic addition, two padding keys."""
    a, b, c, d = (_host(k) for k in (3, 5, 7, 11))
    keys = [0, 0, 0, 1, 1, 2, 2, 3, 4, 4, 4, 4, 5, 5, mk.MAXKEY, mk.MAXKEY]
    pts = [a, a, b, a, hc.neg(a), None, b, c, d, None, None, c, a, b, None, None]
    packed = dc.pack_points(pts, "cpu")
    # another Jacobian form (Z != 1) of the same points in some lanes
    lam = fb.words_to_tensor(np.random.default_rng(5).integers(
        1, 1 << 31, size=(16, 12), dtype=np.uint32), "cpu")
    lam2 = fb.mont_mul(fq, lam, lam)
    other = (fb.mont_mul(fq, packed[0], lam2), fb.mont_mul(fq, packed[1], fb.mont_mul(fq, lam2, lam)),
             fb.mont_mul(fq, packed[2], lam))
    rescaled = torch.tensor([i in (1, 4, 6, 8, 12) for i in range(16)])
    pt = dc.where_pt(rescaled, other, packed)
    return _i32(keys), pt, pts


def test_round_case_means_what_it_says(round_case):
    key, pt, pts = round_case
    new_key, out = pp._compact_round(key, pt, 12)
    a, b, c, d = (_host(k) for k in (3, 5, 7, 11))
    assert new_key.tolist() == [0, 0, 1, 2, 3, 4, 4, 5, mk.MAXKEY] + [mk.MAXKEY] * 3
    assert dc.unpack_points(out) == [hc.double(a), b, None, b, c, d, c, hc.add(a, b), None,
                                     None, None, None]


def test_compact_add_plain_matches_zktpu(round_case):
    key, pt, _ = round_case
    l_next = 12
    srcpos, count, _ = mk.run_scan_plain(key, l_next)
    new_key, out = mk.compact_add_plain(key, pt, srcpos, count)
    jkey, jout = jp._compact_round_jit(
        jnp.asarray(key.numpy()), tuple(jnp.asarray(v) for v in convert.points_to_zktpu(
            pt, limb_major=True)), l_next)
    assert np.array_equal(new_key.numpy(), np.asarray(jkey))
    want = convert.points_from_zktpu([np.asarray(v) for v in jout], limb_major=True)
    assert all(torch.equal(g, w) for g, w in zip(out, want))


#: compact_add's tiles, (threads, slots a thread): tiles of 8 and 6 slots
#: (runs and lists cross their edges), the kernel's own, 128 x 2, and 128 x 16
TILES = ((4, 2), (2, 3), (128, 2), (128, 16))


def _host_round(lib, key, pt, srcpos, count, tile):
    """compact.cuh's tile steps, run as the kernel runs them, with ``tile`` =
    (threads, slots a thread)."""
    l_next = srcpos.shape[0]
    okey = torch.full((l_next,), -5, dtype=torch.int32)
    out = tuple(torch.full((l_next, 12), -5, dtype=torch.int32) for _ in range(3))
    lib.slots(_ptr(key), _ptrs(pt), key.shape[0], _ptr(srcpos), int(count), l_next, mk.MAXKEY,
              *tile, _ptr(okey), _ptrs(out))
    return okey, out


def test_compact_slot_matches_plain(lib, round_case):
    key, pt, _ = round_case
    for tile in TILES:
        for l_next in (8, 9, 10, 16):  # below, at and above the count (9), and every key
            srcpos, count, _ = mk.run_scan_plain(key, l_next)
            okey, out = _host_round(lib, key, pt, srcpos, count, tile)
            want_key, want = mk.compact_add_plain(key, pt, srcpos, count)
            assert torch.equal(okey, want_key)
            assert all(torch.equal(g, w) for g, w in zip(out, want))


@pytest.fixture(scope="module")
def planted_round():
    """Sorted keys whose first eight survivors all add (a tile of 8 or 6 slots
    that is all additions), then eight lone keys (tiles with no addition), then
    pairs with the left infinite, the right infinite, both infinite, P and P,
    P and -P, runs of 3 and 5 across tile edges, and a MAXKEY tail."""
    pts = [_host(k) for k in range(2, 40)]
    a, b = pts[0], pts[1]
    keys, points = [], []
    for i in range(8):  # eight pairs, each of two finite, distinct points
        keys += [i, i]
        points += [pts[2 + 2 * i], pts[3 + 2 * i]]
    keys += list(range(8, 16))  # lone keys
    points += pts[18:26]
    planted = [[None, a], [a, None], [None, None], [a, a], [a, hc.neg(a)], [b, a, b],
               [a, b, pts[26], pts[27], None]]
    for i, run in enumerate(planted):
        keys += [16 + i] * len(run)
        points += run
    keys += [mk.MAXKEY] * 3
    points += [None] * 3
    return _i32(keys), dc.pack_points(points, "cpu")


@pytest.mark.parametrize("tile", TILES)
def test_compact_tile_planted_cases_match_plain(lib, planted_round, tile):
    key, pt = planted_round
    count = int(mk.run_scan_plain(key, 1)[1])
    for l_next in sorted({count - 1, count, count + 1, key.shape[0]}):
        srcpos, count_t, _ = mk.run_scan_plain(key, l_next)
        okey, out = _host_round(lib, key, pt, srcpos, count_t, tile)
        want_key, want = mk.compact_add_plain(key, pt, srcpos, count_t)
        assert torch.equal(okey, want_key)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_planted_round_means_what_it_says(planted_round):
    key, pt = planted_round
    new_key, out = pp._compact_round(key, pt, 30)
    pts = dc.unpack_points(pt)
    a, b = _host(2), _host(3)
    got = dc.unpack_points(out)
    assert got[:8] == [hc.add(pts[2 * i], pts[2 * i + 1]) for i in range(8)]
    assert got[8:16] == pts[16:24]
    assert got[16:23] == [a, a, None, hc.double(a), None, hc.add(b, a), b]
    assert new_key[:23].tolist() == list(range(16)) + [16, 17, 18, 19, 20, 21, 21]


# ----------------------------------------------------------------------
# the window combine
# ----------------------------------------------------------------------

def _windows(segments):
    """(S, W, 12) Jacobian tables of host points (None: infinity)."""
    S, W = len(segments), len(segments[0])
    flat = dc.pack_points([pt for seg in segments for pt in seg], "cpu")
    return tuple(v.reshape(S, W, 12) for v in flat)


def test_horner_plain_matches_zktpu():
    segments = [[_host(3), _host(5), _host(7)], [None, _host(11), None]]
    per_window = _windows(segments)
    got = mk.horner_plain(per_window, 4)
    lm = tuple(jnp.asarray(np.moveaxis(np.stack([
        convert.points_to_zktpu(tuple(v[s] for v in per_window))[i] for s in range(2)]), -1, 0))
        for i in range(3))
    want = convert.points_from_zktpu([np.asarray(v) for v in jp._horner_multi_jit(lm, 4)],
                                     limb_major=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want_host = [hc.add(hc.multiply(seg[0], 1) if seg[0] else None, hc.add(
        hc.multiply(seg[1], 16) if seg[1] else None, hc.multiply(seg[2], 256) if seg[2] else None))
        for seg in segments]
    assert dc.unpack_points(got) == want_host


def test_horner_lane_matches_plain(lib):
    """coop381.cuh's chain (a chain's lanes fibers) on three segments of
    four windows: random points, an infinite top window, and every window
    infinite; c = 4 and c = 1; one window alone."""
    rng = np.random.default_rng(9)
    rand = [_host(int(k)) for k in rng.integers(1, 1 << 40, size=8)]
    segments = [rand[:4], [None] + rand[4:7], [None] * 4]
    segments = [seg[::-1] for seg in segments]  # window W - 1 first in the lists above
    per_window = _windows(segments)
    for c, pw in ((4, per_window), (1, per_window), (4, tuple(v[:, :1].contiguous()
                                                             for v in per_window))):
        S, W = pw[0].shape[:2]
        out = tuple(torch.empty((S, 12), dtype=torch.int32) for _ in range(3))
        lib.horner(_ptrs(pw), S, W, c, _ptrs(out))
        want = mk.horner_plain(pw, c)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def _group(segments, c):
    return _windows([seg[::-1] for seg in segments]), c  # lists from the top window down


def _ragged_groups():
    """Groups of mixed c, windows and segments; every top window finite (an
    infinite one is held against zktpu above, and here below), windows of
    infinity inside; two groups of one shape, which the plain version runs as
    one chain."""
    p = [_host(k) for k in (3, 5, 7, 11, 13, 17, 19, 23)]
    return [
        _group([[p[0], p[1], None]], 4),
        _group([[p[2], None], [p[3], p[4]]], 8),
        _group([[p[5], None, p[6]]], 16),
        _group([[p[7], None, p[0]], [p[1], None, None]], 4),
    ]


#: zktpu's _horner_multi jitted with c an argument: one compile serves every c
_zktpu_horner = jax.jit(jp._horner_multi)


def _zktpu_horner_padded(per_window, c, segments=2, windows=3):
    """zktpu's chain of a group padded to (segments, windows): infinite windows
    on top (its own top window finite, the chain's words do not change) and
    infinite segments; its first S rows."""
    S, W = per_window[0].shape[:2]
    inf = dc.infinity_like((segments, windows), "cpu")
    padded = tuple(p.clone() for p in inf)
    for v, t in zip(padded, per_window):
        v[:S, :W] = t
    lm = tuple(jnp.asarray(np.moveaxis(np.stack([
        convert.points_to_zktpu(tuple(v[s] for v in padded))[i] for s in range(segments)]), -1, 0))
        for i in range(3))
    out = convert.points_from_zktpu([np.asarray(v) for v in _zktpu_horner(lm, c)], limb_major=True)
    return tuple(v[:S] for v in out)


def test_horner_groups_plain_matches_zktpu():
    groups = _ragged_groups()
    got = mk.horner_groups_plain(groups)
    assert [tuple(v.shape) for v in got[1]] == [(2, 12)] * 3
    for (per_window, c), out in zip(groups, got):
        want = _zktpu_horner_padded(per_window, c)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_horner_kernel_chain_table_matches_plain(lib):
    """The kernel's blocks over ``chain_table``'s rows, a chain on a group of 8
    lanes (coop381.cuh's horner_group, the lanes fibers), against
    horner_groups_plain; the groups of ``_ragged_groups`` plus an infinite top
    window and an infinite segment."""
    p = [_host(k) for k in (29, 31)]
    groups = _ragged_groups() + [_group([[None, p[0]], [None, None]], 2)]
    table, chains = mk.chain_table(groups)
    assert chains.tolist() == [[0, 3, 4], [3, 2, 8], [5, 2, 8], [7, 3, 16], [10, 3, 4],
                               [13, 3, 4], [16, 2, 2], [18, 2, 2]]
    n = chains.shape[0]
    out = tuple(torch.empty((n, 12), dtype=torch.int32) for _ in range(3))
    lib.horner_chains(_ptrs(table), _ptr(chains), n, _ptrs(out))
    want = mk.horner_groups_plain(groups)
    assert all(torch.equal(g, torch.cat([w[i] for w in want])) for i, g in enumerate(out))


def _mont_words(values):
    return torch.tensor(np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(12)]
                                  for v in values], dtype=np.uint32).view(np.int32))


def _word_ints(t):
    return [sum(int(w) << (32 * k) for k, w in enumerate(row))
            for row in t.numpy().view(np.uint32)]


def test_coop_mul_matches_host_field(lib):
    """coop381.cuh's product (lanes as fibers) on 0, 1, p - 1, R mod p,
    lazy values in [p, 2p) and random ones: a b / R mod p by field/host.py, and
    the lazy words of fq381.cuh's one-thread product."""
    spec = fq.spec
    p, r_inv = spec.modulus, host.inv(spec, (1 << 384) % spec.modulus)
    rng = np.random.default_rng(12)
    edges = [0, 1, p - 1, (1 << 384) % p, p, p + 1, 2 * p - 1]
    rand = [int.from_bytes(rng.bytes(48), "little") % (2 * p) for _ in range(12)]
    pairs = [(x, y) for x in edges for y in edges] + list(zip(rand, rand[::-1]))
    a, b = _mont_words([x for x, _ in pairs]), _mont_words([y for _, y in pairs])
    n = len(pairs)
    got, one = torch.empty_like(a), torch.empty_like(a)
    lib.mul_coop(_ptr(a), _ptr(b), _ptr(got), n)
    lib.mul_one(_ptr(a), _ptr(b), _ptr(one), n)
    assert torch.equal(got, one)
    values = _word_ints(got)
    assert all(v < 2 * p for v in values)
    assert [v % p for v in values] == [host.mul(spec, host.mul(spec, x, y), r_inv)
                                      for x, y in pairs]


def test_commit_quotients_matches_per_step_msms(monkeypatch):
    """On one device the quotient steps' window combines run as one
    horner_groups call; each step's result is msm_pippenger_multi's. Both
    sides' chains run on the host curve's affine arithmetic in place of the
    plain chain's some 250 eager doublings (the results are compared as host
    points)."""
    calls = []

    def host_horner(per_window, c):
        S, W = per_window[0].shape[:2]
        table = dc.unpack_points(tuple(v.reshape(S * W, 12) for v in per_window))
        acc = []
        for seg in range(S):
            point = None
            for w in range(W - 1, -1, -1):
                point = hc.add(hc.multiply(point, 1 << c) if point else None, table[seg * W + w])
            acc.append(point)
        calls.append(S)
        return dc.pack_points(acc, "cpu")

    monkeypatch.setattr(mk, "horner_plain", host_horner)
    spec_ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
    rng = np.random.default_rng(13)
    kzg = KZG.setup(2, [5, 9], device="cpu")
    tables = [[int(v) for v in rng.integers(0, 1 << 62, size=4)] for _ in range(2)]
    openings = [kzg._quotients(7, [3, 4], MultilinearPoly.from_ints(spec_ctx, t)) for t in tables]
    got = kzg._commit_quotients(*openings)
    assert calls == [4]  # both steps' two segments in one chain (one window width)
    bases = kzg.collapsed_bases()
    steps = [pp.msm_pippenger_multi(bases[k], torch.stack([q[k] for q in openings]))
             for k in range(2)]
    want = [[dc.unpack_points(tuple(v[s:s + 1] for v in step))[0] for step in steps]
            for s in range(2)]
    assert got == want


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------

def test_wrappers_take_the_plain_versions_on_the_cpu(round_case):
    key, pt, _ = round_case
    mk.reset_launches()
    scan = mk.run_scan(key, 12)
    assert all(torch.equal(g, w) for g, w in zip(scan, mk.run_scan_plain(key, 12)))
    got_key, got = mk.compact_add(key, pt, *scan[:2])
    want_key, want = mk.compact_add_plain(key, pt, *scan[:2])
    assert torch.equal(got_key, want_key) and all(torch.equal(g, w) for g, w in zip(got, want))
    pw = tuple(v[:2, None].contiguous() for v in pt)
    assert all(torch.equal(g, w) for g, w in zip(mk.horner(pw, 4), mk.horner_plain(pw, 4)))
    groups = [(pw, 4), (tuple(v[:3].reshape(1, 3, 12) for v in pt), 2)]
    for got, want in zip(mk.horner_groups(groups), mk.horner_groups_plain(groups)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    a, b = pt[0], pt[1]
    assert torch.equal(mk.fq_mul_coop(a, b), mk.fq_mul_coop_plain(a, b))
    assert torch.equal(mk.fq_mul_coop_plain(a, b), fb.mont_mul(fq, a, b))
    assert mk.launches == {"run_scan": 0, "compact_add": 0, "horner": 0}


def test_wrappers_raise_on_what_the_kernels_do_not_take(round_case):
    key, pt, _ = round_case
    srcpos, count, _ = mk.run_scan(key, 12)
    with pytest.raises(TypeError):
        mk.run_scan(key.to(torch.int64), 12)
    with pytest.raises(ValueError):
        mk.run_scan(key[::2], 4)  # not contiguous
    with pytest.raises(ValueError):
        mk.run_scan(key[:0], 1)
    with pytest.raises(ValueError):
        mk.run_scan(key.reshape(4, 4), 4)
    for bad in (0, 1 << 31, 3.0):
        with pytest.raises(ValueError):
            mk.run_scan(key, bad)
    with pytest.raises(ValueError):
        mk.compact_add(key[:15], pt, srcpos, count)  # points of another width
    with pytest.raises(ValueError):
        mk.compact_add(key, pt, srcpos, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        mk.compact_add(key, pt, srcpos.to(torch.int64), count)
    with pytest.raises(TypeError):
        mk.compact_add(key, (pt[0], pt[1], pt[2].to(torch.int64)), srcpos, count)
    pw = tuple(v[:2, None].contiguous() for v in pt)
    with pytest.raises(ValueError):
        mk.horner(tuple(v[:, 0] for v in pw), 4)  # (S, 12): no window axis
    with pytest.raises(ValueError):
        mk.horner(pw, 0)
    with pytest.raises(TypeError):
        mk.horner(pw[:2], 4)
    with pytest.raises(TypeError):
        mk.horner_groups([])
    with pytest.raises(TypeError):
        mk.horner_groups([pw])  # no c
    with pytest.raises(ValueError):
        mk.horner_groups([(pw, 4), (pw, True)])
    with pytest.raises(ValueError):
        mk.fq_mul_coop(pt[0], pt[1][:15])
    with pytest.raises(ValueError):
        mk.fq_mul_coop(pt[0].reshape(2, 8, 12), pt[1].reshape(2, 8, 12))  # not (n, 12)
