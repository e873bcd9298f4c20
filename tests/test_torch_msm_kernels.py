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
  * the scan's own code, ``csrc/compact.cuh`` built with g++, run in the three
    passes of the kernel (each block's tiles reduced as a tree, the blocks'
    aggregates scanned in chunks, each tile applied from its prefix) with tiles
    of 4 to 8 keys, so that runs cross one, two and many tiles and blocks,
    against ``run_scan_plain``;
  * ``compact_add_plain`` after ``run_scan_plain`` against zktpu's
    ``_compact_round`` on 16 keys whose runs meet the doubling branch, an
    infinite operand on either side, P == -Q, a lone left and padding keys, in
    Jacobian words and keys; ``compact.cuh``'s slot (on ``fq381.cuh``) against
    ``compact_add_plain`` with ``l_next`` below, at and above the count;
  * ``horner_plain`` against zktpu's ``_horner_multi`` at two segments, three
    windows, c = 4, infinities mixed in; ``fq381.cuh``'s ``horner_lane`` built
    with g++ against ``horner_plain``;
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
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.msm import kernels as mk
from zktpu_torch.msm import pippenger as pp

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(mk.__file__), "..", "csrc")
fq = dc.fq_ctx("cpu")

HARNESS = r"""
#include <algorithm>
#include <vector>

#include "compact.cuh"

using compact::Agg;

namespace {

// inclusive scan of s, in order, as the kernels' Hillis-Steele loop takes it
void hillis_steele(std::vector<Agg>& s) {
  const int n = (int)s.size();
  for (int d = 1; d < n; d *= 2) {
    std::vector<Agg> v = s;
    for (int t = d; t < n; ++t) v[t] = compact::combine(s[t - d], s[t]);
    s = v;
  }
}

}  // namespace

extern "C" {

// run_scan's three passes, a block of `tiles` tiles of `items` keys, the
// blocks' aggregates scanned `chunk` at a time
void scan(const int32_t* key, int n, int items, int tiles, int chunk, int32_t* srcpos,
          int l_next, int32_t* count, int32_t* longest) {
  const long block_keys = (long)items * tiles;
  const int blocks = (int)((n + block_keys - 1) / block_keys);
  auto tile = [&](int b, int t) {
    const long lo = b * block_keys + (long)t * items;
    if (lo >= n) return compact::identity();
    return compact::tile_aggregate(key, (int32_t)lo, (int32_t)std::min<long>(lo + items, n));
  };
  std::vector<Agg> agg(blocks), s(tiles);
  for (int b = 0; b < blocks; ++b) {  // pass 1: a tree over the block's tiles
    for (int t = 0; t < tiles; ++t) s[t] = tile(b, t);
    for (int stride = 1; stride < tiles; stride *= 2) {
      for (int t = 0; t + stride < tiles; t += 2 * stride) s[t] = compact::combine(s[t], s[t + stride]);
    }
    agg[b] = s[0];
  }
  Agg carry = compact::identity();  // pass 2: exclusive prefixes, in place
  for (int base = 0; base < blocks; base += chunk) {
    std::vector<Agg> c(chunk);
    for (int t = 0; t < chunk; ++t) c[t] = base + t < blocks ? agg[base + t] : compact::identity();
    hillis_steele(c);
    for (int t = 0; t < chunk && base + t < blocks; ++t) {
      agg[base + t] = compact::combine(carry, t > 0 ? c[t - 1] : compact::identity());
    }
    carry = compact::combine(carry, c[chunk - 1]);
  }
  *count = carry.lefts[0];
  *longest = 0;
  for (int b = 0; b < blocks; ++b) {  // pass 3
    for (int t = 0; t < tiles; ++t) s[t] = tile(b, t);
    hillis_steele(s);
    for (int t = 0; t < tiles; ++t) {
      const long lo = b * block_keys + (long)t * items;
      if (lo >= n) continue;
      const Agg before = compact::combine(agg[b], t > 0 ? s[t - 1] : compact::identity());
      const int32_t run = compact::apply_tile(key, (int32_t)lo,
                                              (int32_t)std::min<long>(lo + items, n), before,
                                              srcpos, l_next);
      *longest = std::max(*longest, run);
    }
  }
  for (long j = *count; j < l_next; ++j) srcpos[j] = n - 1;
}

void slots(const int32_t* key, const uint32_t* const* pt, int n, const int32_t* srcpos,
           int32_t count, int l_next, int max_key, int32_t* okey, uint32_t* const* out) {
  for (int j = 0; j < l_next; ++j) {
    compact::compact_slot(j, key, pt[0], pt[1], pt[2], n, srcpos, count, max_key, okey, out[0],
                          out[1], out[2]);
  }
}

void horner(const uint32_t* const* pw, int segments, int windows, int c, uint32_t* const* out) {
  for (long s = 0; s < segments; ++s) {
    const long in = s * windows * 12;
    fq381::horner_lane(pw[0] + in, pw[1] + in, pw[2] + in, windows, c, out[0] + 12 * s,
                       out[1] + 12 * s, out[2] + 12 * s);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("msm_kernels")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libmsm_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, str(src),
                    "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.scan.argtypes = [_P, _I, _I, _I, _I, _P, _I, _P, _P]
    lib.slots.argtypes = [_P, _P, _I, _P, _I, _I, _I, _P, _P]
    lib.horner.argtypes = [_P, _I, _I, _I, _P]
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


@pytest.mark.parametrize("items, tiles, chunk", [(4, 1, 1), (5, 2, 3), (8, 4, 2), (6, 3, 8)])
def test_compact_cuh_scan_matches_plain(lib, items, tiles, chunk):
    for key in KEY_SETS.values():
        n = key.shape[0]
        for l_next in _l_nexts(key):
            srcpos = torch.full((l_next,), -7, dtype=torch.int32)
            count = torch.zeros(1, dtype=torch.int32)
            longest = torch.zeros(1, dtype=torch.int32)
            lib.scan(_ptr(key), n, items, tiles, chunk, _ptr(srcpos), l_next, _ptr(count),
                     _ptr(longest))
            want = mk.run_scan_plain(key, l_next)
            assert all(torch.equal(g, w) for g, w in zip((srcpos, count, longest), want))


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


def test_compact_slot_matches_plain(lib, round_case):
    key, pt, _ = round_case
    n = key.shape[0]
    for l_next in (8, 9, 10, 16):  # below, at and above the count (9), and every key
        srcpos, count, _ = mk.run_scan_plain(key, l_next)
        okey = torch.empty(l_next, dtype=torch.int32)
        out = tuple(torch.empty((l_next, 12), dtype=torch.int32) for _ in range(3))
        lib.slots(_ptr(key), _ptrs(pt), n, _ptr(srcpos), int(count), l_next, mk.MAXKEY,
                  _ptr(okey), _ptrs(out))
        want_key, want = mk.compact_add_plain(key, pt, srcpos, count)
        assert torch.equal(okey, want_key)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


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
    """Three segments of four windows: random points, an infinite top window,
    and every window infinite; c = 4 and c = 1; one window alone."""
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
