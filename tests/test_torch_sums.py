"""The one-launch summing kernels ``halves_sums`` and ``fold_and_halves``, built
for the host.

Their per-thread work, the runs of the table their blocks take and the index
arithmetic of their epilogue and finish (the shared columns' slots, the lanes'
shares, the partials' layout, the finish's thread groups, the carry ripple)
live in ``csrc/sums.cuh``, on ``csrc/mont.cuh``'s Montgomery core, whose PTX
carry-chain primitives (``csrc/carry.cuh``) have a host emulation. So the
kernels' work compiles with the host's C++ compiler and runs here, block by
block, thread by thread and vector by vector as the grid and the run
arithmetic assign it, through the block's shared columns (each slot written
once) and the partials, then the last block's finish, group by group; the
warps' shuffles become sums over their lanes. Held, tolerance 0:

  * ``mont::lerp`` against ``fold_plain`` for the four fields;
  * both kernels' rows (and the folded table) against ``halves_sums_plain`` and
    ``fold_and_halves_plain`` at every size from 2 to 2^12, on the one-block
    grid and at several block counts a row, odd ones and more than the rows
    hold included;
  * ``fold_and_halves``'s runs: a row's blocks take it whole, in order, each
    run a whole number of 32 entries but the last.

The shuffles, fences and tickets run only on the card: ``chip_smoke.py`` holds
the kernels there against the same plain versions.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(fk.__file__), "..", "csrc")
SPECS = {"bn254_fq": BN254_FQ, "bn254_fr": BN254_FR, "bls12_381_fr": BLS12_381_FR,
         "bls12_381_fq": BLS12_381_FQ}
LOG_SIZES = range(1, 13)
#: blocks a row: 0 (one block for both rows), odd counts, powers of two, and
#: more blocks than 32-entry runs or than a row's vectors
BLOCK_COUNTS = (0, 1, 2, 3, 7, 8, 33, 132)

HARNESS = r"""
#include <cstddef>
#include <vector>
#include "sums.cuh"

template <int W>
mont::Modulus<W> modulus(const uint32_t* p, uint32_t n0) {
  mont::Modulus<W> m;
  for (int j = 0; j < W; ++j) m.p[j] = p[j];
  m.n0 = n0;
  return m;
}

template <int W>
void lerp_n(const mont::Modulus<W>& M, const uint32_t* a, const uint32_t* b, const uint32_t* r,
            uint32_t* out, long n) {
  const uint32_t(&rr)[W] = *(const uint32_t(*)[W])r;
  for (long i = 0; i < n; ++i)
    mont::lerp<W>(*(uint32_t(*)[W])(out + W * i), *(const uint32_t(*)[W])(a + W * i),
                  *(const uint32_t(*)[W])(b + W * i), rr, M);
}

// The block's epilogue as the kernel runs it: a warp a column, lane by lane
// (lane_shares), the warp's shuffles a sum over its lanes; on the one-block
// grid lo is row 0's and hi row 1's, else their sum goes to the partials.
template <int N, int C, typename T>
void epilogue(const T (&cols)[C][N], bool one, int y, int b, int nbr, uint64_t (&both)[2][C],
              std::vector<uint64_t>& partials) {
  for (int c = 0; c < C; ++c) {
    uint64_t lo = 0, hi = 0;
    for (int lane = 0; lane < 32; ++lane) {
      uint64_t l, h;
      sums::lane_shares<N>(cols[c], lane, l, h);
      lo += l;
      hi += h;
    }
    if (one) {
      both[0][c] = lo;
      both[1][c] = hi;
    } else {
      partials[sums::partial_at(y, c, b, C, nbr)] = lo + hi;
    }
  }
}

// The last block's finish of row h: a group of threads a column, thread by
// thread (group_share), the group's shuffles a sum over its threads, then the
// carries rippled.
template <int W, int C, int kT>
void finish_row(const std::vector<uint64_t>& partials, int h, int nbr, uint32_t* rows) {
  constexpr int G = sums::kGroup<C, kT>;
  uint64_t cols[C] = {};
  for (int t = 0; t < kT; ++t) {
    const int c = t / G, j = t % G;
    if (c < C) cols[c] += sums::group_share<G>(partials.data(), h, c, C, j, nbr);
  }
  sums::ripple<W, C>(rows + h * (W + 1), cols);
}

// Grid (nbr, 2), or (1, 1) for nbr = 0: block (b, y) as the kernel runs it,
// thread by thread, each thread's sums put in the block's shared columns at
// its slots; returns -1 if two threads share a slot or a slot stays empty.
template <int W>
int halves(const uint32_t* table, long long size, int nbr, uint32_t* rows) {
  constexpr int kT = sums::kHalvesThreads<W>;
  constexpr int kPerColumn = kT / (W / 4);
  const bool one = nbr == 0;
  const int gx = one ? 1 : nbr, gy = one ? 1 : 2;
  std::vector<uint64_t> partials((size_t)2 * W * gx);
  uint64_t both[2][W];
  for (int y = 0; y < gy; ++y)
    for (int b = 0; b < gx; ++b) {
      uint64_t cols[W][kPerColumn];
      int written[W][kPerColumn] = {};
      for (int t = 0; t < kT; ++t) {
        const sums::Lane me = sums::lane_of(one, y, t, kT);
        uint64_t s[4] = {0, 0, 0, 0};
        sums::halves_thread<W>(s, table, size / 2, me.h, b, gx, me.t, me.threads);
        for (int k = 0; k < 4; ++k) {
          const int c = sums::halves_column<W>(t, k), slot = sums::halves_slot<W>(t);
          cols[c][slot] = s[k];
          ++written[c][slot];
        }
      }
      for (int c = 0; c < W; ++c)
        for (int slot = 0; slot < kPerColumn; ++slot)
          if (written[c][slot] != 1) return -1;
      epilogue<kPerColumn, W>(cols, one, y, b, gx, both, partials);
    }
  if (one) {  // the block ripples both rows itself
    for (int h = 0; h < 2; ++h) sums::ripple<W, W>(rows + h * (W + 1), both[h]);
  } else {
    for (int h = 0; h < 2; ++h) finish_row<W, W, kT>(partials, h, gx, rows);
  }
  return 0;
}

template <int W>
void fold_halves(const mont::Modulus<W>& M, const uint32_t* table, const uint32_t* r_words,
                 long long size, int nbr, uint32_t* out, uint32_t* rows) {
  constexpr int C = W + 1;
  constexpr int kT = sums::kFoldThreads;
  const bool one = nbr == 0;
  const int gx = one ? 1 : nbr, gy = one ? 1 : 2;
  uint32_t r[W];
  for (int j = 0; j < W; ++j) r[j] = r_words[j];
  std::vector<uint64_t> partials((size_t)2 * C * gx);
  uint64_t both[2][C];
  for (int y = 0; y < gy; ++y)
    for (int b = 0; b < gx; ++b) {
      uint32_t words[C][kT];
      for (int t = 0; t < kT; ++t) {
        const sums::Lane me = sums::lane_of(one, y, t, kT);
        uint32_t acc[C] = {};
        sums::fold_thread<W>(acc, table, r, out, size / 2, sums::fold_run(me.h, size / 2, b, gx),
                             me.t, me.threads, M);
        for (int c = 0; c < C; ++c) words[c][t] = acc[c];
      }
      epilogue<kT, C>(words, one, y, b, gx, both, partials);
    }
  if (one) {
    for (int h = 0; h < 2; ++h) sums::ripple<W, C>(rows + h * (W + 1), both[h]);
  } else {
    for (int h = 0; h < 2; ++h) finish_row<W, C, kT>(partials, h, gx, rows);
  }
}

extern "C" {
void sm_lerp(int W, const uint32_t* p, uint32_t n0, const uint32_t* a, const uint32_t* b,
             const uint32_t* r, uint32_t* out, long n) {
  if (W == 8) lerp_n<8>(modulus<8>(p, n0), a, b, r, out, n);
  else lerp_n<12>(modulus<12>(p, n0), a, b, r, out, n);
}

int sm_halves(int W, const uint32_t* table, long long size, int nbr, uint32_t* rows) {
  return W == 8 ? halves<8>(table, size, nbr, rows) : halves<12>(table, size, nbr, rows);
}

void sm_fold_halves(int W, const uint32_t* p, uint32_t n0, const uint32_t* table,
                    const uint32_t* r, long long size, int nbr, uint32_t* out, uint32_t* rows) {
  if (W == 8) fold_halves<8>(modulus<8>(p, n0), table, r, size, nbr, out, rows);
  else fold_halves<12>(modulus<12>(p, n0), table, r, size, nbr, out, rows);
}

void sm_fold_run(int h, long long half, int b, int nbr, long long* begin_end) {
  const sums::Run run = sums::fold_run(h, half, b, nbr);
  begin_end[0] = run.begin;
  begin_end[1] = run.end;
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sums")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libsums_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, str(src),
                    "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I, _U, _L, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_long,
                           ctypes.c_longlong)
    lib.sm_lerp.argtypes = [_I, _P, _U, _P, _P, _P, _P, _L]
    lib.sm_halves.argtypes = [_I, _P, _LL, _I, _P]
    lib.sm_halves.restype = _I
    lib.sm_fold_halves.argtypes = [_I, _P, _U, _P, _P, _LL, _I, _P, _P]
    lib.sm_fold_run.argtypes = [_I, _LL, _I, _I, _P]
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _pack(values, w: int) -> np.ndarray:
    return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(w)] for v in values],
                    dtype=np.uint32)


def _modulus(spec):
    return _pack([spec.modulus], spec.num_words)[0], spec.n0_prime32, spec.num_words


def _words(t) -> np.ndarray:
    """An int32 word tensor as a contiguous uint32 array."""
    return np.ascontiguousarray(t.numpy().view(np.uint32))


def _tensor(words: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy())


def _canonical(spec, rng, n: int, edges=()) -> np.ndarray:
    """n canonical Montgomery words (random values below p), ``edges`` first."""
    p = spec.modulus
    vals = [int.from_bytes(rng.bytes(4 * spec.num_words), "little") % p for _ in range(n)]
    vals[: len(edges)] = list(edges)[:n]
    return _pack(vals, spec.num_words)


def _challenges(spec, rng):
    p = spec.modulus
    return [0, 1, p - 1, spec.R % p, int.from_bytes(rng.bytes(4 * spec.num_words), "little") % p]


@pytest.mark.parametrize("field", list(SPECS))
def test_lerp_equals_fold_plain(lib, field):
    spec = SPECS[field]
    ctx = fb.get_ctx(spec, device="cpu")
    p_words, n0, w = _modulus(spec)
    p = spec.modulus
    rng = np.random.default_rng(3)
    edges = (0, 1, p - 1, p - 1, 0, 1, p - 2, spec.R % p)
    a = _canonical(spec, rng, 256, edges)
    b = _canonical(spec, rng, 256, edges[::-1])
    for r_int in _challenges(spec, rng):
        r = _pack([r_int], w)[0]
        out = np.zeros_like(a)
        lib.sm_lerp(w, _ptr(p_words), n0, _ptr(a), _ptr(b), _ptr(r), _ptr(out), len(a))
        want = fk.fold_plain(ctx, _tensor(np.concatenate([a, b])), _tensor(r))
        assert np.array_equal(out, _words(want)), r_int


@pytest.mark.parametrize("field", list(SPECS))
def test_halves_sums_blocks_equal_plain(lib, field):
    spec = SPECS[field]
    ctx = fb.get_ctx(spec, device="cpu")
    w = spec.num_words
    rng = np.random.default_rng(5)
    p = spec.modulus
    top = (1 << (32 * w)) - 1
    for log_size in LOG_SIZES:
        size = 1 << log_size
        # any words: raw ones past p among them; then every word 0xFFFFFFFF,
        # where the column sums are at their largest
        raw = rng.integers(0, 1 << 32, size=(size, w), dtype=np.uint32)
        raw[:4] = _pack([top, p, p - 1, 0], w)[: size]
        for table in (raw, np.full((size, w), 0xFFFFFFFF, dtype=np.uint32)):
            want = _words(fk.halves_sums_plain(ctx, _tensor(table)))
            for nbr in BLOCK_COUNTS:
                rows = np.zeros((2, w + fk.EXTRA_WORDS), dtype=np.uint32)
                assert lib.sm_halves(w, _ptr(table), size, nbr, _ptr(rows)) == 0, (size, nbr)
                assert np.array_equal(rows, want), (size, nbr)


@pytest.mark.parametrize("field", list(SPECS))
def test_fold_and_halves_blocks_equal_plain(lib, field):
    spec = SPECS[field]
    ctx = fb.get_ctx(spec, device="cpu")
    p_words, n0, w = _modulus(spec)
    p = spec.modulus
    rng = np.random.default_rng(7)
    challenges = _challenges(spec, rng)
    for log_size in LOG_SIZES:
        size = 1 << log_size
        table = _canonical(spec, rng, size, (p - 1, 0, 1, p - 1))
        for k, nbr in enumerate(BLOCK_COUNTS):
            r = _pack([challenges[(log_size + k) % len(challenges)]], w)[0]
            folded_want, rows_want = fk.fold_and_halves_plain(ctx, _tensor(table), _tensor(r))
            out = np.zeros((size // 2, w), dtype=np.uint32)
            rows = np.zeros((2, w + fk.EXTRA_WORDS), dtype=np.uint32)
            lib.sm_fold_halves(w, _ptr(p_words), n0, _ptr(table), _ptr(r), size, nbr, _ptr(out),
                               _ptr(rows))
            assert np.array_equal(out, _words(folded_want)), (size, nbr)
            assert np.array_equal(rows, _words(rows_want)), (size, nbr)


def test_fold_runs_cover_each_row_in_order(lib):
    span = np.zeros(2, dtype=np.int64)
    for log_size in range(1, 16):
        half = 1 << (log_size - 1)
        quarter = half // 2
        for nbr in BLOCK_COUNTS[1:] + (132, 264):
            for h, (lo, hi) in enumerate(((0, quarter), (quarter, half))):
                at = lo
                for b in range(nbr):
                    lib.sm_fold_run(h, half, b, nbr, _ptr(span))
                    begin, end = int(span[0]), int(span[1])
                    assert begin == at and begin <= end <= hi, (log_size, nbr, h, b)
                    if end < hi:
                        assert (end - begin) % 32 == 0
                    at = end
                assert at == hi, (log_size, nbr, h)
