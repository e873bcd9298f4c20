"""The carry-chain Montgomery core ``csrc/mont.cuh``, built for the host.

``gkr_round`` and ``ntt_phase1`` run on this core. Its PTX carry-chain
primitives (``csrc/carry.cuh``) have a host emulation, so the core and the two
kernels' per-lane work compile with the host's C++ compiler and run here
without a card. Held, tolerance 0:

  * the product, sum and difference against Python integers for the three
    8-word fields and BLS12-381 Fq at 12 words, edge values included;
  * ``gkr_round``'s work, summed over a stack, against ``gkr_round_plain``:
    an index a call (large tables) and an (index, t) pair a call (small ones);
  * ``ntt_phase1``'s tile steps, run block by block and thread by thread as the
    kernel runs them, against ``ntt_phase1_plain``, at every size from 1 to
    2^11 and every tile, forward and inverse;
  * the shared-memory layout: under every window of every chunk, a warp's row
    and twiddle accesses hit distinct banks.

The kernels themselves run only on the card: ``chip_smoke.py`` holds them there
against the same plain versions.
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
from zktpu_torch.ntt import ntt_kernels as nk

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(fk.__file__), "..", "csrc")
SPECS = {"bn254_fq": BN254_FQ, "bn254_fr": BN254_FR, "bls12_381_fr": BLS12_381_FR,
         "bls12_381_fq": BLS12_381_FQ}

HARNESS = r"""
#include <vector>
#include "mont.cuh"

template <int W>
mont::Modulus<W> modulus(const uint32_t* p, uint32_t n0) {
  mont::Modulus<W> m;
  for (int j = 0; j < W; ++j) m.p[j] = p[j];
  m.n0 = n0;
  return m;
}

template <int W>
void op(int which, const mont::Modulus<W>& M, const uint32_t* a, const uint32_t* b, uint32_t* out,
        long n) {
  for (long i = 0; i < n; ++i) {
    const uint32_t(&x)[W] = *(const uint32_t(*)[W])(a + W * i);
    const uint32_t(&y)[W] = *(const uint32_t(*)[W])(b + W * i);
    uint32_t(&o)[W] = *(uint32_t(*)[W])(out + W * i);
    switch (which) {
      case 0: mont::mul<W>(o, x, y, M); break;
      case 1: mont::add<W>(o, x, y, M); break;
      default: mont::sub<W>(o, x, y, M); break;
    }
  }
}

template <int W>
void gkr_rows(const mont::Modulus<W>& M, const uint32_t* tables, long long size, int split,
              uint32_t* rows) {
  uint32_t acc[3][W + 1] = {};
  auto add_term = [&](int t, const uint32_t (&term)[W]) { mont::acc_add<W>(acc[t], term); };
  if (split) {
    for (long long g = 0; g < 3 * (size / 2); ++g)
      mont::gkr_round_term<W>(add_term, (int)(g / (size / 2)), tables, size, g % (size / 2), M);
  } else {
    for (long long i = 0; i < size / 2; ++i) mont::gkr_round_index<W>(add_term, tables, size, i, M);
  }
  for (int t = 0; t < 3; ++t)
    for (int j = 0; j <= W; ++j) rows[t * (W + 1) + j] = acc[t][j];
}

extern "C" {
void mt_op(int W, int which, const uint32_t* p, uint32_t n0, const uint32_t* a, const uint32_t* b,
           uint32_t* out, long n) {
  if (W == 8) op<8>(which, modulus<8>(p, n0), a, b, out, n);
  else op<12>(which, modulus<12>(p, n0), a, b, out, n);
}

// split: a call an (index, t) pair, as the kernel on small tables, else a call
// an index
void mt_gkr_rows(int W, const uint32_t* p, uint32_t n0, const uint32_t* tables, long long size,
                 int split, uint32_t* rows) {
  if (W == 8) gkr_rows<8>(modulus<8>(p, n0), tables, size, split, rows);
  else gkr_rows<12>(modulus<12>(p, n0), tables, size, split, rows);
}

// ntt_phase1's kernel, block after block; within a block each step runs for
// every thread before the next (a barrier stands between them on the card)
void mt_ntt_phase1(const uint32_t* p, uint32_t n0, const uint32_t* x, const uint32_t* ctw,
                   uint32_t* out, int log_n, int log_tile) {
  using namespace ntt_tile;
  const Mod M = modulus<8>(p, n0);
  const int log_chunk = log_n < kLogChunk ? log_n : kLogChunk;
  const int lx = log_chunk > 3 ? log_chunk : 3;
  const int threads = 1 << (lx - 3);
  static TilePlanes tile;
  static TwPlanes tw;
  std::vector<Rows> e(threads);
  for (long long blk = 0; blk < (1LL << (log_n - log_chunk)); ++blk) {
    const long long base = blk << log_chunk;
    for (int t = 0; t < threads; ++t) gather(e[t], x, t, base, log_n, log_chunk);
    for (int t = 0; t < threads; ++t) stage_twiddles(tw, ctw, t, threads, log_chunk);
    int b = 0;
    for (int first = 1; first <= log_tile; first += 3) {
      const int nb = window(first, lx);
      if (nb != b) {
        for (int t = 0; t < threads; ++t) store_rows(tile, e[t], t, b);
        for (int t = 0; t < threads; ++t) load_rows(e[t], tile, t, nb);
        b = nb;
      }
      const int last = first + 2 < log_tile ? first + 2 : log_tile;
      for (int t = 0; t < threads; ++t) run_stages(e[t], tw, t, b, first, last, log_chunk, M);
    }
    for (int t = 0; t < threads; ++t) scatter(out, e[t], t, b, base, log_chunk);
  }
}

int mt_row_of(int t, int b, int m) { return ntt_tile::row_of(t, b, m); }
int mt_tile_col(int k) { return ntt_tile::tile_col(k); }
int mt_tw_col(int j) { return ntt_tile::tw_col(j); }
int mt_window(int first, int lx) { return ntt_tile::window(first, lx); }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mont")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libmont_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, str(src),
                    "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_long
    lib.mt_op.argtypes = [_I, _I, _P, _U, _P, _P, _P, _L]
    lib.mt_gkr_rows.argtypes = [_I, _P, _U, _P, ctypes.c_longlong, _I, _P]
    lib.mt_ntt_phase1.argtypes = [_P, _U, _P, _P, _P, _I, _I]
    for name in ("mt_row_of", "mt_tile_col", "mt_window"):
        getattr(lib, name).restype = _I
    lib.mt_row_of.argtypes = [_I, _I, _I]
    lib.mt_tile_col.argtypes = [_I]
    lib.mt_tw_col.argtypes = [_I]
    lib.mt_window.argtypes = [_I, _I]
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _modulus(spec):
    w = spec.num_words
    return _pack([spec.modulus], w)[0], spec.n0_prime32, w


def _pack(values, w: int) -> np.ndarray:
    return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(w)] for v in values],
                    dtype=np.uint32)


def _unpack(words) -> list[int]:
    return [sum(int(x) << (32 * j) for j, x in enumerate(row)) for row in words]


def _words(t) -> np.ndarray:
    """An int32 word tensor as a contiguous uint32 array."""
    return np.ascontiguousarray(t.numpy().view(np.uint32))


# -- the core against Python integers ----------------------------------------

def _operands(spec, rng):
    """Canonical values: every pair of the edges 0, 1, 2, p - 1, p - 2, R mod p,
    p // 2, then random ones."""
    p = spec.modulus
    edges = [0, 1, 2, p - 1, p - 2, spec.R % p, p // 2]
    rand = [int.from_bytes(rng.bytes(4 * spec.num_words), "little") % p for _ in range(300)]
    a = [x for x in edges for _ in edges] + rand
    b = [y for _ in edges for y in edges] + rand[::-1]
    return a, b


@pytest.mark.parametrize("field", list(SPECS))
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_core_against_python_ints(lib, field, op):
    spec = SPECS[field]
    p_words, n0, w = _modulus(spec)
    p = spec.modulus
    a, b = _operands(spec, np.random.default_rng(5))
    if op == "mul":  # mul's second operand may be any word string: R - 1 and p too
        b += [spec.R - 1, p, spec.R - 2, 2 * p]
        a += [p - 1, p - 1, 1, p - 2]
    x, y = _pack(a, w), _pack(b, w)
    out = np.zeros_like(x)
    lib.mt_op(w, ["mul", "add", "sub"].index(op), _ptr(p_words), n0, _ptr(x), _ptr(y), _ptr(out),
              len(a))
    r_inv = pow(spec.R, -1, p)
    want = {"mul": [u * v * r_inv % p for u, v in zip(a, b)],
            "add": [(u + v) % p for u, v in zip(a, b)],
            "sub": [(u - v) % p for u, v in zip(a, b)]}[op]
    assert _unpack(out) == want


# -- gkr_round's per-index work ----------------------------------------------

def _stack(spec, rng, size: int, edges=()):
    """A (2, 2, size, W) stack of canonical Montgomery words; the first entries
    of the flattened stack are ``edges``."""
    p = spec.modulus
    n = 4 * size
    vals = [int.from_bytes(rng.bytes(4 * spec.num_words), "little") % p for _ in range(n)]
    vals[: len(edges)] = edges
    words = _pack(vals, spec.num_words).reshape(2, 2, size, spec.num_words)
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("field", ["bn254_fq", "bls12_381_fr", "bls12_381_fq"])
@pytest.mark.parametrize("size", [2, 4, 64])
@pytest.mark.parametrize("split", [False, True], ids=["index", "index_and_t"])
def test_gkr_round_index_equals_plain(lib, field, size, split):
    spec = SPECS[field]
    ctx = fb.get_ctx(spec, device="cpu")
    p_words, n0, w = _modulus(spec)
    p = spec.modulus
    rng = np.random.default_rng(size)
    stacks = [_stack(spec, rng, size, edges=(0, 1, p - 1, p - 1, 0, 1)),
              torch.from_numpy(_pack([p - 1] * (4 * size), w).view(np.int32)
                               .reshape(2, 2, size, w).copy())]  # the largest column sums
    for stack in stacks:
        tables = _words(stack)
        rows = np.zeros((3, w + 1), dtype=np.uint32)
        lib.mt_gkr_rows(w, _ptr(p_words), n0, _ptr(tables), size, int(split), _ptr(rows))
        assert np.array_equal(rows, _words(fk.gkr_round_plain(ctx, stack)))


# -- ntt_phase1's tile steps ---------------------------------------------------

FR_CTX = fb.get_ctx(BN254_FR, device="cpu")


def _ntt_cases():
    cases = []
    for log_n in range(0, 12):
        tiles = range(0, min(nk.LOG_TILE, log_n) + 1)
        cases += [(log_n, log_tile) for log_tile in tiles]
    return cases


@pytest.fixture(scope="module")
def ntt_plain():
    """(log_n, inverse) -> (x, [ntt_phase1_plain at tile 0, 1, ..]): each tile
    from the last by one more plain stage, which is what ntt_phase1_plain does."""
    rng = np.random.default_rng(11)
    p = BN254_FR.modulus
    out = {}
    for log_n in range(0, 12):
        vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(1 << log_n)]
        vals[:4] = [0, 1, p - 1, BN254_FR.R % p][: 1 << log_n]
        x = torch.from_numpy(_pack(vals, 8).view(np.int32).copy())
        for inverse in (False, True):
            tw = nk.stage_twiddles(FR_CTX, log_n, inverse)
            ys = [nk.ntt_phase1_plain(FR_CTX, x, tw, 0)]
            for stage in range(1, min(nk.LOG_TILE, log_n) + 1):
                ys.append(nk.ntt_stage_plain(FR_CTX, ys[-1], tw, stage))
            out[log_n, inverse] = (x, ys)
    return out


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_phase1_tile_steps_equal_plain(lib, ntt_plain, inverse):
    p_words, n0, _ = _modulus(BN254_FR)
    for log_n, log_tile in _ntt_cases():
        x, ys = ntt_plain[log_n, inverse]
        tw = nk.stage_twiddles(FR_CTX, log_n, inverse)
        ctw = _words(nk.tile_twiddles(tw, log_n))
        xw = _words(x)
        out = np.zeros_like(xw)
        lib.mt_ntt_phase1(_ptr(p_words), n0, _ptr(xw), _ptr(ctw) if ctw.size else None,
                          _ptr(out), log_n, log_tile)
        assert np.array_equal(out, _words(ys[log_tile])), (log_n, log_tile)
        # the plain version itself, at this tile
        if log_n in (3, 10):
            assert torch.equal(ys[log_tile], nk.ntt_phase1_plain(FR_CTX, x, tw, log_tile))


@pytest.mark.parametrize("log_n", [0, 1, 5, 10, 13])
def test_tile_twiddles_are_the_powers_of_the_tile_root(log_n):
    """Entry j of the compact table is w^(j n / 2^c), c = min(10, log_n), and the
    cached table is the one a fresh gather gives."""
    spec = BN254_FR
    p = spec.modulus
    c = min(nk.LOG_TILE, log_n)
    for inverse in (False, True):
        tw = nk.stage_twiddles(FR_CTX, log_n, inverse)
        ctw = nk.tile_twiddles(tw, log_n)
        assert nk.tile_twiddles(tw, log_n) is ctw  # cached with its table
        root = spec.root_of_unity(1 << c) if c else 1
        if inverse:
            root = pow(root, -1, p)
        want = [pow(root, j, p) * spec.R % p for j in range((1 << c) // 2)]
        assert [int(v) for v in FR_CTX.unpack(ctw)] == want
        assert torch.equal(nk.tile_twiddles(tw.clone(), log_n), ctw)  # uncached: gathered


# -- the shared-memory layout ---------------------------------------------------

def _windows(log_chunk: int, log_tile: int) -> list[tuple[int, list[int]]]:
    """(window, stages) of each pass, as the kernel runs them."""
    lx = max(log_chunk, 3)
    out = []
    for first in range(1, log_tile + 1, 3):
        b = min(first - 1, lx - 3)
        out.append((b, list(range(first, min(first + 2, log_tile) + 1))))
    return out


@pytest.mark.parametrize("log_chunk", range(3, nk.LOG_TILE + 1))
def test_shared_layout_is_free_of_bank_conflicts(lib, log_chunk):
    threads = 1 << (log_chunk - 3)
    cols = [lib.mt_tile_col(k) for k in range(1 << log_chunk)]
    assert sorted(cols) == list(range(1 << log_chunk))  # a permutation of the tile
    tw_cols = [lib.mt_tw_col(j) for j in range((1 << log_chunk) // 2)]
    assert sorted(tw_cols) == list(range((1 << log_chunk) // 2))
    for b, stages in _windows(log_chunk, log_chunk):
        assert lib.mt_window(stages[0], max(log_chunk, 3)) == b
        for warp in range(0, threads, 32):
            lanes = range(warp, min(warp + 32, threads))
            for m in range(8):
                rows = [lib.mt_row_of(t, b, m) for t in lanes]
                banks = {cols[k] % 32 for k in rows}
                assert len(banks) == len(rows), (b, m)
            for s in stages:
                bit = s - b - 1
                for m in range(8):
                    if m >> bit & 1:
                        continue
                    pos = {(t & ((1 << b) - 1)) + ((m & ((1 << bit) - 1)) << b) for t in lanes}
                    js = {q << (log_chunk - s) for q in pos if q}
                    assert len({tw_cols[j] % 32 for j in js}) == len(js), (b, s, m)
    # every row of the chunk is held by exactly one thread under every window
    for b, _ in _windows(log_chunk, log_chunk):
        held = sorted(lib.mt_row_of(t, b, m) for t in range(threads) for m in range(8))
        assert held == list(range(1 << log_chunk))
