"""The fused GKR phase kernels (``zktpu_torch.gkr.kernels``) against zktpu's, on the CPU.

zktpu runs each sumcheck phase of a lazy GKR layer as one jitted ``_big_round``
for each round above its ``SCAN_SIZE``, then one ``_scan_phase_fixed`` for the
rest (``zktpu/gkr/fused_lazy.py``). The port runs them as two hand-written
kernels, ``gkr_big_round`` and ``gkr_phase_tail`` (``csrc/gkr_phase_kernels.cu``).
Held here, tolerance 0 (integer arithmetic and bits), on inputs made from numpy
seeds:

  * the kernels' own code, ``csrc/gkr_phase.cuh`` (the fused step of every
    thread, the blocks' partials, the finishing step, the last fold) with
    ``csrc/transcript.cuh``'s round, built for the host with g++: the blocks of
    a step run one after another (in reverse order), a grid sync is the
    boundary between two steps, and ``round_step``'s warp is 32 fibers of one
    host thread (``csrc/warp.cuh``). Against the plain versions on stacks of 2
    to 64 entries a table (and one of 2^11 on one block, whose threads take two
    indices each), a phase's first round and a steady one, with tables whose
    rounds trim to 0, 1, 2 and 3 coefficients, pending tails of one and two
    blocks;
  * ``gkr_big_round_plain`` against zktpu's jitted ``_big_round``, two rounds
    of a chain (a phase's first at 16 entries, then a steady one at 8);
  * a layer's fused sumcheck through the port with ``TAIL_MAX`` forced down,
    so that its phases run big rounds and then a tail, against zktpu's
    ``gkr_prove_lazy_fused`` with its ``SCAN_SIZE`` forced to 4.

The kernels themselves run only on the card: ``chip_smoke.py`` phase 19 holds
them there against the same plain versions.
"""

import ctypes
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as J_FR
from zktpu.gkr import circuit as jcircuit
from zktpu.gkr import fused_lazy as jfused_lazy
from zktpu.gkr import lazy as jlazy
from zktpu.poly.multilinear import MultilinearPoly as JaxPoly
from zktpu.transcript import Transcript as JaxTranscript

from zktpu_torch import convert
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.host import vec_to_bytes
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.gkr import fused_lazy
from zktpu_torch.gkr import kernels as gk
from zktpu_torch.gkr import lazy
from zktpu_torch.gkr.circuit import ADD, MUL, Layer
from zktpu_torch.hash import kernels as tk
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.transcript import Transcript

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(gk.__file__), "..", "csrc")
ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
P = BLS12_381_FR.modulus
W = gk.WORDS

HARNESS = r"""
#include <vector>

#include "gkr_phase.cuh"

namespace {

using namespace gkr_phase;

transcript::Consts make_consts(const uint32_t* p, uint32_t n0, const uint32_t* r2,
                               const uint32_t* inv2) {
  transcript::Consts c;
  for (int j = 0; j < W; ++j) {
    c.M.p[j] = p[j];
    c.r2[j] = r2[j];
    c.inv2[j] = inv2[j];
  }
  c.M.n0 = n0;
  return c;
}

// Block b's 3 C column sums of the fused step on a grid of nbr blocks: its
// threads' terms one after another
void block_sums(const Step& s, int b, int nbr, const uint32_t (&r)[W], const mont::Modulus<W>& M,
                uint64_t (&cols)[kRows][C]) {
  for (int row = 0; row < kRows; ++row)
    for (int j = 0; j < C; ++j) cols[row][j] = 0;
  for (int t = 0; t < kThreads; ++t) {
    uint32_t acc[kRows][C] = {};
    auto add_term = [&](int row, const uint32_t (&term)[W]) { mont::acc_add<W>(acc[row], term); };
    step_thread(add_term, s, b, nbr, t, r, M);
    for (int row = 0; row < kRows; ++row)
      for (int j = 0; j < C; ++j) cols[row][j] += acc[row][j];
  }
}

// Block b's 3 C column sums of a tail round on nbr blocks: every thread's
// fold, a barrier, then each live thread's terms (terms_live) one after
// another
void tail_block_sums(const Step& s, int b, int nbr, const uint32_t (&r)[W],
                     const mont::Modulus<W>& M, uint64_t (&cols)[kRows][C]) {
  const sums::Run run = tail_run(s, b, nbr);
  for (int t = 0; t < kThreads; ++t) fold_thread(s, run, t, r, M);
  for (int row = 0; row < kRows; ++row)
    for (int j = 0; j < C; ++j) cols[row][j] = 0;
  for (int t = 0; t < terms_live(run); ++t) {
    uint32_t acc[kRows][C] = {};
    auto add_term = [&](int row, const uint32_t (&term)[W]) { mont::acc_add<W>(acc[row], term); };
    terms_thread(add_term, s, run, t, M);
    for (int row = 0; row < kRows; ++row)
      for (int j = 0; j < C; ++j) cols[row][j] += acc[row][j];
  }
}

// One step on a grid of nbr blocks, the blocks in reverse order: each block's
// column sums into the partials
void grid_step(const Step& s, int nbr, const uint32_t (&r)[W], const mont::Modulus<W>& M,
               uint64_t* partials) {
  for (int b = nbr - 1; b >= 0; --b) {
    uint64_t cols[kRows][C];
    block_sums(s, b, nbr, r, M, cols);
    for (int row = 0; row < kRows; ++row)
      for (int j = 0; j < C; ++j) partials[sums::partial_at(row, j, b, C, nbr)] = cols[row][j];
  }
}

// The finishing step on one block: each column's group shares, the ripple, then
// round_step on a warp of fibers
void finish(const uint64_t* partials, int nbr, bool first, const uint64_t* state_in,
            const uint64_t* prefix, int prefix_lanes, const transcript::Consts& c,
            uint32_t* out_rows, uint64_t* state_out, uint32_t* challenge) {
  uint64_t cols[kRows * C];
  for (int k = 0; k < kRows * C; ++k) {
    uint64_t v = 0;
    for (int j = 0; j < kGroup; ++j) v += finish_share(partials, k, j, nbr);
    cols[k] = v;
  }
  uint32_t rows[kRows * C];
  for (int row = 0; row < kRows; ++row) finish_row(rows + row * C, cols + row * C);
  warp::run_lanes<32>([&](const warp::Group<32>& g) {
    if (first) {
      transcript::round_step<kRows, true>(g, rows, state_in, prefix, prefix_lanes, c, out_rows,
                                          state_out, challenge);
    } else {
      transcript::round_step<kRows, false>(g, rows, state_in, prefix, W / 2, c, out_rows,
                                           state_out, challenge);
    }
  });
}

void load_r(uint32_t (&r)[W], const uint32_t* src) {
  if (src) load_l2(r, src);
  else for (int j = 0; j < W; ++j) r[j] = 0;
}

}  // namespace

extern "C" {

// gkr_big_round_kernel's work: r null for a phase's first round
void gp_big_round(const uint32_t* tables, long long size, const uint32_t* r_in, uint32_t* out,
                  const uint64_t* state_in, const uint64_t* prefix, int prefix_lanes,
                  const uint32_t* p, uint32_t n0, const uint32_t* r2, const uint32_t* inv2,
                  uint32_t* out_rows, uint64_t* state_out, uint32_t* challenge, int nbr,
                  uint64_t* partials) {
  const transcript::Consts c = make_consts(p, n0, r2, inv2);
  const Step s{tables, size, out, size / 2, size, r_in != nullptr, false, false};
  uint32_t r[W];
  load_r(r, r_in);
  grid_step(s, nbr, r, c.M, partials);
  finish(partials, nbr, !s.fold, state_in, prefix, prefix_lanes, c, out_rows, state_out,
         challenge);
}

// gkr_phase_tail_kernel's work on at most nbr blocks: each grid round on its
// busy blocks (step_blocks), in reverse order, their partials finished; each
// block round on one block, the stack in a buffer that stands for its shared
// memory; the last fold from the table the last round summed
void gp_phase_tail(const uint32_t* tables, long long size, uint32_t* work, const uint32_t* r_in,
                   const uint64_t* state_in, const uint64_t* prefix, int prefix_lanes,
                   const uint32_t* p, uint32_t n0, const uint32_t* r2, const uint32_t* inv2,
                   uint32_t* out_rows, uint64_t* states, uint32_t* challenges, uint32_t* wb,
                   int nbr, long long block_max, uint64_t* partials, int* round_blocks) {
  const transcript::Consts c = make_consts(p, n0, r2, inv2);
  const bool pending = r_in != nullptr;
  const int rounds = tail_rounds(size, pending);
  std::vector<uint32_t> shared(4 * shared_stride(size, block_max) * W, 0xdeadbeefu);
  const Step first = tail_step(tables, size, work, shared.data(), pending, block_max, 0);
  const int grid = first.block ? 1 : step_blocks(first, nbr);
  Step s;
  for (int k = 0; k < rounds; ++k) {
    s = tail_step(tables, size, work, shared.data(), pending, block_max, k);
    uint32_t r[W];
    load_r(r, s.fold ? (k == 0 ? r_in : challenges + (k - 1) * W) : nullptr);
    const int busy = s.block ? 1 : step_blocks(s, grid);
    round_blocks[k] = s.block ? 0 : busy;
    for (int b = busy - 1; b >= 0; --b) {
      uint64_t cols[kRows][C];
      tail_block_sums(s, b, busy, r, c.M, cols);
      for (int row = 0; row < kRows; ++row)
        for (int j = 0; j < C; ++j) partials[sums::partial_at(row, j, b, C, busy)] = cols[row][j];
    }
    const uint64_t* digest = tail_digest(prefix, states, k);
    finish(partials, busy, !s.fold, state_in, s.fold ? digest : prefix, prefix_lanes, c,
           out_rows + k * kRows * W, states + k * keccak::kLanes, challenges + k * W);
  }
  uint32_t r[W];
  load_r(r, challenges + (rounds - 1) * W);
  last_fold(wb, last_table(s), last_shared(s), r, c.M);
}

int gp_tail_rounds(long long size, int pending) { return tail_rounds(size, pending); }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gkr_phase")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libgkr_phase_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    str(src), "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.gp_big_round.argtypes = [_P, _LL, _P, _P, _P, _P, _I, _P, _U, _P, _P, _P, _P, _P, _I, _P]
    lib.gp_phase_tail.argtypes = [_P, _LL, _P, _P, _P, _P, _I, _P, _U, _P, _P, _P, _P, _P, _P,
                                  _I, _LL, _P, _P]
    lib.gp_tail_rounds.argtypes = [_LL, _I]
    return lib


def _ptr(a):
    if a is None:
        return None
    return ctypes.c_void_p(a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr())


def _values(rng, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _stack(rng, size: int, trim: int) -> torch.Tensor:
    """A (2, 2, size, W) stack whose every round's polynomial trims to ``trim``
    coefficients: 0 all zero; 1 every table constant (y_t the same for every
    t); 2 the factor-1 tables constant (each term linear in t); 3 random."""
    tables = []
    for _p in range(2):
        for f in range(2):
            if trim == 0:
                vals = [0] * size
            elif trim == 1 or (trim == 2 and f == 1):
                vals = _values(rng, 1) * size
            else:
                vals = _values(rng, size)
            tables.append(ctx.pack(vals))
    return ctx.to_device(np.stack(tables).reshape(2, 2, size, W))


def _lanes(rng, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << 64, size=n, dtype=np.uint64).view(np.int64))


def _consts():
    p = np.array(ctx.p_words_host, dtype=np.uint32)
    r2, inv2 = (np.ascontiguousarray(a) for a in tk._host_words(ctx.spec)[1])
    return p, r2, inv2


def _host_big_round(lib, tables, r, state, tail, nbr):
    size = tables.shape[2]
    p, r2, inv2 = _consts()
    folded = torch.zeros((2, 2, max(size // 2, 1), W), dtype=torch.int32)
    out = torch.zeros((3, W), dtype=torch.int32)
    new_state = torch.zeros(25, dtype=torch.int64)
    challenge = torch.zeros(W, dtype=torch.int32)
    prefix, prefix_lanes = (state, 4) if tail is None else (tail, tail.shape[0])
    partials = np.zeros(3 * (W + 1) * nbr, np.uint64)
    lib.gp_big_round(_ptr(tables), size, _ptr(r), _ptr(folded), _ptr(state), _ptr(prefix),
                     prefix_lanes, _ptr(p), ctx.n0_prime32, _ptr(r2), _ptr(inv2), _ptr(out),
                     _ptr(new_state), _ptr(challenge), nbr, _ptr(partials))
    return (folded if r is not None else tables), out, new_state, challenge


def _host_tail(lib, tables, r, state, tail, nbr, block_max=gk.BLOCK_MAX, blocks=None):
    """The tail on the host harness; ``blocks``, where given, gets each
    round's busy blocks (0: a block round)."""
    size = tables.shape[2]
    rounds = lib.gp_tail_rounds(size, int(r is not None))
    assert rounds == gk.tail_rounds(size, r is not None)
    p, r2, inv2 = _consts()
    work = torch.zeros((2, 2, size // 2, W), dtype=torch.int32)
    out = torch.zeros((rounds, 3, W), dtype=torch.int32)
    states = torch.zeros((rounds, 25), dtype=torch.int64)
    challenges = torch.zeros((rounds, W), dtype=torch.int32)
    wb = torch.zeros(W, dtype=torch.int32)
    prefix, prefix_lanes = (state, 4) if tail is None else (tail, tail.shape[0])
    partials = np.zeros(3 * (W + 1) * nbr, np.uint64)
    busy = np.zeros(rounds, np.int32)
    lib.gp_phase_tail(_ptr(tables), size, _ptr(work), _ptr(r), _ptr(state), _ptr(prefix),
                      prefix_lanes, _ptr(p), ctx.n0_prime32, _ptr(r2), _ptr(inv2), _ptr(out),
                      _ptr(states), _ptr(challenges), _ptr(wb), nbr, block_max, _ptr(partials),
                      _ptr(busy))
    if blocks is not None:
        blocks.extend(int(n) for n in busy)
    return out, wb, states[-1]


def _tiers(size: int, fold: bool, block_max: int, nbr: int) -> list[int]:
    """The busy blocks of each round of a tail as the kernel plans them (0: a
    block round): a round summing at most ``block_max`` entries a table is a
    block round; a grid round gives each busy block a run of at least 32
    indices, on at most the first round's blocks, themselves at most
    ``nbr``."""
    run = 32
    summed, indices = [], []
    for k in range(gk.tail_rounds(size, fold)):
        folds = k + 1 if fold else k
        summed.append(size >> folds if folds else size)
        indices.append(summed[-1] // 2)
    if summed[0] <= block_max:
        return [0] * len(summed)
    grid = min(nbr, -(-indices[0] // run))
    return [0 if n <= block_max else min(grid, -(-i // run)) for n, i in zip(summed, indices)]


#: (entries a table, pending tail lanes or None for a steady round, blocks,
#: block_max): tails of 8 lanes keep 0-2 coefficients in one block and carry 3
#: into two, of 16 carry 1-3 and leave 0 in one. At ``gk.BLOCK_MAX`` (2^7)
#: these tails are block rounds only; at 2^2 a 64-entry tail runs grid rounds, then
#: block rounds (its first fold into the block's memory from the caller's
#: stack or from the work buffer); at 1, grid rounds only (the last fold from
#: the work buffer, or from the caller's stack in a tail of one round)
CUH_CASES = ((2, 16, 1, gk.BLOCK_MAX), (2, 8, 2, gk.BLOCK_MAX), (4, None, 1, gk.BLOCK_MAX),
             (4, 0, 3, gk.BLOCK_MAX), (8, None, 2, gk.BLOCK_MAX), (16, 8, 1, gk.BLOCK_MAX),
             (16, None, 3, gk.BLOCK_MAX), (64, 16, 2, gk.BLOCK_MAX), (64, None, 1, gk.BLOCK_MAX),
             (64, 8, 3, 4), (64, 16, 1, 4), (64, None, 2, 4), (64, None, 3, 4), (8, 16, 2, 4),
             (4, None, 1, 2), (2, 8, 2, 1), (8, 16, 3, 1), (16, None, 2, 1))


@pytest.mark.parametrize("trim", range(4))
def test_gkr_phase_cuh_equals_plain(lib, trim):
    """gkr_phase.cuh's big round and tail, built for the host, against the
    plain versions on the same stacks: every case's round polynomials trim to
    ``trim`` coefficients."""
    rng = np.random.default_rng(60 + trim)
    for size, tail_lanes, nbr, block_max in CUH_CASES:
        tables = _stack(rng, size, trim)
        state = _lanes(rng, 25)
        tail = None if tail_lanes is None else _lanes(rng, tail_lanes)
        r = None if tail is not None else ctx.to_device(ctx.pack(_values(rng, 1)))[0]
        what = f"size {size}, tail {tail_lanes}, trim {trim}, block_max {block_max}"
        if size >= (4 if r is not None else 2):
            got = _host_big_round(lib, tables, r, state, tail, nbr)
            want = gk.gkr_big_round_plain(ctx, tables, r, state, tail)
            for g, w in zip(got, want):
                assert torch.equal(g, w), what
            assert tk.trim_len(want[1]) == trim, what
        blocks = []
        got = _host_tail(lib, tables, r, state, tail, nbr, block_max, blocks)
        want = gk.gkr_phase_tail_plain(ctx, tables, r, state, tail)
        for g, w in zip(got, want):
            assert torch.equal(g, w), what
        assert {tk.trim_len(rows) for rows in want[0]} == {trim}, what
        assert blocks == _tiers(size, r is not None, block_max, nbr), what


def test_gkr_phase_cuh_grid_stride(lib):
    """One block of 256 threads on a stack of 2^11 entries: each thread folds
    and sums two indices, and a tail of ten rounds from it, all block rounds
    at the largest block_max, 2^10 (eight folds and six terms a thread in the
    first); then a phase's first round on it, a grid round of two blocks of
    512 indices each, and block rounds from 2^10 entries."""
    rng = np.random.default_rng(64)
    tables = _stack(rng, 1 << 11, 3)
    state = _lanes(rng, 25)
    r = ctx.to_device(ctx.pack(_values(rng, 1)))[0]
    for g, w in zip(_host_big_round(lib, tables, r, state, None, 1),
                    gk.gkr_big_round_plain(ctx, tables, r, state)):
        assert torch.equal(g, w)
    blocks = []
    for g, w in zip(_host_tail(lib, tables, r, state, None, 2, 1 << 10, blocks),
                    gk.gkr_phase_tail_plain(ctx, tables, r, state)):
        assert torch.equal(g, w)
    assert blocks == [0] * 10
    tail, blocks = _lanes(rng, 8), []
    for g, w in zip(_host_tail(lib, tables, None, state, tail, 2, 1 << 10, blocks),
                    gk.gkr_phase_tail_plain(ctx, tables, None, state, tail)):
        assert torch.equal(g, w)
    assert blocks == [2] + [0] * 10


#: (entries a table, pending tail lanes or None, blocks, block_max, the busy
#: blocks of each round): grid rounds of several blocks, which shrink, then
#: block rounds that fold first from the work buffer or the caller's stack
TIER_CASES = ((1 << 12, None, 3, 1 << 10, [3] + [0] * 10),
              (1 << 11, None, 40, 1 << 6, [16, 8, 4, 2] + [0] * 6),
              (1 << 11, 16, 4, 1 << 9, [4, 4] + [0] * 9),
              (1 << 10, 8, 3, 1, [3, 3, 3, 2] + [1] * 6))


@pytest.mark.parametrize("case", range(len(TIER_CASES)))
def test_gkr_phase_cuh_tiers(lib, case):
    """Tails whose grid rounds run on several blocks, the blocks that later
    rounds leave idle returning, then block rounds (or none at block_max 1),
    against the plain version."""
    size, tail_lanes, nbr, block_max, want_blocks = TIER_CASES[case]
    rng = np.random.default_rng(70 + case)
    tables = _stack(rng, size, 3)
    state = _lanes(rng, 25)
    tail = None if tail_lanes is None else _lanes(rng, tail_lanes)
    r = None if tail is not None else ctx.to_device(ctx.pack(_values(rng, 1)))[0]
    blocks = []
    got = _host_tail(lib, tables, r, state, tail, nbr, block_max, blocks)
    for g, w in zip(got, gk.gkr_phase_tail_plain(ctx, tables, r, state, tail)):
        assert torch.equal(g, w)
    assert blocks == want_blocks == _tiers(size, r is not None, block_max, nbr)


def test_wrappers_on_the_cpu_are_the_plain_versions():
    """A CPU tensor takes the plain version, writes the caller's slots and
    counts no launch; arguments the kernels do not take raise."""
    rng = np.random.default_rng(65)
    tables = _stack(rng, 8, 3)
    state, tail = _lanes(rng, 25), _lanes(rng, 4)
    gk.reset_launches()
    out = torch.zeros((3, W), dtype=torch.int32)
    got = gk.gkr_big_round(ctx, tables, None, state, tail, out)
    want = gk.gkr_big_round_plain(ctx, tables, None, state, tail)
    assert all(torch.equal(g, w) for g, w in zip(got, want)) and got[1] is out
    rows = torch.zeros((3, 3, W), dtype=torch.int32)
    got = gk.gkr_phase_tail(ctx, tables, None, state, tail, rows)
    assert got[0] is rows and torch.equal(rows, gk.gkr_phase_tail_plain(ctx, tables, None,
                                                                         state, tail)[0])
    assert gk.launches == {name: 0 for name in gk.KERNEL_NAMES}
    r = ctx.to_device(ctx.pack([3]))[0]
    with pytest.raises(ValueError):  # a first round takes no challenge
        gk.gkr_big_round(ctx, tables, r, state, tail)
    with pytest.raises(ValueError):  # a steady round takes no tail
        gk.gkr_phase_tail(ctx, tables, None, state)
    with pytest.raises(ValueError):  # a fold needs four entries
        gk.gkr_big_round(ctx, tables[:, :, :2].contiguous(), r, state)
    with pytest.raises(ValueError):
        gk.gkr_phase_tail(ctx, tables, None, state, tail, torch.zeros((2, 3, W), dtype=torch.int32))
    with pytest.raises(ValueError):
        gk.gkr_big_round(ctx, tables[:, :, :6].contiguous(), None, state, tail)


# -- against zktpu ---------------------------------------------------------------

jctx = jfb.get_ctx(J_FR)
#: the layer of ``test_layer_through_both_kernels_equals_zktpu``: 8 gates on 16
#: inputs, four rounds a phase. zktpu compiles ``_big_round`` once for each
#: (entries, pending tail bytes) and each compile takes seconds on the CPU, so
#: the big-round test runs the same shapes and reuses them: a first round of 16
#: entries after a tail of 32 bytes (the layer's phase 1) or none (phase 2),
#: then a steady round of 8.
LAYER_INPUTS = 16


@pytest.mark.parametrize("tail_lanes", [4, 0])
def test_gkr_big_round_plain_equals_zktpu(tail_lanes):
    """Two rounds of a chain: a phase's first round (no fold, the host's tail
    absorbed) and a steady one, which folds at the first's challenge. zktpu's
    ``_big_round`` sums, absorbs and then folds; the port's folds, then sums
    and absorbs: the first's coefficients and state, the second's, and the
    folded stack agree."""
    rng = np.random.default_rng(66 + tail_lanes)
    tables = _stack(rng, LAYER_INPUTS, 3)
    state, tail = _lanes(rng, 25), _lanes(rng, tail_lanes)
    jtables = jnp.asarray(convert.table_to_zktpu(tables))
    jstate = jnp.asarray(convert.sponge_state_to_zktpu(state))
    jtail = jnp.asarray(convert.sponge_state_to_zktpu(tail).reshape(-1, 2))
    jdigest = jnp.zeros((4, 2), jnp.uint32)
    jfolded, jst, jdigest, jcoeffs = jfused_lazy._big_round(jctx, jtables, 8 * tail_lanes,
                                                            jstate, jtail, jdigest)
    same_tables, coeffs, st, r = gk.gkr_big_round_plain(ctx, tables, None, state, tail)
    assert same_tables is tables
    assert np.array_equal(convert.table_to_zktpu(coeffs), np.asarray(jcoeffs))
    assert torch.equal(st, convert.sponge_state_from_zktpu(np.asarray(jst)))

    jfolded2, jst2, _, jcoeffs2 = jfused_lazy._big_round(jctx, jfolded, -1, jst,
                                                         jnp.zeros((0, 2), jnp.uint32), jdigest)
    folded, coeffs2, st2, _ = gk.gkr_big_round_plain(ctx, tables, r, st)
    assert np.array_equal(convert.table_to_zktpu(folded), np.asarray(jfolded))
    assert np.array_equal(convert.table_to_zktpu(coeffs2), np.asarray(jcoeffs2))
    assert torch.equal(st2, convert.sponge_state_from_zktpu(np.asarray(jst2)))


def test_layer_through_both_kernels_equals_zktpu(monkeypatch):
    """A layer of 8 gates on 16 inputs (four rounds a phase) through the fused
    prover with TAIL_MAX = 4: each phase runs two big rounds (16 and 8
    entries) and a tail of two rounds (4, 2), the first phase's first round
    absorbs the host's tail; against zktpu's fused prover with SCAN_SIZE = 4
    (two big rounds and its scan), from the same transcript state."""
    monkeypatch.setattr(fused_lazy, "TAIL_MAX", 4)
    monkeypatch.setattr(jfused_lazy, "SCAN_SIZE", 4)
    rng = np.random.default_rng(67)
    ops = [ADD if rng.integers(2) else MUL for _ in range(LAYER_INPUTS // 2)]
    w_vals = _values(rng, LAYER_INPUTS)
    r_b, r_c, (alpha, beta) = _values(rng, 3), _values(rng, 3), _values(rng, 2)
    fbc = lazy.lazy_folded_fbc(ctx, Layer(ops), MultilinearPoly.from_ints(ctx, w_vals), r_b, r_c,
                               alpha, beta)
    jfbc = jlazy.lazy_folded_fbc(jctx, jcircuit.Layer(ops), JaxPoly.from_ints(jctx, w_vals), r_b,
                                 r_c, alpha, beta)
    seed = vec_to_bytes(BLS12_381_FR, _values(rng, 1))
    t, jt = Transcript(BLS12_381_FR), JaxTranscript(J_FR)
    t.append(seed)
    jt.append(seed)
    calls = []
    real_big, real_tail = gk.gkr_big_round, gk.gkr_phase_tail
    monkeypatch.setattr(gk, "gkr_big_round",
                        lambda c, tb, *a: calls.append(("big", tb.shape[2])) or real_big(c, tb, *a))
    monkeypatch.setattr(gk, "gkr_phase_tail",
                        lambda c, tb, *a: calls.append(("tail", tb.shape[2])) or real_tail(c, tb, *a))
    proof = fused_lazy.gkr_prove_lazy_fused(5, fbc, t)
    jproof = jfused_lazy.gkr_prove_lazy_fused(5, jfbc, jt)
    phase = [("big", 16), ("big", 16), ("tail", 8)]
    assert calls == phase + phase
    assert [p.coefficients for p in proof.proof_polynomials] == \
        [p.coefficients for p in jproof.proof_polynomials]
    assert proof.random_challenges == jproof.random_challenges
    assert t.get_random_challenge() == jt.get_random_challenge()
