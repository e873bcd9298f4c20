"""The device transcript (``zktpu_torch.hash.kernels``) against zktpu's, on the CPU.

The fused provers' transcript runs on the card in two hand-written kernels,
``keccak_f`` and ``round_step`` (``csrc/transcript_kernels.cu``). Held here,
tolerance 0 (integer arithmetic and bits), on inputs made from numpy seeds:

  * ``keccak_f_plain`` against zktpu's ``hash.keccak_device.keccak_f`` on random
    states and the zero state, through zktpu's (25, 2) uint32 layout;
  * ``round_step_plain`` against zktpu's chain of the same round:
    ``_canonicalize_rows`` -> (``_interp3``) -> the absorb (``_squeeze_round``,
    ``_absorb_tail_block``) -> ``_digest_to_mont``, for the plain sumcheck's
    two rows and GKR's three, every trimmed length 0..3, steady rounds and
    first rounds whose pending tail does and does not carry the content into a
    second block, lazy rows whose low words are at or above p, for BN254 Fq and
    BLS12-381 Fr. zktpu's ``_squeeze_trim`` and ``_absorb_tail_trim`` are a
    ``lax.switch`` over exactly those absorbs of ``c[:k]``, k from
    ``_trim_len``; the test takes the branch ``_trim_len`` picks (a switch
    called outside ``jit`` compiles its four branches at every call);
  * the digest's Montgomery form on digests at and above p;
  * the kernels' own code -- ``csrc/keccak.cuh``'s two permutations (one
    thread's, and the 25-lane one on a warp) and ``round_step``'s body in
    ``csrc/transcript.cuh``, on ``csrc/mont.cuh`` -- built for the host with
    g++ (the carry-chain primitives of ``csrc/carry.cuh`` have a host
    emulation, and a warp is 32 fibers of one host thread that meet at a
    barrier for each shuffle, ``csrc/warp.cuh``), against the plain versions on
    the same cases and more.

The kernels themselves run only on the card: ``chip_smoke.py`` phase 17 holds
them there against the same plain versions.
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as J_FR
from zktpu.field.spec import BN254_FQ as J_FQ
from zktpu.gkr import fused_lazy as jfl
from zktpu.hash import keccak_device as jkd
from zktpu.sumcheck import fused as jf

from zktpu_torch import convert
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ
from zktpu_torch.hash import kernels as tk

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(tk.__file__), "..", "csrc")
FIELDS = {"bn254_fq": (BN254_FQ, J_FQ), "bls12_381_fr": (BLS12_381_FR, J_FR)}
W = tk.WORDS

#: (rows, pending tail lanes or None for a steady round, trimmed length for
#: GKR's three rows). A sumcheck tail of 8 lanes keeps round 0 in one block, 9
#: carry it into two; a GKR tail of 8 lanes (64 bytes) keeps 0-2 coefficients
#: in one block and 3 in two; of 16 lanes, 0 in one and 1 in two.
ZKTPU_CASES = (
    [(2, None, 2), (2, 8, 2), (2, 9, 2)]
    + [(3, None, m) for m in range(4)]
    + [(3, 8, m) for m in range(4)]
    + [(3, 16, 0), (3, 16, 1)]
)

HARNESS = r"""
#include "transcript.cuh"

namespace {

// the kernels' warp: 32 fibers that hand over to one another at each shuffle
template <class Body>
void on_warp(const Body& body) {
  warp::run_lanes<32>(body);
}

template <int K, bool First>
void round_kind(const uint32_t* rows, const uint64_t* state_in, const uint64_t* prefix,
                int prefix_lanes, const transcript::Consts& c, uint32_t* out_rows,
                uint64_t* state_out, uint32_t* challenge) {
  on_warp([&](const warp::Group<32>& g) {
    transcript::round_step<K, First>(g, rows, state_in, prefix, prefix_lanes, c, out_rows,
                                     state_out, challenge);
  });
}

}  // namespace

extern "C" {
void tk_permute(uint64_t* states, long n) {
  for (long i = 0; i < n; ++i) keccak::permute(*(uint64_t(*)[keccak::kLanes])(states + 25 * i));
}

// keccak.cuh's permutation on 25 lanes of a warp, a state at a time
void tk_permute_lanes(uint64_t* states, long n) {
  on_warp([&](const warp::Group<32>& g) {
    const keccak::LaneRoles roles = keccak::lane_roles(g.lane);
    for (long i = 0; i < n; ++i) {
      uint64_t a = g.lane < 25 ? states[25 * i + g.lane] : 0;
      keccak::permute_lanes(g, roles, a);
      if (g.lane < 25) states[25 * i + g.lane] = a;
    }
  });
}

// round_step's body on a warp of fibers
void tk_round_step(const uint32_t* rows, int k, const uint64_t* state_in, int fresh,
                   const uint64_t* prefix, int prefix_lanes, const uint32_t* p, uint32_t n0,
                   const uint32_t* r2, const uint32_t* inv2, uint32_t* out_rows,
                   uint64_t* state_out, uint32_t* challenge) {
  transcript::Consts c;
  for (int j = 0; j < transcript::W; ++j) {
    c.M.p[j] = p[j];
    c.r2[j] = r2[j];
    c.inv2[j] = inv2[j];
  }
  c.M.n0 = n0;
  auto run = k == 2 ? (fresh ? round_kind<2, false> : round_kind<2, true>)
                    : (fresh ? round_kind<3, false> : round_kind<3, true>);
  run(rows, state_in, prefix, prefix_lanes, c, out_rows, state_out, challenge);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transcript")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libtranscript_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    str(src), "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.tk_permute.argtypes = [_P, ctypes.c_long]
    lib.tk_permute_lanes.argtypes = [_P, ctypes.c_long]
    lib.tk_round_step.argtypes = [_P, _I, _P, _I, _P, _I, _P, ctypes.c_uint32, _P, _P, _P, _P, _P]
    return lib


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _words(value: int, n: int = W) -> np.ndarray:
    return np.array([(value >> (32 * j)) & 0xFFFFFFFF for j in range(n)], dtype=np.uint32)


def _random_lanes(rng, n: int) -> np.ndarray:
    return rng.integers(0, 1 << 64, size=n, dtype=np.uint64).view(np.int64)


def _lazy_rows(spec, rng, values) -> np.ndarray:
    """(k, W + 1) lazy words whose canonical values are ``values``: S = v R mod
    p + j p. Row 0 takes j = 1 (low words at or above p, no high word), the
    others a random j below 2^32 (a high word, low words anywhere)."""
    p, r = spec.modulus, spec.R
    rows = []
    for i, v in enumerate(values):
        j = 1 if i == 0 else int(rng.integers(1, 1 << 32))
        s = v * r % p + j * p
        assert i or s % (1 << (32 * W)) >= p
        rows.append(_words(s, W + 1))
    return np.stack(rows)


def _round_inputs(spec, rng, k: int, tail, m: int):
    """Lazy rows, state and pending tail of one round. For k = 3 the rows are
    the values at t = 0, 1, 2 of a polynomial whose trimmed length is m."""
    p = spec.modulus
    if k == 2:
        values = [int(v) % p for v in rng.integers(0, 1 << 62, size=2)]
    else:
        coeffs = [int(rng.integers(1, 1 << 62)) if i < m else 0 for i in range(3)]
        values = [(coeffs[0] + coeffs[1] * t + coeffs[2] * t * t) % p for t in range(3)]
    rows = _lazy_rows(spec, rng, values)
    state = _random_lanes(rng, 25)
    return rows, state, None if tail is None else _random_lanes(rng, tail)


def _plain(ctx, rows, state, tail):
    t = None if tail is None else torch.from_numpy(tail)
    return tk.round_step_plain(ctx, torch.from_numpy(rows.view(np.int32)),
                               torch.from_numpy(state), t)


def _host_round(lib, spec, rows, state, tail):
    ctx = fb.get_ctx(spec, device="cpu")
    k = rows.shape[0]
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    prefix = state[:4].copy() if tail is None else tail
    r2, inv2 = (np.ascontiguousarray(a) for a in tk._host_words(spec)[1])
    p = np.array(ctx.p_words_host, dtype=np.uint32)
    out_rows = np.zeros((k, W), np.uint32)
    state_out = np.zeros(25, np.int64)
    challenge = np.zeros(W, np.uint32)
    lib.tk_round_step(_ptr(rows), k, _ptr(state), int(tail is None), _ptr(prefix),
                      prefix.shape[0], _ptr(p), spec.n0_prime32, _ptr(r2), _ptr(inv2),
                      _ptr(out_rows), _ptr(state_out), _ptr(challenge))
    return out_rows, state_out, challenge


#: zktpu's arithmetic steps of a round, compiled once per field and shape and
#: reused across cases (called eagerly, each would compile its many small
#: operations on first use); the absorbs stay eager, as compiling the unrolled
#: permutation once per content length costs more than it saves
_J_CANON = jax.jit(jf._canonicalize_rows, static_argnums=0)
_J_INTERP3 = jax.jit(jfl._interp3, static_argnums=0)
_J_TRIM_LEN = jax.jit(jfl._trim_len)
_J_DIGEST = jax.jit(jf._digest_to_mont, static_argnums=0)


def _zktpu_round(jspec, rows, state, tail):
    """zktpu's chain of one round on the same inputs: (canonical rows, state
    lanes, challenge digits)."""
    jctx = jfb.get_ctx(jspec)
    k = rows.shape[0]
    canon = _J_CANON(jctx, jnp.asarray(convert.lazy_rows_to_zktpu(rows)))
    m = k
    if k == 3:
        canon = _J_INTERP3(jctx, canon)
        m = int(_J_TRIM_LEN(canon))
    pairs = jnp.asarray(convert.sponge_state_to_zktpu(state))
    if tail is None:
        st = jf._squeeze_round(jctx, pairs[:4], canon[:m])
    else:
        jtail = jnp.asarray(convert.sponge_state_to_zktpu(tail).reshape(-1, 2))
        st = jf._absorb_tail_block(jctx, pairs, jtail, 8 * tail.shape[0], canon[:m])
    return np.asarray(canon), np.asarray(st), np.asarray(_J_DIGEST(jctx, st[:4]))


# -- Keccak-f ------------------------------------------------------------------

def test_keccak_f_plain_equals_zktpus():
    rng = np.random.default_rng(50)
    states = np.concatenate([np.zeros((1, 25), np.int64),
                             _random_lanes(rng, 3 * 25).reshape(3, 25)])
    got = tk.keccak_f_plain(torch.from_numpy(states))
    for state, out in zip(states, got):
        want = jkd.keccak_f(jnp.asarray(convert.sponge_state_to_zktpu(state)))
        assert torch.equal(out, convert.sponge_state_from_zktpu(np.asarray(want)))
    # a batch is its states one by one, and the wrapper on a CPU tensor is the plain version
    assert torch.equal(got[2], tk.keccak_f_plain(torch.from_numpy(states[2])))
    assert torch.equal(tk.keccak_f(torch.from_numpy(states)), got)


def test_keccak_cuh_equals_plain(lib):
    rng = np.random.default_rng(51)
    states = np.concatenate([np.zeros((1, 25), np.int64), np.full((1, 25), -1, np.int64),
                             _random_lanes(rng, 62 * 25).reshape(62, 25)])
    want = tk.keccak_f_plain(torch.from_numpy(states)).numpy()
    got = states.copy()
    lib.tk_permute(_ptr(got), got.shape[0])
    assert np.array_equal(got, want)
    # the known answer: Keccak-f of the zero state, lane 0
    assert got[0, 0] == np.uint64(0xF1258F7940E1DDE7).view(np.int64)


# -- round_step ----------------------------------------------------------------

@pytest.mark.parametrize("field", list(FIELDS))
def test_round_step_plain_equals_zktpus_chain(field):
    spec, jspec = FIELDS[field]
    ctx = fb.get_ctx(spec, device="cpu")
    rng = np.random.default_rng(52)
    for k, tail, m in ZKTPU_CASES:
        rows, state, tail_lanes = _round_inputs(spec, rng, k, tail, m)
        canon, st, challenge = _plain(ctx, rows, state, tail_lanes)
        jcanon, jst, jchallenge = _zktpu_round(jspec, rows, state, tail_lanes)
        what = f"{field}, k = {k}, tail {tail}, m = {m}"
        assert np.array_equal(convert.table_to_zktpu(canon), jcanon), what
        assert torch.equal(st, convert.sponge_state_from_zktpu(jst)), what
        assert np.array_equal(convert.table_to_zktpu(challenge), jchallenge), what
        if k == 3:
            assert tk.trim_len(canon) == m, what
            assert not canon[m:].any(), what


@pytest.mark.parametrize("field", list(FIELDS))
def test_digest_to_mont_at_and_above_p(field):
    """The challenge is the digest's 256 bits times R^2, reduced: at p, p + 1,
    2^256 - 1 and random digests above p, zktpu's ``_digest_to_mont`` and the
    plain product give the same words, and so does ``mont::mul(r2, digest)``
    (the kernel's operand order) through the host build's round."""
    spec, jspec = FIELDS[field]
    ctx = fb.get_ctx(spec, device="cpu")
    p = spec.modulus
    rng = np.random.default_rng(53)
    top = (1 << 256) - 1
    digests = [p, p + 1, top, top - 1] + [
        p + int.from_bytes(rng.bytes(32), "little") % (top - p) for _ in range(4)]
    for d in digests:
        lanes = torch.from_numpy(_words(d).view(np.int64))
        got = fb.mont_mul(ctx, tk.lanes_to_limbs(lanes), ctx.r2)
        want = _J_DIGEST(jfb.get_ctx(jspec), jnp.asarray(convert.sponge_state_to_zktpu(lanes)))
        assert np.array_equal(convert.table_to_zktpu(got), np.asarray(want))
        assert spec.from_words(fb.tensor_to_words(got)) == d % p * spec.R % p


@pytest.mark.parametrize("field", list(FIELDS))
def test_round_step_body_equals_plain(lib, field):
    """transcript.cuh's round_step, built for the host and run on a warp of
    32 fibers, against the plain version: zktpu's cases, then every tail
    length 0..16 (first rounds of one and two blocks) for both row counts and
    every trimmed length, digests at and above p."""
    spec = FIELDS[field][0]
    ctx = fb.get_ctx(spec, device="cpu")
    rng = np.random.default_rng(54)
    cases = list(ZKTPU_CASES) + [(k, tail, m) for k in (2, 3) for tail in range(17)
                                 for m in ((2,) if k == 2 else range(4))]
    blocks, above_p = set(), 0
    for k, tail, m in cases:
        rows, state, tail_lanes = _round_inputs(spec, rng, k, tail, m)
        canon, st, challenge = _plain(ctx, rows, state, tail_lanes)
        h_rows, h_state, h_challenge = _host_round(lib, spec, rows, state, tail_lanes)
        what = f"{field}, k = {k}, tail {tail}, m = {m}"
        assert np.array_equal(h_rows, fb.tensor_to_words(canon)), what
        assert np.array_equal(h_state, st.numpy()), what
        assert np.array_equal(h_challenge, fb.tensor_to_words(challenge)), what
        if tail is not None:
            blocks.add((tail + 4 * m) // tk.RATE_LANES + 1)
        digest = h_state[:4].view(np.uint64)
        above_p += sum(int(d) << (64 * i) for i, d in enumerate(digest)) >= spec.modulus
    assert blocks == {1, 2} and 0 < above_p < len(cases)


def test_keccak_lanes_equal_plain(lib):
    """keccak.cuh's permutation on 25 lanes of a warp (32 fibers, a barrier
    for each shuffle) against the plain version."""
    rng = np.random.default_rng(55)
    states = np.concatenate([np.zeros((1, 25), np.int64), np.full((1, 25), -1, np.int64),
                             _random_lanes(rng, 4 * 25).reshape(4, 25)])
    want = tk.keccak_f_plain(torch.from_numpy(states)).numpy()
    got = states.copy()
    lib.tk_permute_lanes(_ptr(got), got.shape[0])
    assert np.array_equal(got, want)


def test_absorb_pad_when_the_content_ends_a_block_early():
    """16 lanes of content (a 128-byte tail and no coefficient, or digest ||
    three coefficients) leave one lane: 0x01 and 0x80 share it."""
    pad = tk.absorb_pad(16)
    assert pad.shape == (17,) and pad[16] == 1 - (1 << 63) and np.count_nonzero(pad) == 1


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ctx = fb.get_ctx(BN254_FQ, device="cpu")
    rows = torch.zeros((2, W + 1), dtype=torch.int32)
    state = torch.zeros(25, dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.round_step(fb.get_ctx(BLS12_381_FQ, device="cpu"), torch.zeros((2, 13), dtype=torch.int32),
                      state)
    with pytest.raises(ValueError):
        tk.round_step(ctx, torch.zeros((4, W + 1), dtype=torch.int32), state)
    with pytest.raises(ValueError):
        tk.round_step(ctx, rows, state, tail=torch.zeros(17, dtype=torch.int64))
    with pytest.raises(ValueError):
        tk.round_step(ctx, rows, state, out=torch.zeros((3, W), dtype=torch.int32))
    with pytest.raises(TypeError):
        tk.round_step(ctx, rows, state.to(torch.int32))
    with pytest.raises(ValueError):
        tk.keccak_f(torch.zeros(24, dtype=torch.int64))
    # a CPU tensor takes the plain version, and ``out`` receives the rows
    out = torch.full((2, W), 7, dtype=torch.int32)
    canon, st, challenge = tk.round_step(ctx, rows, state, out=out)
    assert canon is out and not out.any()
    want = tk.round_step_plain(ctx, rows, state)
    assert torch.equal(st, want[1]) and torch.equal(challenge, want[2])
    assert tk.launches == {"keccak_f": 0, "round_step": 0}
