"""The GKR layer-table kernels (``zktpu_torch.gkr.tables``) on the CPU.

A lazy GKR layer builds its wiring coefficients and its two phase stacks with
three hand-written kernels (``csrc/gkr_tables_kernels.cu``); their plain
versions are the port's eager chains. Held here, tolerance 0 (integer
arithmetic), on inputs made from numpy seeds:

  * the kernels' own code, ``csrc/gkr_tables.cuh`` (the eq halves: each
    block's seed chain over the hi bits, its doubling levels in a buffer that
    stands for the block's shared memory, the last level into the outputs; a
    gate's phase-stack rows), built for the host with g++: blocks in reverse
    order, the threads of each level in reverse order, at the kernels' 256
    threads a block and at 3. Against the plain versions at layers of 1 to
    2^12 gates, gates all ADD, all MUL and mixed, challenges at 0, 1 and
    p - 1 among random ones, alpha or beta at 0;
  * the plain versions, through ``lazy_fbc`` / ``lazy_folded_fbc`` and the
    stacks, against zktpu's ``gkr/lazy.py`` at 1, 2, 2^5 and 2^12 gates;
  * the wrappers' dispatch on CPU tensors and the arguments they refuse.

The kernels themselves run only on the card: ``chip_smoke.py`` phase 20 holds
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
from zktpu.gkr import lazy as jlazy
from zktpu.poly.multilinear import MultilinearPoly as JaxPoly

from zktpu_torch import convert
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.gkr import lazy
from zktpu_torch.gkr import tables as gt
from zktpu_torch.gkr.circuit import ADD, MUL, Layer
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.utils import roofline

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(gt.__file__), "..", "csrc")
ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
jctx = jfb.get_ctx(J_FR)
P = BLS12_381_FR.modulus
W = gt.WORDS
THREADS = 256
MAX_LOG_GATES = 12

HARNESS = r"""
#include <vector>

#include "gkr_tables.cuh"

namespace {

using namespace gkr_tables;

Consts make_consts(const uint32_t* p, uint32_t n0, const uint32_t* one) {
  Consts c;
  for (int j = 0; j < W; ++j) {
    c.M.p[j] = p[j];
    c.one[j] = one[j];
  }
  c.M.n0 = n0;
  return c;
}

// a block's shared table, poisoned: a read before a write shows
std::vector<carry::uint4> shared_table() {
  return std::vector<carry::uint4>(kMaxTerms * kSharedEntries * W / 4,
                            carry::uint4{0xdeadbeefu, 0xdeadbeefu, 0xdeadbeefu, 0xdeadbeefu});
}

// a block's seed threads, then each doubling level, its threads in reverse
// order (a barrier between levels)
void doubling(uint32_t* table, const Eq& q, const uint32_t* scales, long long b, int nthreads,
              const Consts& c) {
  for (int t = q.terms - 1; t >= 0; --t) seed_thread(table, q, scales, b, t, c);
  for (int l = 0; l < q.m - 1; ++l)
    for (int t = nthreads - 1; t >= 0; --t) level_thread(table, q, l, t, nthreads, c);
}

}  // namespace

extern "C" {

int gt_lo_bits(int k) { return lo_bits(k); }

// gkr_wiring_kernel's work, blocks in reverse order
void gt_wiring(const uint32_t* rs, const uint32_t* scales, int terms, int k,
               const uint8_t* is_add, long long n, uint32_t* coef_a, uint32_t* coef_m,
               const uint32_t* p, uint32_t n0, const uint32_t* one, int nthreads) {
  const Consts c = make_consts(p, n0, one);
  Wiring a;
  a.q = make_eq(rs, k, terms);
  a.scales = scales;
  a.is_add = is_add;
  a.n = n;
  a.coef_a = coef_a;
  a.coef_m = coef_m;
  for (long long b = wiring_blocks(n, k) - 1; b >= 0; --b) {
    std::vector<carry::uint4> shared = shared_table();
    uint32_t* table = reinterpret_cast<uint32_t*>(shared.data());
    doubling(table, a.q, scales, b, nthreads, c);
    for (int t = nthreads - 1; t >= 0; --t) wiring_last_thread(table, a, b, t, nthreads, c);
  }
}

// gkr_phase1_stack_kernel's work, gates in reverse order
void gt_phase1(const uint32_t* coef_a, const uint32_t* coef_m, const uint32_t* w, long long n,
               uint32_t* stack, const uint32_t* p, uint32_t n0, const uint32_t* one) {
  const Consts c = make_consts(p, n0, one);
  for (long long g = n - 1; g >= 0; --g) phase1_gate(stack, coef_a, coef_m, w, n, g, c);
}

// gkr_phase2_stack_kernel's work, blocks in reverse order; k = log2(2n)
void gt_phase2(const uint32_t* rs, int k, const uint32_t* coef_a, const uint32_t* coef_m,
               const uint32_t* w, const uint32_t* wb, long long n, uint32_t* stack,
               const uint32_t* p, uint32_t n0, const uint32_t* one, int nthreads) {
  const Consts c = make_consts(p, n0, one);
  Phase2 a;
  a.q = make_eq(rs, k, 1);
  a.coef_a = coef_a;
  a.coef_m = coef_m;
  a.w = w;
  a.wb = wb;
  a.n = n;
  a.stack = stack;
  for (long long b = phase2_blocks(n, k) - 1; b >= 0; --b) {
    std::vector<carry::uint4> shared = shared_table();
    uint32_t* table = reinterpret_cast<uint32_t*>(shared.data());
    doubling(table, a.q, nullptr, b, nthreads, c);
    for (int t = nthreads - 1; t >= 0; --t) phase2_last_thread(table, a, b, t, nthreads, c);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gkr_tables")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libgkr_tables_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    str(src), "-o", str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    _P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.gt_lo_bits.argtypes = [_I]
    lib.gt_wiring.argtypes = [_P, _P, _I, _I, _P, _LL, _P, _P, _P, _U, _P, _I]
    lib.gt_phase1.argtypes = [_P, _P, _P, _LL, _P, _P, _U, _P]
    lib.gt_phase2.argtypes = [_P, _I, _P, _P, _P, _P, _LL, _P, _P, _U, _P, _I]
    return lib


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _field():
    """(p, n0, one) as the harness takes them."""
    return ctx.p_words_c, ctx.n0_prime32, gt._one_words(ctx.spec)


def _values(rng, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def _challenges(rng, n: int, edges: bool) -> list[int]:
    """n random values, with 0, 1 and p - 1 in place of some when ``edges``."""
    vals = _values(rng, n)
    if edges:
        for i, v in enumerate((0, 1, P - 1)):
            vals[(3 * i + 1) % n] = v
    return vals


def _mont(values):
    return fk.to_mont(ctx, ctx.to_device(ctx.pack(values)))


def _gate_types(rng, n: int, kind: str) -> list[str]:
    if kind == "mixed":
        return [ADD if b else MUL for b in rng.integers(2, size=n)]
    return [ADD if kind == "add" else MUL] * n


def _same_words(a, b) -> bool:
    return torch.equal(a.contiguous(), b.contiguous())


def _harness_wiring(lib, challenges, scales, is_add, n, nthreads):
    terms, k = challenges.shape[:2]
    coef_a = torch.empty((n, W), dtype=torch.int32)
    coef_m = torch.empty((n, W), dtype=torch.int32)
    mask = is_add.to(torch.uint8)
    lib.gt_wiring(_ptr(challenges), _ptr(scales), terms, k, _ptr(mask), n, _ptr(coef_a),
                  _ptr(coef_m), *_field(), nthreads)
    return coef_a, coef_m


def _harness_phase1(lib, coef_a, coef_m, w):
    n = coef_a.shape[0]
    stack = torch.empty((2, 2, 2 * n, W), dtype=torch.int32)
    lib.gt_phase1(_ptr(coef_a), _ptr(coef_m), _ptr(w), n, _ptr(stack), *_field())
    return stack


def _harness_phase2(lib, challenges, coef_a, coef_m, w, wb, nthreads):
    n = coef_a.shape[0]
    stack = torch.empty((2, 2, 2 * n, W), dtype=torch.int32)
    lib.gt_phase2(_ptr(challenges), challenges.shape[0], _ptr(coef_a), _ptr(coef_m), _ptr(w),
                  _ptr(wb), n, _ptr(stack), *_field(), nthreads)
    return stack


# ----------------------------------------------------------------------
# the kernels' code, built for the host, against the plain versions
# ----------------------------------------------------------------------

def test_gkr_tables_cuh_split_points(lib):
    """The lo bits of a block: ceil(k / 2), at most 10; so each half of an eq
    table has at most 2^10 entries, and k = 1 takes the same split as k = 2."""
    assert [lib.gt_lo_bits(k) for k in range(1, 25)] == [min((k + 1) // 2, 10)
                                                          for k in range(1, 25)]


@pytest.mark.parametrize("log_n", range(MAX_LOG_GATES + 1))
@pytest.mark.parametrize("kind", ["add", "mul", "mixed"])
def test_gkr_tables_cuh_wiring(lib, log_n, kind):
    """gkr_wiring's work against ``wiring_coefs_plain``: two scaled terms (a
    folded layer), edge challenges on some sizes, alpha or beta at 0 on
    others; and at 1 and 2 gates one unscaled term (the output layer)."""
    rng = np.random.default_rng(100 + 3 * log_n + ("add", "mul", "mixed").index(kind))
    n = 1 << log_n
    k = max(1, log_n)
    is_add = Layer(_gate_types(rng, n, kind)).add_mask("cpu")
    challenges = _mont(_challenges(rng, 2 * k, edges=log_n % 2 == 1)).reshape(2, k, W)
    alpha, beta = _values(rng, 2)
    scales = _mont([alpha, 0 if log_n % 3 == 0 else beta] if log_n % 2 else
                   [0 if log_n % 4 == 0 else alpha, beta])
    want = gt.wiring_coefs_plain(ctx, challenges, scales, is_add, n)
    for nthreads in (THREADS, 3):
        got = _harness_wiring(lib, challenges, scales, is_add, n, nthreads)
        assert _same_words(got[0], want[0]) and _same_words(got[1], want[1])
    if n <= 2:
        one_term = challenges[:1, :1]
        want = gt.wiring_coefs_plain(ctx, one_term, None, is_add, n)
        got = _harness_wiring(lib, one_term, None, is_add, n, THREADS)
        assert _same_words(got[0], want[0]) and _same_words(got[1], want[1])


@pytest.mark.parametrize("log_n", range(MAX_LOG_GATES + 1))
def test_gkr_tables_cuh_phase_stacks(lib, log_n):
    """gkr_phase1_stack's and gkr_phase2_stack's work against their plain
    versions, on the coefficients of a mixed layer (so every gate has a zero
    coefficient), then on coefficients that are both nonzero."""
    rng = np.random.default_rng(200 + log_n)
    n = 1 << log_n
    k = max(1, log_n)
    is_add = Layer(_gate_types(rng, n, "mixed")).add_mask("cpu")
    challenges = _mont(_values(rng, 2 * k)).reshape(2, k, W)
    coef_a, coef_m = gt.wiring_coefs_plain(ctx, challenges, _mont(_values(rng, 2)), is_add, n)
    w = _mont(_values(rng, 2 * n))
    r_b = _mont(_challenges(rng, log_n + 1, edges=log_n >= 3))
    wb = _mont(_values(rng, 1))[0]
    for ca, cm in ((coef_a, coef_m), (_mont(_values(rng, n)), _mont(_values(rng, n)))):
        assert _same_words(_harness_phase1(lib, ca, cm, w), gt.phase1_stack_plain(ctx, ca, cm, w))
        want = gt.phase2_stack_plain(ctx, ca, cm, w, r_b, wb)
        for nthreads in (THREADS, 3):
            assert _same_words(_harness_phase2(lib, r_b, ca, cm, w, wb, nthreads), want)


# ----------------------------------------------------------------------
# the plain versions against zktpu
# ----------------------------------------------------------------------

def _jtable(t):
    return jnp.asarray(convert.table_to_zktpu(t))


def _same(port_tensor, jax_array) -> bool:
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


@pytest.mark.parametrize("n, kind, variant", [
    (1, "add", "output"), (2, "mixed", "output"), (1, "mixed", "folded"), (2, "mixed", "edges"),
    (32, "mixed", "alpha0"), (4096, "mul", "beta0"),
])
def test_wiring_coefficients_equal_zktpu(n, kind, variant):
    """``lazy_fbc`` (the output layer) and ``lazy_folded_fbc`` against
    zktpu's, whose coefficients are the eager chain the plain version keeps:
    challenges at 0, 1 and p - 1 ("edges"), alpha or beta at 0."""
    rng = np.random.default_rng(300 + n)
    ops = _gate_types(rng, n, kind)
    w_vals = _values(rng, 2 * n)
    w, jw = MultilinearPoly.from_ints(ctx, w_vals), JaxPoly.from_ints(jctx, w_vals)
    if variant == "output":
        r = _values(rng, 1)[0]
        fbc = lazy.lazy_fbc(ctx, r, Layer(ops), w)
        jfbc = jlazy.lazy_fbc(jctx, r, jcircuit.Layer(ops), jw)
    else:
        k = max(1, n.bit_length() - 1)
        r_b = [0, P - 1][:k] if variant == "edges" else _values(rng, k)
        r_c = [1, P - 1][:k] if variant == "edges" else _values(rng, k)
        alpha, beta = _values(rng, 2)
        alpha = 0 if variant == "alpha0" else alpha
        beta = 0 if variant == "beta0" else beta
        fbc = lazy.lazy_folded_fbc(ctx, Layer(ops), w, r_b, r_c, alpha, beta)
        jfbc = jlazy.lazy_folded_fbc(jctx, jcircuit.Layer(ops), jw, r_b, r_c, alpha, beta)
    assert _same(fbc.coef_a, jfbc.coef_a) and _same(fbc.coef_m, jfbc.coef_m)


@pytest.mark.parametrize("log_n", [0, 3, MAX_LOG_GATES])
def test_phase_stacks_equal_zktpu(log_n):
    """The phase-1 stack's G, H and the phase-2 stack, from phase 1's
    challenges, against zktpu's ``_phase1_tables_kernel`` and
    ``_phase2_tables_kernel`` on ``eq_tensor``."""
    rng = np.random.default_rng(400 + log_n)
    n = 1 << log_n
    coef_a, coef_m, w = (_mont(_values(rng, m)) for m in (n, n, 2 * n))
    r_vals = _challenges(rng, log_n + 1, edges=log_n >= 3)
    wb = _mont(_values(rng, 1))[0]
    jcoef_a, jcoef_m, jw, jwb = (_jtable(t) for t in (coef_a, coef_m, w, wb[None]))
    stack1 = gt.phase1_stack(ctx, coef_a, coef_m, w)
    assert _same(stack1[0, 1], jlazy._phase1_tables_kernel(jctx, jcoef_a, jcoef_m, jw)[0])
    assert _same(stack1[1, 0], jlazy._phase1_tables_kernel(jctx, jcoef_a, jcoef_m, jw)[1])
    assert torch.equal(stack1[0, 0], w) and torch.equal(stack1[1, 1],
                                                        ctx.one_mont.expand(w.shape))
    jeqb = jlazy.eq_tensor(jctx, list(_jtable(_mont(r_vals))))
    stack2 = gt.phase2_stack(ctx, coef_a, coef_m, w, _mont(r_vals), wb)
    assert _same(stack2, jlazy._phase2_tables_kernel(jctx, jcoef_a, jcoef_m, jw, jeqb, jwb[0]))


# ----------------------------------------------------------------------
# the wrappers
# ----------------------------------------------------------------------

def test_tables_wrappers_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(500)
    n, k = 16, 4
    is_add = Layer(_gate_types(rng, n, "mixed")).add_mask("cpu")
    challenges = _mont(_values(rng, 2 * k)).reshape(2, k, W)
    scales = _mont(_values(rng, 2))
    before = dict(gt.launches)
    coef_a, coef_m = gt.wiring_coefs(ctx, challenges, scales, is_add, n)
    want = gt.wiring_coefs_plain(ctx, challenges, scales, is_add, n)
    assert _same_words(coef_a, want[0]) and _same_words(coef_m, want[1])
    w, r_b, wb = _mont(_values(rng, 2 * n)), _mont(_values(rng, k + 1)), _mont(_values(rng, 1))[0]
    assert _same_words(gt.phase1_stack(ctx, coef_a, coef_m, w),
                       gt.phase1_stack_plain(ctx, coef_a, coef_m, w))
    assert _same_words(gt.phase2_stack(ctx, coef_a, coef_m, w, r_b, wb),
                       gt.phase2_stack_plain(ctx, coef_a, coef_m, w, r_b, wb))
    assert gt.launches == before  # nothing was launched

    with pytest.raises(ValueError):  # 17 gates do not fit 4 bits
        gt.wiring_coefs(ctx, challenges, scales, torch.ones(17, dtype=torch.bool), 17)
    with pytest.raises(ValueError):  # a mask that is not bool
        gt.wiring_coefs(ctx, challenges, scales, is_add.to(torch.uint8), n)
    with pytest.raises(ValueError):  # three terms
        gt.wiring_coefs(ctx, _mont(_values(rng, 3 * k)).reshape(3, k, W), None, is_add, n)
    with pytest.raises(ValueError):  # a scale short
        gt.wiring_coefs(ctx, challenges, scales[:1], is_add, n)
    with pytest.raises(ValueError):  # phase 1's challenges are log2(2n) = 5
        gt.phase2_stack(ctx, coef_a, coef_m, w, r_b[:k], wb)
    with pytest.raises(ValueError):  # w is 2n rows
        gt.phase1_stack(ctx, coef_a, coef_m, w[:n])
    with pytest.raises(ValueError):  # 12 gates: not a power of two
        gt.phase2_stack(ctx, coef_a[:12], coef_m[:12], w[:24], r_b[:4], wb)


def test_gkr_tables_costs():
    """Each launch's least work (``roofline.GKR_TABLES_COSTS``): the bytes of
    the tables it reads and writes, and its products."""
    elem, mul = 4 * W, roofline.cios_lane_ops(W)
    n = 1 << 19
    assert roofline.gkr_wiring_cost(n, 2) == (n + 2 * n * elem, 2 * n * mul)
    assert roofline.gkr_phase1_stack_cost(n) == (12 * n * elem, 2 * n * mul)
    assert roofline.gkr_phase2_stack_cost(n) == (12 * n * elem, 4 * n * mul)
    assert roofline.gkr_phase1_stack_cost(n)[0] == 192 * 2**20  # 128 MB written, 64 MB read
    assert set(roofline.GKR_TABLES_COSTS) == set(gt.KERNEL_NAMES)


def test_layer_walk_reads_the_circuit_masks(monkeypatch):
    """Once the circuit is built, the walk's tables read each layer's kept
    device mask (``Layer.add_mask``): neither the prover nor the verifier
    passes over ``Layer.ops`` again."""
    from zktpu_torch.gkr import protocol as gkr
    from zktpu_torch.gkr.circuit import Circuit

    circuit = Circuit(ctx, [[ADD, MUL, MUL, ADD], [MUL, ADD], [ADD]])

    def refuse(self):
        raise AssertionError("Layer.is_add was called after the circuit was built")

    monkeypatch.setattr(Layer, "is_add", refuse)
    proved = gkr.prove_layers(circuit, [5, 2, 2, 4, 10, 0, 3, 3])
    assert gkr.verify_layers(proved.proof, circuit, proved.input_evals).verified
    assert all(layer.add_mask("cpu") is mask for layer, mask in zip(circuit.layers,
                                                                     circuit._masks))
