"""zktpu_torch's GKR sumcheck (dense, lazy, fused-lazy) vs zktpu's, piece by piece.

The same tables, made from a numpy seed, go through the JAX function and its
counterpart in the port, which runs on the CPU (``device="cpu"``, the kernels'
plain versions). Tolerance 0: integer arithmetic, every comparison is exact
equality: round polynomials coefficient for coefficient, challenges one by one,
tables word for word through ``zktpu_torch.convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.gkr import circuit as jcircuit
from zktpu.gkr import fused_lazy as jfused_lazy
from zktpu.gkr import lazy as jlazy
from zktpu.poly import composed as jcomposed
from zktpu.poly.multilinear import MultilinearPoly as JaxPoly
from zktpu.sumcheck import protocol as jsc
from zktpu.transcript import Transcript as JaxTranscript
from zktpu.utils import tracker as jtracker

from zktpu_torch import convert
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.host import vec_to_bytes
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.gkr import fused_lazy, lazy
from zktpu_torch.gkr import tables as gt
from zktpu_torch.gkr.circuit import ADD, MUL, Layer
from zktpu_torch.hash import keccak_device as kd
from zktpu_torch.hash import kernels as tk
from zktpu_torch.hash.keccak import Sponge
from zktpu_torch.parallel import mesh as pm
from zktpu_torch.poly.composed import ProductPoly, SumPoly
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import protocol as sc
from zktpu_torch.transcript import Transcript
from zktpu_torch.utils import tracker

torch.set_num_threads(1)

FR = BLS12_381_FR
P = FR.modulus
ctx = fb.get_ctx(FR, device="cpu")
jctx = jfb.get_ctx(JAX_FR)


def _same(port_tensor, jax_array):
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


def _values(rng, n):
    return [int(a) * int(b) % P for a, b in rng.integers(0, 2**62, size=(n, 2))]


def _mont(values):
    """The same Montgomery table in both packages."""
    jt = jfb.to_mont(jctx, jnp.asarray(jctx.pack(values)))
    return convert.table_from_zktpu(np.asarray(jt)), jt


def _coeffs(polys):
    return [p.coefficients for p in polys]


# ----------------------------------------------------------------------
# the dense composed-polynomial sumcheck
# ----------------------------------------------------------------------

def _sum_polys(rng, num_vars, n_products=2, n_factors=2):
    evals = [[_values(rng, 1 << num_vars) for _ in range(n_factors)] for _ in range(n_products)]
    port = SumPoly(ctx, [ProductPoly.from_ints(ctx, e) for e in evals])
    ref = jcomposed.SumPoly(jctx, [jcomposed.ProductPoly.from_ints(jctx, e) for e in evals])
    claimed = sum(
        int(np.prod([f[i] for f in prod], dtype=object)) for prod in evals for i in range(1 << num_vars)
    ) % P
    return port, ref, claimed


@pytest.mark.parametrize("shape", [(3, 2, 2), (5, 2, 2), (2, 3, 2)],
                         ids=lambda s: f"vars{s[0]}-P{s[1]}-F{s[2]}")
def test_gkr_prove_and_verify_equal_zktpu(shape):
    """(2, 2) takes the gkr_round wrapper at every size; other shapes the general
    plain round function."""
    num_vars, n_products, n_factors = shape
    port, ref, claimed = _sum_polys(np.random.default_rng(sum(shape)), *shape)
    seed = vec_to_bytes(FR, [claimed])
    t, jt = Transcript(FR), JaxTranscript(JAX_FR)
    t.append(seed)
    jt.append(seed)
    proof = sc.gkr_prove(claimed, port, t)
    jproof = jsc.gkr_prove(claimed, ref, jt)
    assert _coeffs(proof.proof_polynomials) == _coeffs(jproof.proof_polynomials)
    assert proof.random_challenges == jproof.random_challenges
    assert proof.claimed_sum == jproof.claimed_sum == claimed
    assert t.get_random_challenge() == jt.get_random_challenge()
    assert convert.gkr_sumcheck_proof_from_zktpu(FR, jproof) == proof

    def verify(polys, claim=claimed):
        vt = Transcript(FR)
        vt.append(seed)
        return sc.gkr_verify(polys, claim, vt, FR)

    jvt = JaxTranscript(JAX_FR)
    jvt.append(seed)
    want = jsc.gkr_verify(jproof.proof_polynomials, claimed, jvt, JAX_FR)
    got = verify(proof.proof_polynomials)
    assert got.verified and want.verified
    assert got.final_claimed_sum == want.final_claimed_sum
    assert got.random_challenges == want.random_challenges == proof.random_challenges
    # the final claim is the polynomial at the challenges
    enc = port.products[0].factors[0].encode_scalar
    assert port.evaluate_int(got.random_challenges, enc) == got.final_claimed_sum
    # a tampered coefficient and a wrong claim are refused
    bad = convert.round_polys_from_zktpu(FR, proof.proof_polynomials)
    bad[-1].coefficients[0] = (bad[-1].coefficients[0] + 1) % P
    assert not verify(bad).verified
    assert not verify(proof.proof_polynomials, (claimed + 1) % P).verified


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 3, 3), (3, 2, 4)],
                         ids=lambda s: f"P{s[0]}-F{s[1]}-deg{s[2]}")
def test_general_round_kernel_equals_zktpu(shape):
    n_products, n_factors, degree = shape
    rng = np.random.default_rng(40 + sum(shape))
    tables, jtables = _mont(_values(rng, n_products * n_factors * 8))
    tables = tables.reshape(n_products, n_factors, 8, 8)
    jtables = jtables.reshape(n_products, n_factors, 8, 16)
    got = sc.gkr_round_kernel(ctx, tables, degree)
    assert _same(got, jsc.gkr_round_kernel(jctx, jtables, degree))
    if shape == (2, 2, 2):
        assert fk.lazy_rows_to_ints(ctx, fk.gkr_round(ctx, tables)) == sc._to_ints(ctx, got)


def test_gkr_prove_tracker_counts_equal_zktpu():
    port, ref, claimed = _sum_polys(np.random.default_rng(9), 4)
    tracker.reset()
    jtracker.reset()
    with tracker.tracking(), jtracker.tracking():
        sc.gkr_prove(claimed, port, Transcript(FR))
        jsc.gkr_prove(claimed, ref, JaxTranscript(JAX_FR))
    # the host packing routes (field.pack_fast / field.pack_exact) have no count in zktpu
    ops = {k: v for k, v in tracker.summary().items() if not k.startswith("field.pack_")}
    assert ops == jtracker.summary() and ops
    tracker.reset()
    jtracker.reset()


# ----------------------------------------------------------------------
# the lazy phase tables
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_case():
    """An 8-gate layer over a 16-entry w table, with folded coefficients."""
    rng = np.random.default_rng(21)
    ops = [ADD, MUL, MUL, ADD, ADD, ADD, MUL, MUL]
    w_vals = _values(rng, 16)
    r_b, r_c = _values(rng, 3), _values(rng, 3)
    alpha, beta = _values(rng, 2)
    w, jw = MultilinearPoly.from_ints(ctx, w_vals), JaxPoly.from_ints(jctx, w_vals)
    fbc = lazy.lazy_folded_fbc(ctx, Layer(ops), w, r_b, r_c, alpha, beta)
    jfbc = jlazy.lazy_folded_fbc(jctx, jcircuit.Layer(ops), jw, r_b, r_c, alpha, beta)
    return ops, fbc, jfbc, rng


def test_eq_tensor_equals_zktpu():
    rng = np.random.default_rng(20)
    for k in (0, 1, 4):
        rs, jrs = _mont(_values(rng, k)) if k else (torch.zeros((0, 8), dtype=torch.int32), [])
        got = lazy.eq_tensor(ctx, rs)
        assert tuple(got.shape) == (1 << k, 8)
        assert _same(got, jlazy.eq_tensor(jctx, list(jrs)))
        assert _same(lazy.eq_tensor(ctx, list(rs)), jlazy.eq_tensor(jctx, list(jrs)))
    # eq(r, x) at a boolean r is the indicator of x = r, MSB first
    bits = fk.to_mont(ctx, ctx.to_device(ctx.pack([1, 0, 1])))
    assert MultilinearPoly(ctx, lazy.eq_tensor(ctx, bits)).to_ints() == [0, 0, 0, 0, 0, 1, 0, 0]


def test_lazy_coefficients_and_phase_tables_equal_zktpu(layer_case):
    ops, fbc, jfbc, _ = layer_case
    assert _same(fbc.coef_a, jfbc.coef_a) and _same(fbc.coef_m, jfbc.coef_m)
    assert fbc.num_rounds == jfbc.num_rounds == 8 and fbc.get_degree() == 2
    add_mask, mul_mask = gt.gate_masks_plain(ctx, Layer(ops).add_mask(ctx.device))
    jadd, jmul = jlazy._gate_masks(jctx, jcircuit.Layer(ops))
    assert _same(add_mask, jadd) and _same(mul_mask, jmul)
    gh = gt.phase1_tables_plain(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table)
    jgh = jlazy._phase1_tables_kernel(jctx, jfbc.coef_a, jfbc.coef_m, jfbc.w_table)
    assert _same(gh, jgh)
    assert not gh[:, 1::2].any()  # the odd entries of G and H are zero
    eqb, jeqb = _mont(list(range(1, 17)))
    wb, jwb = fbc.w_table[3], jfbc.w_table[3]
    t2 = gt.phase2_tables_plain(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table, eqb, wb)
    jt2 = jlazy._phase2_tables_kernel(jctx, jfbc.coef_a, jfbc.coef_m, jfbc.w_table, jeqb, jwb)
    assert t2.is_contiguous() and tuple(t2.shape) == (2, 2, 16, 8)
    assert _same(t2, jt2)


def test_layer0_lazy_fbc_equals_zktpu():
    rng = np.random.default_rng(22)
    for ops in ([ADD], [MUL, ADD]):
        w_vals = _values(rng, 2 * len(ops))
        r = _values(rng, 1)[0]
        fbc = lazy.lazy_fbc(ctx, r, Layer(ops), MultilinearPoly.from_ints(ctx, w_vals))
        jfbc = jlazy.lazy_fbc(jctx, r, jcircuit.Layer(ops), JaxPoly.from_ints(jctx, w_vals))
        assert _same(fbc.coef_a, jfbc.coef_a) and _same(fbc.coef_m, jfbc.coef_m)
    with pytest.raises(ValueError):
        lazy.lazy_fbc(ctx, 1, Layer([ADD] * 4), MultilinearPoly.from_ints(ctx, list(range(8))))
    with pytest.raises(ValueError):
        lazy.lazy_fbc(ctx, 1, Layer([ADD] * 3), MultilinearPoly.from_ints(ctx, list(range(8))))


@pytest.mark.parametrize("prover", ["sharded", "fused"])
def test_lazy_provers_equal_zktpu(layer_case, prover):
    """One layer's sumcheck through the sharded lazy prover on two CPU slots
    (a fetch and a host squeeze a round) against zktpu's host-loop lazy prover,
    and through the fused one against zktpu's fused one, from the same
    transcript state."""
    ops, fbc, jfbc, rng = layer_case
    seed = vec_to_bytes(FR, _values(np.random.default_rng(23), 1))
    t, jt = Transcript(FR), JaxTranscript(JAX_FR)
    t.append(seed)
    jt.append(seed)
    if prover == "fused":
        proof = fused_lazy.gkr_prove_lazy_fused(5, fbc, t)
        jproof = jfused_lazy.gkr_prove_lazy_fused(5, jfbc, jt)
    else:
        proof = pm.gkr_sumcheck_lazy_sharded(5, fbc, t, pm.make_mesh(devices=["cpu"] * 2))
        jproof = jlazy.gkr_prove_lazy(5, jfbc, jt)
    assert _coeffs(proof.proof_polynomials) == _coeffs(jproof.proof_polynomials)
    assert proof.random_challenges == jproof.random_challenges
    assert len(proof.proof_polynomials) == 8
    assert t.get_random_challenge() == jt.get_random_challenge()


def test_verifier_claims_lazy_equal_dense_and_zktpu(layer_case):
    from zktpu_torch.gkr import protocol as gkr

    ops, fbc, jfbc, _ = layer_case
    rng = np.random.default_rng(24)
    layer, jlayer = Layer(ops), jcircuit.Layer(ops)
    cur, prev = _values(rng, 8), _values(rng, 6)
    o_1, o_2, alpha, beta = _values(rng, 4)
    got = lazy.folded_verifier_claim_lazy(ctx, layer, cur, prev, o_1, o_2, alpha, beta)
    assert got == jlazy.folded_verifier_claim_lazy(jctx, jlayer, cur, prev, o_1, o_2, alpha, beta)
    assert got == gkr.get_folded_verifier_claim(ctx, layer, cur, prev, o_1, o_2, alpha, beta)
    top, jtop = Layer([MUL, ADD]), jcircuit.Layer([MUL, ADD])
    r0, chal = prev[0], cur[:4]
    got0 = lazy.verifier_claim_lazy(ctx, top, r0, chal, o_1, o_2)
    assert got0 == jlazy.verifier_claim_lazy(jctx, jtop, r0, chal, o_1, o_2)
    assert got0 == gkr.get_verifier_claim(ctx, top, r0, chal, o_1, o_2)


# ----------------------------------------------------------------------
# the fused prover's device pieces
# ----------------------------------------------------------------------

def _consts(tail: bytes):
    sponge = Sponge()
    sponge.absorb(b"\x5a" * 136 + tail)  # one full block absorbed, `tail` pending
    pairs, pending = sponge.state_lanes()
    assert pending == tail
    consts = fused_lazy._PhaseConsts(ctx, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(pending))
    return sponge, consts


def _coeff_rows(rng, k):
    """(3, W + 1) lazy rows (the Montgomery words of y_0, y_1, y_2, no high
    word) of a polynomial whose trimmed length is k, and its k coefficients."""
    values = [v or 1 for v in _values(rng, k)]
    coeffs = values + [0] * (3 - k)
    ys = [(coeffs[0] + coeffs[1] * t + coeffs[2] * t * t) % P for t in range(3)]
    words = ctx.pack([y * FR.R % P for y in ys])
    rows = np.concatenate([words, np.zeros((3, 1), np.uint32)], axis=1)
    return ctx.to_device(rows), values


def _challenge_int(challenge) -> int:
    """A Montgomery challenge as the plain value."""
    return int(ctx.unpack(challenge)) * pow(FR.R, -1, P) % P


def test_interp3_equals_host_interpolation():
    """round_step's interpolation and trim, in their plain form."""
    rng = np.random.default_rng(30)
    cases = [_values(rng, 3), [7, 10, 13], [4, 4, 4], [0, 0, 0], [P - 1, 0, 1]]
    for ys in cases:
        rows, jrows = ctx.to_device(ctx.pack(ys)), jnp.asarray(jctx.pack(ys))
        got = tk.interp3_plain(ctx, rows)
        assert _same(got, jfused_lazy._interp3(jctx, jrows))
        want = sc.UnivariatePoly.interpolate(FR, list(enumerate(ys))).coefficients
        ints = [int(v) for v in ctx.unpack(got)]
        assert ints[: len(want)] == want and not any(ints[len(want):])
        assert tk.trim_len(got) == len(want)


@pytest.mark.parametrize("tail_elems", [1, 2, 3, 4])
def test_first_absorb_of_a_phase_equals_the_host_sponge(tail_elems):
    """Pending tail || trimmed coefficients, for every trimmed length: the state
    after the first round_step of a phase gives the host sponge's digest, and
    its challenge the digest mod p. With 64 pending bytes three coefficients
    cross into a second block and fewer do not; with 128 even one does."""
    rng = np.random.default_rng(31 + tail_elems)
    tail = vec_to_bytes(FR, _values(rng, tail_elems))
    sponge, consts = _consts(tail)
    blocks = [tk.absorb_pad(len(tail) // 8 + 4 * k).shape[0] // kd.RATE_LANES for k in range(4)]
    assert (min(blocks), max(blocks)) == {1: (1, 1), 2: (1, 2), 3: (1, 2), 4: (1, 2)}[tail_elems]
    for k in range(4):
        rows, values = _coeff_rows(rng, k)
        coeffs, state, challenge = tk.round_step(ctx, rows, consts.state, consts.tail)
        assert [int(v) for v in ctx.unpack(coeffs)][:k] == values
        host = sponge.copy()
        host.absorb(vec_to_bytes(FR, values))
        assert kd.digest_to_bytes(state[:4]) == host.digest()
        assert _challenge_int(challenge) == int.from_bytes(host.digest(), "little") % P


def test_steady_round_absorb_equals_the_host_sponge():
    rng = np.random.default_rng(36)
    digest = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
    state = torch.from_numpy(np.concatenate([kd.bytes_to_lanes(digest),
                                             rng.integers(0, 1 << 62, size=21)]))
    for k in range(4):
        rows, values = _coeff_rows(rng, k)
        _, new_state, challenge = tk.round_step(ctx, rows, state)
        host = Sponge()
        host.absorb(digest + vec_to_bytes(FR, values))
        assert kd.digest_to_bytes(new_state[:4]) == host.digest()
        assert _challenge_int(challenge) == int.from_bytes(host.digest(), "little") % P


def test_plain_sumcheck_pads_are_unchanged():
    """The padding round_step lays out gives the plain sumcheck (two elements a
    round) the layout it had: a steady round's digest || two elements in one
    block, a first absorb of a 96-byte tail and two elements over two; a round
    of more than three elements is refused."""
    pad = tk.absorb_pad(4 + 8)
    assert pad.shape == (17,) and pad[12] == 1 and pad[16] == -(1 << 63)
    assert np.count_nonzero(pad) == 2
    tail_pad = tk.absorb_pad(12 + 8)
    assert tail_pad.shape == (34,) and tail_pad[20] == 1 and tail_pad[33] == -(1 << 63)
    one = tk.absorb_pad(8 + 4)
    assert one.shape == (17,) and one[12] == 1 and one[16] == -(1 << 63)
    with pytest.raises(ValueError):
        tk.round_step(ctx, torch.zeros((4, ctx.num_words + 1), dtype=torch.int32),
                      torch.zeros(25, dtype=torch.int64))
