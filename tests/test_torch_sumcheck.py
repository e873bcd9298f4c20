"""The first slice of zktpu_torch as a whole vs zktpu: the plain sumcheck.

For each configuration the same values, made from a seed, go into a
``MultilinearPoly`` of each package; the port runs on the CPU (``device="cpu"``,
kernels' plain versions). Proofs are compared integer for integer, tables word
for word through ``zktpu_torch.convert``. Tolerance 0: integer arithmetic,
every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field import spec as jspec
from zktpu.poly.multilinear import MultilinearPoly as JaxPoly
from zktpu.sumcheck import fused as jfused
from zktpu.sumcheck import protocol as jsc

from zktpu_torch import convert
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import fused, protocol
from zktpu_torch.utils import tracker

torch.set_num_threads(1)

CONFIGS = [(BN254_FQ, 4), (BN254_FQ, 7), (BLS12_381_FR, 9)]


class Case:
    """Both packages' polynomial over the same values, and both fused proofs."""

    def __init__(self, spec, nv):
        jax_spec = next(s for s in jspec.ALL_SPECS if s.name == spec.name)
        self.spec, self.nv = spec, nv
        self.ctx = fb.get_ctx(spec, device="cpu")
        self.jctx = jfb.get_ctx(jax_spec)
        rng = np.random.default_rng(nv)
        self.vals = [
            int(a) * int(b) % spec.modulus for a, b in rng.integers(0, 2**62, size=(1 << nv, 2))
        ]
        self.poly = MultilinearPoly.from_ints(self.ctx, self.vals)
        self.jpoly = JaxPoly.from_ints(self.jctx, self.vals)
        self.proof = fused.prove(self.poly)
        self.jproof = jfused.prove(self.jpoly)


_cases = {}


@pytest.fixture(params=CONFIGS, ids=lambda c: f"{c[0].name}-{c[1]}")
def case(request):
    key = request.param
    if key not in _cases:
        _cases[key] = Case(*key)
    return _cases[key]


def _same(port_tensor, jax_array):
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


def test_tables_and_transcript_bytes_equal(case):
    assert _same(case.poly.table, case.jpoly.table)
    assert case.poly.to_transcript_bytes() == case.jpoly.to_transcript_bytes()
    assert case.poly.to_ints() == case.vals
    assert case.poly.transcript_sponge().digest() == case.jpoly.transcript_sponge().digest()


def test_fused_and_host_loop_proofs_equal_zktpu(case):
    for got in (case.proof, protocol.prove(case.poly)):
        assert got.claimed_sum == case.jproof.claimed_sum == sum(case.vals) % case.spec.modulus
        assert got.proof_polynomials == case.jproof.proof_polynomials
    assert convert.proof_from_zktpu(case.jproof) == case.proof
    assert len(case.proof.proof_polynomials) == case.nv


def test_verify_accepts_and_refuses_tampered(case):
    assert protocol.verify(case.poly, case.proof)
    p = case.spec.modulus
    for rnd, idx in ((0, 0), (case.nv - 1, 1)):
        bad = protocol.Proof([list(rp) for rp in case.proof.proof_polynomials], case.proof.claimed_sum)
        bad.proof_polynomials[rnd][idx] = (bad.proof_polynomials[rnd][idx] + 1) % p
        assert not protocol.verify(case.poly, bad)
    wrong_sum = protocol.Proof(case.proof.proof_polynomials, (case.proof.claimed_sum + 1) % p)
    assert not protocol.verify(case.poly, wrong_sum)


def test_each_package_verifies_the_others_proof(case):
    assert protocol.verify(case.poly, convert.proof_from_zktpu(case.jproof))
    assert jsc.verify(case.jpoly, convert.proof_to_zktpu(case.proof, jsc.Proof))


def test_evaluate_int_agrees_at_a_random_point(case):
    rng = np.random.default_rng(100 + case.nv)
    p = case.spec.modulus
    point = [int(a) * int(b) % p for a, b in rng.integers(0, 2**62, size=(case.nv, 2))]
    assert case.poly.evaluate_int(point) == case.jpoly.evaluate_int(point)
    # a boolean point reads the table: variable 0 is the most significant bit
    index = 5 % (1 << case.nv)
    bits = [(index >> (case.nv - 1 - k)) & 1 for k in range(case.nv)]
    assert case.poly.evaluate_int(bits) == case.vals[index]


def test_round_internals_equal_zktpu(case):
    """The pieces of one fused round, each against its zktpu counterpart."""
    from zktpu.field import pallas_kernels as pk
    from zktpu_torch.field import kernels as fk

    jrows = jfused._lazy_halves_jnp(case.jctx, case.jpoly.table)
    rows = fk.halves_sums(case.ctx, case.poly.table)
    assert torch.equal(rows, convert.lazy_rows_from_zktpu(np.asarray(jrows)))
    canon = fused._canonicalize_rows(case.ctx, rows)
    assert _same(canon, jfused._canonicalize_rows(case.jctx, jrows))
    assert [int(v) for v in case.ctx.unpack(canon)] == pk.lazy_rows_to_ints(case.jctx, jrows)
    assert [int(v) for v in case.ctx.unpack(canon)] == case.proof.proof_polynomials[0]
    digest = np.arange(8, dtype=np.uint32).reshape(4, 2) * np.uint32(0x9E3779B1)
    r = fused._digest_to_mont(case.ctx, convert.sponge_state_from_zktpu(digest))
    assert _same(r, jfused._digest_to_mont(case.jctx, digest))
    canonical = case.poly.canonical_table()
    assert fused.host_sum_mod_p(case.ctx, canonical) == case.proof.claimed_sum


def test_partial_evaluate_and_algebra_equal_zktpu():
    case = _cases.get(CONFIGS[0]) or Case(*CONFIGS[0])
    ctx, jctx, poly, jpoly = case.ctx, case.jctx, case.poly, case.jpoly
    v = poly.encode_scalar(123456789)
    jv = jpoly.encode_scalar(123456789)
    assert _same(v, jv)
    for bit in range(case.nv):
        assert _same(poly.partial_evaluate(bit, v).table, jpoly.partial_evaluate(bit, jv).table)
    assert _same(poly.multi_partial_evaluate([v, v]).table, jpoly.multi_partial_evaluate([jv, jv]).table)
    other = MultilinearPoly.from_ints(ctx, list(reversed(case.vals)))
    jother = JaxPoly.from_ints(jctx, list(reversed(case.vals)))
    assert _same((poly + other).table, (jpoly + jother).table)
    assert _same((poly - other).table, (jpoly - jother).table)
    assert _same((poly * other).table, (jpoly * jother).table)
    assert _same(poly.scale(v).table, jpoly.scale(jv).table)
    assert _same(poly.sum_mont(), jpoly.sum_mont())
    assert _same(poly.halves_sums(), jpoly.halves_sums())
    small = MultilinearPoly(ctx, poly.table[:4].contiguous())
    jsmall = JaxPoly(jctx, jpoly.table[:4])
    for op in ("add", "mul"):
        got = MultilinearPoly.tensor_add_mul(ctx, small, poly, op)
        assert _same(got.table, JaxPoly.tensor_add_mul(jctx, jsmall, jpoly, op).table)
    with pytest.raises(ValueError):
        MultilinearPoly(ctx, poly.table[:3])
    with pytest.raises(ValueError):
        poly.evaluate_int([1, 2])


def test_tracker_counts_match_zktpu():
    from zktpu.utils import tracker as jtracker

    case = _cases.get(CONFIGS[0]) or Case(*CONFIGS[0])
    tracker.reset()
    jtracker.reset()
    with tracker.tracking(), jtracker.tracking():
        proof = protocol.prove(case.poly)
        protocol.verify(case.poly, proof)
        jproof = jsc.prove(case.jpoly)
        jsc.verify(case.jpoly, jproof)
    assert tracker.summary() == jtracker.summary() and tracker.summary()
    tracker.reset()
    jtracker.reset()
