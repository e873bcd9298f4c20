"""The port's multilinear KZG vs the reference's known-answer vectors and zktpu.

The vectors are those of tests/test_kzg.py (pinned to the reference's
pcs/src/kzg_pcs/kzg.rs), with zktpu's basis and eq table beside them.
Everything runs on the CPU
(``device="cpu"``: the point kernels' plain versions). Tolerance 0.
"""

import numpy as np
import pytest
import torch

from zktpu.pcs import kzg as jkzg

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.pcs.kzg import KZG, eq_table_device, random_taus
from zktpu_torch.poly.multilinear import MultilinearPoly

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
POLY_EVALS = [0, 4, 0, 4, 0, 4, 3, 7]
TAUS = [5, 2, 3]
OPENING = [6, 4, 0]
EQ_EVALS = [-8, 12, 16, -24, 10, -15, -20, 30]


@pytest.fixture(scope="module")
def kzg():
    return KZG.setup(3, TAUS, device="cpu")


@pytest.fixture(scope="module")
def poly():
    return MultilinearPoly.from_ints(ctx, POLY_EVALS)


@pytest.fixture(scope="module")
def proof(kzg, poly):
    return kzg.get_proof(72, OPENING, poly)


def test_lagrange_basis(kzg):
    """kzg.rs:234-255: eq evals [-8,12,16,-24,10,-15,-20,30] * G1; and the same
    affine points as zktpu's comb."""
    basis = dc.unpack_points(kzg.g1_lagrange_basis)
    assert basis == [hc.multiply(hc.G1_GEN, s % hc.R_ORDER) for s in EQ_EVALS]
    jbasis = jkzg.KZG.setup(3, TAUS)
    assert [convert.host_point_from_zktpu(pt)
            for pt in jkzg.dc.unpack_points(jbasis.g1_lagrange_basis)] == basis
    assert [convert.host_point_from_zktpu(pt) for pt in jbasis.g2_taus] == kzg.g2_taus
    carried = convert.kzg_from_zktpu(jbasis)
    assert dc.unpack_points(carried.g1_lagrange_basis) == basis and carried.num_vars == 3


def test_eq_table_values():
    eq = eq_table_device(TAUS, "cpu")
    assert [int(v) for v in ctx.unpack(fk.from_mont(ctx, eq))] == [s % hc.R_ORDER for s in EQ_EVALS]
    # word for word zktpu's table
    assert torch.equal(eq, convert.table_from_zktpu(np.asarray(jkzg.eq_table_device(TAUS))))


def test_commit(kzg, poly):
    """kzg.rs:317-341: commitment == 42 * G1."""
    assert kzg.commit(poly) == hc.multiply(hc.G1_GEN, 42)


def test_open(kzg, poly):
    """kzg.rs:344-366."""
    assert kzg.open(OPENING, poly) == 72


def test_get_proof(proof):
    """kzg.rs:369-400: quotients [6, 18, 4] * G1."""
    assert proof == [hc.multiply(hc.G1_GEN, s) for s in [6, 18, 4]]


def test_verify_roundtrip_and_forgery(kzg, proof):
    """kzg.rs:403-463."""
    commitment = hc.multiply(hc.G1_GEN, 42)
    assert KZG.verify(commitment, 72, proof, OPENING, kzg.g2_taus)
    assert not KZG.verify(commitment, 72, [hc.G1_GEN] * 3, OPENING, kzg.g2_taus)
    assert not KZG.verify(commitment, 73, proof, OPENING, kzg.g2_taus)
    assert not KZG.verify(hc.add(commitment, hc.G1_GEN), 72, proof, OPENING, kzg.g2_taus)
    with pytest.raises(ValueError):
        KZG.verify(commitment, 72, proof[:2], OPENING, kzg.g2_taus)


def test_setup_validations(kzg):
    with pytest.raises(ValueError):
        KZG.setup(0, [], device="cpu")
    with pytest.raises(ValueError):
        KZG.setup(2, [1, 2, 3], device="cpu")
    small = MultilinearPoly.from_ints(ctx, [1, 2, 3, 4])
    with pytest.raises(ValueError):
        KZG.for_poly(small, [1, 2, 3])
    with pytest.raises(ValueError):
        kzg.commit(small)
    with pytest.raises(ValueError):
        kzg.get_proof(0, [1, 2], MultilinearPoly.from_ints(ctx, POLY_EVALS))
    taus = random_taus(4)
    assert len(taus) == 4 and all(0 < t < hc.R_ORDER for t in taus)


def test_collapsed_bases_are_the_halving_chain(kzg):
    """collapsed_bases()[k][y] = sum_j L[j * m + y] with m = 2^(n-1-k): against
    the host's sums of the known basis scalars; built lazily and kept."""
    kzg = KZG(kzg.g1_lagrange_basis, kzg.g2_taus, 3)
    assert kzg._collapsed is None
    assert len(kzg.collapsed_bases(upto=1)) == 1
    chain = kzg.collapsed_bases()
    assert [c[0].shape[0] for c in chain] == [4, 2, 1] and kzg.collapsed_bases() is chain
    for k, base in enumerate(chain):
        m = 1 << (2 - k)
        want = [hc.multiply(hc.G1_GEN, sum(EQ_EVALS[y::m]) % hc.R_ORDER) for y in range(m)]
        assert dc.unpack_points(base) == want
