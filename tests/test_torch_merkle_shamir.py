"""The port's Merkle tree, Shamir sharing and Fibonacci demo against zktpu's.

Each test runs the reference-vector test of tests/test_ntt_merkle_shamir.py on
the port's own copy and asserts that its root hashes, nodes, proofs and
recovered polynomials equal zktpu's on the same inputs. Host code only.
"""

import pytest

from zktpu import shamir as zshamir
from zktpu.field.spec import BN254_FQ as JAX_FQ
from zktpu.fibonacci import fibonacci_check as z_fibonacci_check
from zktpu.merkle import tree as ztree

from zktpu_torch import shamir
from zktpu_torch.fibonacci import FIB_POINTS, fibonacci_check
from zktpu_torch.field.spec import BN254_FQ
from zktpu_torch.merkle.tree import LeafSide, MerkleProof, MerkleTree, ProofData

FQ = BN254_FQ
P = FQ.modulus


def _same_tree(t, zt) -> None:
    assert t.leaves == zt.leaves
    assert t.tree == zt.tree
    assert t.get_root_hash() == zt.get_root_hash()


def _proof_items(proof):
    return proof.data, [(pd.data_hash, pd.data_side.value) for pd in proof.proof]


# -- Merkle: merkle_tree.rs tests -----------------------------------------

def test_merkle_create_and_root():
    """merkle_tree.rs:222-251."""
    t = MerkleTree(FQ, 2)
    assert len(t.leaves) == 4
    assert [len(level) for level in t.tree] == [2, 1]
    h1 = t.hash_pair(0, 0)
    assert t.get_root_hash() == t.hash_pair(h1, h1)
    zt = ztree.MerkleTree(JAX_FQ, 2)
    _same_tree(t, zt)
    assert h1 == zt.hash_pair(0, 0) and t.compute_hash(10) == zt.compute_hash(10)


def test_merkle_update_leaf():
    """merkle_tree.rs:253-291."""
    t, zt = MerkleTree(FQ, 2), ztree.MerkleTree(JAX_FQ, 2)
    t.update_leaf(1, 10, is_hash=False)
    zt.update_leaf(1, 10, is_hash=False)
    h = t.compute_hash(10)
    assert t.leaves[1] == h
    assert t.get_root_hash() == t.hash_pair(t.hash_pair(0, h), t.hash_pair(0, 0))
    _same_tree(t, zt)
    # delete = write back a raw zero hash
    t.update_leaf(1, 0, is_hash=True)
    zt.update_leaf(1, 0, is_hash=True)
    assert t.get_root_hash() == t.hash_pair(t.hash_pair(0, 0), t.hash_pair(0, 0))
    _same_tree(t, zt)
    with pytest.raises(ValueError):
        t.update_leaf(4, 1, is_hash=False)


def test_merkle_proof_roundtrip():
    """merkle_tree.rs:293-305."""
    t, zt = MerkleTree(FQ, 3), ztree.MerkleTree(JAX_FQ, 3)
    for tree in (t, zt):
        tree.update_leaf(0, 10, is_hash=False)
        tree.update_leaf(5, 77, is_hash=False)
    _same_tree(t, zt)
    for data, leaf in ((10, 0), (77, 5)):
        proof = t.create_proof(data, leaf)
        assert t.verify(proof)
        assert _proof_items(proof) == _proof_items(zt.create_proof(data, leaf))


def test_merkle_invalid_proof():
    """merkle_tree.rs:307-326."""
    t = MerkleTree(FQ, 2)
    assert not t.verify(MerkleProof(10, [ProofData(0, LeafSide.LEFT)] * 2))
    zt = ztree.MerkleTree(JAX_FQ, 2)
    assert not zt.verify(ztree.MerkleProof(10, [ztree.ProofData(0, ztree.LeafSide.LEFT)] * 2))


def test_merkle_create_proof_wrong_data():
    """merkle_tree.rs:328-340."""
    t = MerkleTree(FQ, 2)
    t.update_leaf(0, 10, is_hash=False)
    with pytest.raises(ValueError):
        t.create_proof(20, 0)


def test_merkle_new_with_inputs():
    """merkle_tree.rs:342-367."""
    t = MerkleTree.new_with_inputs(FQ, 2, [1, 2, 3])
    for i, v in enumerate([1, 2, 3]):
        assert t.leaves[i] == t.compute_hash(v)
    assert t.leaves[3] == 0
    _same_tree(t, ztree.MerkleTree.new_with_inputs(JAX_FQ, 2, [1, 2, 3]))
    with pytest.raises(ValueError):
        MerkleTree.new_with_inputs(FQ, 2, [1] * 5)


# -- Shamir: shamir_secret_sharing.rs tests -------------------------------

def test_shamir_create_polynomial():
    poly = shamir.create_polynomial(4, 40, 6, seed=0)
    assert poly.degree() == 3
    assert poly.evaluate(6) == 40
    assert poly.coefficients == zshamir.create_polynomial(4, 40, 6, seed=0).coefficients


def test_shamir_recover_known_points():
    """shamir_secret_sharing.rs:91-106: recover x^2+3x-5."""
    points = [(1, (-1) % P), (2, 5), (3, 13)]
    poly = shamir.recover_polynomial(points, 3)
    assert poly.coefficients == [(-5) % P, 3, 1]
    assert shamir.get_secret(poly, 0) == (-5) % P
    assert poly.coefficients == zshamir.recover_polynomial(points, 3).coefficients


def test_shamir_share_and_recover():
    """shamir_secret_sharing.rs:153-169."""
    secret_poly = shamir.create_polynomial(3, (-5) % P, 0, seed=42)
    shares = shamir.share_points(10, 3, secret_poly, seed=43)
    assert len(shares) == 10
    z_poly = zshamir.create_polynomial(3, (-5) % P, 0, seed=42)
    assert shares == zshamir.share_points(10, 3, z_poly, seed=43)
    recovered = shamir.recover_polynomial(shares[2:6], 3)
    assert recovered.coefficients == secret_poly.coefficients
    assert shamir.get_secret(recovered, 0) == (-5) % P
    # the points[0:4] quirk: six points, the first four are used
    six = shamir.recover_polynomial(shares[:6], 3)
    assert six.coefficients == zshamir.recover_polynomial(shares[:6], 3).coefficients
    assert six.coefficients == shamir.recover_polynomial(shares[:4], 3).coefficients


def test_shamir_wrong_point_fails():
    points = [(1, (-1) % P), (2, 5), (3, 1)]
    poly = shamir.recover_polynomial(points, 3)
    assert poly.coefficients != [(-5) % P, 3, 1]
    assert poly.coefficients == zshamir.recover_polynomial(points, 3).coefficients


def test_shamir_too_few_points():
    with pytest.raises(ValueError):
        shamir.recover_polynomial([(1, 1), (2, 2)], 3)


def test_shamir_too_few_shares():
    poly = shamir.create_polynomial(3, 1, 0, seed=1)
    with pytest.raises(ValueError):
        shamir.share_points(2, 3, poly)


# -- Fibonacci demo --------------------------------------------------------

def test_fibonacci_check():
    assert fibonacci_check() and z_fibonacci_check()
    assert FIB_POINTS == [1, 1, 2, 3, 5, 8, 13, 21]
