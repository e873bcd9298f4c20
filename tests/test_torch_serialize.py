"""The port's proof bytes (``zktpu_torch.serialize``) against zktpu's, on the CPU.

Mirrors tests/test_serialize.py: exact round trips of G1/G2 points (both sign
classes) and field elements, a field element at p refused, and the plain
sumcheck proof of the same 16-entry BN254 Fq table encoded by both packages to
the same bytes. The whole GKR proof's bytes are held against zktpu's in
tests/test_torch_gkr_kzg.py and tests/test_torch_gkr_kzg_small.py, on their
proofs. Tolerance 0: bytes are equal or the test fails.
"""

import numpy as np
import pytest
import torch

from zktpu import serialize as jser
from zktpu.curve import bls12_381 as jhc
from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BN254_FQ as JAX_BN254_FQ
from zktpu.poly.multilinear import MultilinearPoly as JaxMultilinearPoly
from zktpu.sumcheck import protocol as jsumcheck

from zktpu_torch import serialize as ser
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import protocol as sumcheck

torch.set_num_threads(1)


def test_g1_roundtrip_and_bytes_equal_zktpus():
    scalars = [123456789, 7]
    pts = [None, hc.G1_GEN, hc.multiply(hc.G1_GEN, scalars[0]),
           hc.neg(hc.multiply(hc.G1_GEN, scalars[1]))]
    jpts = [None, jhc.G1_GEN, jhc.multiply(jhc.G1_GEN, scalars[0]),
            jhc.neg(jhc.multiply(jhc.G1_GEN, scalars[1]))]
    for pt, jpt in zip(pts, jpts):
        blob = ser.encode_g1(pt)
        assert len(blob) == ser.G1_BYTES
        assert blob == jser.encode_g1(jpt)
        assert ser.decode_g1(ser.Reader(blob)) == pt


def test_g1_both_sign_classes():
    """Some multiple has the larger root, some the smaller; both must survive."""
    seen = set()
    for k in range(1, 20):
        pt = hc.multiply(hc.G1_GEN, k)
        blob = ser.encode_g1(pt)
        seen.add(blob[-1] & 0x80)
        assert ser.decode_g1(ser.Reader(blob)) == pt
    assert seen == {0, 0x80}


def test_g2_roundtrip_and_bytes_equal_zktpus():
    pts = [None, hc.G2_GEN, hc.multiply(hc.G2_GEN, 987654321),
           hc.neg(hc.multiply(hc.G2_GEN, 12))]
    jpts = [None, jhc.G2_GEN, jhc.multiply(jhc.G2_GEN, 987654321),
            jhc.neg(jhc.multiply(jhc.G2_GEN, 12))]
    for pt, jpt in zip(pts, jpts):
        blob = ser.encode_g2(pt)
        assert len(blob) == ser.G2_BYTES
        assert blob == jser.encode_g2(jpt)
        got = ser.decode_g2(ser.Reader(blob))
        if pt is None:
            assert got is None
        else:
            assert got[0].coeffs == pt[0].coeffs and got[1].coeffs == pt[1].coeffs


def test_field_rejects_non_canonical():
    p = BLS12_381_FR.modulus
    assert ser.decode_field(ser.Reader((p - 1).to_bytes(32, "little"))) == p - 1
    with pytest.raises(ValueError):
        ser.decode_field(ser.Reader(p.to_bytes(32, "little")))


def test_plain_sumcheck_blob_equals_zktpus():
    rng = np.random.default_rng(5)
    values = [int(v) for v in rng.integers(0, 1 << 60, size=16)]
    poly = MultilinearPoly.from_ints(fb.get_ctx(BN254_FQ, device="cpu"), values)
    proof = sumcheck.prove(poly)
    jproof = jsumcheck.prove(JaxMultilinearPoly.from_ints(jfb.get_ctx(JAX_BN254_FQ), values))

    blob = ser.encode_sumcheck_proof(proof, BN254_FQ)
    assert blob == jser.encode_sumcheck_proof(jproof, JAX_BN254_FQ)
    back = ser.decode_sumcheck_proof(blob, BN254_FQ)
    assert back.claimed_sum == proof.claimed_sum
    assert back.proof_polynomials == proof.proof_polynomials
    assert ser.encode_sumcheck_proof(back, BN254_FQ) == blob
    assert sumcheck.verify(poly, back)


def test_malformed_blobs_raise_value_error():
    poly = MultilinearPoly.from_ints(fb.get_ctx(BN254_FQ, device="cpu"), list(range(8)))
    blob = ser.encode_sumcheck_proof(sumcheck.prove(poly), BN254_FQ)
    for bad in (blob[:-1], blob + b"\x00", bytes([ser.VERSION + 1]) + blob[1:], b""):
        with pytest.raises(ValueError):
            ser.decode_sumcheck_proof(bad, BN254_FQ)
    # a GKR blob whose output table has 3 entries
    three = bytes([ser.VERSION]) + ser._encode_fields([1, 2, 3])
    with pytest.raises(ValueError, match="power of two"):
        ser.decode_gkr_proof(three, device="cpu")


def test_decode_gkr_proof_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card's")
    with pytest.raises(RuntimeError, match="CUDA"):
        ser.decode_gkr_proof(bytes([ser.VERSION]))
