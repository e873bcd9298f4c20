"""The 2^6 opening of tests/test_kzg.py:77-95 through the port's KZG on the CPU:
every quotient is committed untiled against its own collapsed basis, and each
commitment is the host's scalar multiple of G1 by the quotient at the taus."""

import numpy as np
import torch

from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.pcs.kzg import KZG
from zktpu_torch.poly.multilinear import MultilinearPoly

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")


def test_get_proof_2e6_verifies_and_refuses_a_tampered_quotient():
    rng = np.random.default_rng(31)
    vals = [int(v) for v in rng.integers(0, 1 << 60, size=64)]
    taus = [int(t) for t in rng.integers(2, 1 << 40, size=6)]
    poly = MultilinearPoly.from_ints(ctx, vals)
    kzg = KZG.for_poly(poly, taus)
    point = [int(v) for v in rng.integers(1, 1 << 40, size=6)]
    opened = kzg.open(point, poly)
    proof = kzg.get_proof(opened, point, poly)
    commitment = kzg.commit(poly)
    assert commitment == hc.multiply(hc.G1_GEN, poly.evaluate_int(taus))
    # quotient k is a polynomial in the variables after k: its commitment is
    # q_k(tau_{k+1}, ..) * G1
    quotients = kzg._quotients(opened, point, poly)
    for k, q in enumerate(quotients):
        assert q.shape[0] == 1 << (5 - k)
        q_at_tau = MultilinearPoly.from_ints(ctx, [int(v) for v in ctx.unpack(q)]).evaluate_int(
            taus[k + 1:])
        assert proof[k] == (hc.multiply(hc.G1_GEN, q_at_tau) if q_at_tau else None)
    assert KZG.verify(commitment, opened, proof, point, kzg.g2_taus)
    bad = list(proof)
    bad[2] = hc.add(bad[2], hc.G1_GEN)
    assert not KZG.verify(commitment, opened, bad, point, kzg.g2_taus)
