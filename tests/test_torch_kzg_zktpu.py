"""A 2^4 polynomial through zktpu's KZG and the port's, on the CPU: the same
taus and points, the same affine commitment and quotient points. Tolerance 0."""

import numpy as np
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.pcs import kzg as jkzg
from zktpu.poly.multilinear import MultilinearPoly as JMultilinearPoly

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.pcs.kzg import KZG
from zktpu_torch.poly.multilinear import MultilinearPoly

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
jctx = jfb.get_ctx(JAX_FR)


def test_2e4_commitment_and_both_proofs_equal_zktpu():
    """Same polynomial, taus and points through zktpu's ``commit`` / ``get_proof``
    (tiled quotients against the once-collapsed basis) and the port's (untiled
    against the halving chain): the same affine points; the pair entry point
    gives what the single ones give."""
    rng = np.random.default_rng(29)
    n_vars = 4
    vals = [int(v) for v in rng.integers(0, 1 << 61, size=1 << n_vars)]
    taus = [int(t) for t in rng.integers(2, 1 << 60, size=n_vars)]
    r_b = [int(v) for v in rng.integers(1, 1 << 60, size=n_vars)]
    r_c = [int(v) for v in rng.integers(1, 1 << 60, size=n_vars)]

    jpoly = JMultilinearPoly.from_ints(jctx, vals)
    jk = jkzg.KZG.setup(n_vars, taus)
    jvb, jvc = jk.open(r_b, jpoly), jk.open(r_c, jpoly)
    want_commitment = convert.host_point_from_zktpu(jk.commit(jpoly))
    want_b = [convert.host_point_from_zktpu(pt) for pt in jk.get_proof(jvb, r_b, jpoly)]
    want_c = [convert.host_point_from_zktpu(pt) for pt in jk.get_proof(jvc, r_c, jpoly)]

    poly = MultilinearPoly.from_ints(ctx, vals)
    kzg = KZG.for_poly(poly, taus)
    vb, vc = kzg.open(r_b, poly), kzg.open(r_c, poly)
    assert (vb, vc) == (int(jvb), int(jvc))
    commitment, pb, pc = kzg.commit_with_proof_pair((vb, r_b), (vc, r_c), poly)
    assert commitment == want_commitment == hc.multiply(hc.G1_GEN, poly.evaluate_int(taus))
    assert pb == want_b
    assert pc == want_c
    assert KZG.verify(commitment, vb, pb, r_b, kzg.g2_taus)
    assert not KZG.verify(commitment, vb, pc, r_b, kzg.g2_taus)
