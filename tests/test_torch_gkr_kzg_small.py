"""The port's whole GKR proof (layer walk + KZG input proof) vs zktpu's, on the
CPU, on circuits of tests/test_gkr_protocol.py: the three-layer circuit and the
single gate. The same checks as test_torch_gkr_kzg.py, whose cases and test
bodies this file reuses; they are apart so that neither file is long. Also the
reference's dummy proof, which ``verify`` must refuse.
"""

import pytest

import test_torch_gkr_kzg as whole
from test_torch_gkr_kzg import (  # noqa: F401  (collected here on this file's circuits)
    test_input_proof_is_the_hosts_scalar_multiples,
    test_proof_bytes_equal_zktpus,
    test_prove_equals_zktpu,
    test_verify_accepts_and_refuses,
)

from zktpu_torch import serialize as ser
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit
from zktpu_torch.pcs.kzg import KZG
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.poly.univariate import UnivariatePoly

_cases = {}


@pytest.fixture(params=["three_layers", "one_gate"])
def case(request):
    if request.param not in _cases:
        _cases[request.param] = whole.Case(request.param)
    return _cases[request.param]


def test_single_output_is_padded_in_the_whole_proof():
    case = _cases.get("one_gate") or whole.Case("one_gate")
    assert case.proof.output_poly.to_ints() == [12, 0]
    assert case.proof.input_proof.kzg_setup.num_vars == 1


def test_lazy_and_dense_blobs_equal():
    """tests/test_serialize.py's cross-path check: the dense layer walk gives the
    lazy proof's bytes. The input proof is a function of the inputs, the taus
    and the walk's point pair, so the dense walk, at the same point pair and
    input evaluations, takes the lazy proof's (a second CPU prove of it costs
    some 25 s of MSMs)."""
    case = _cases.get("one_gate") or whole.Case("one_gate")
    lazy = gkr.prove_layers(case.circuit, case.inputs, lazy=True)
    dense = gkr.prove_layers(case.circuit, case.inputs, lazy=False)
    assert (dense.r_b, dense.r_c, dense.input_evals) == (lazy.r_b, lazy.r_c, lazy.input_evals)
    assert tuple(case.proof.input_proof.opened_evals) == dense.input_evals
    blobs = [ser.encode_gkr_proof(gkr.GkrProof(w.proof.output_poly, w.proof.proof_polynomials,
                                               w.proof.claimed_evaluations, case.proof.input_proof))
             for w in (lazy, dense)]
    assert blobs[0] == blobs[1] == ser.encode_gkr_proof(case.proof)


def test_verify_rejects_the_dummy_proof():
    """tests/test_gkr_protocol.py:39-57 (gkr_protocol.rs:508-570)."""
    ctx = whole.ctx
    circuit = Circuit(ctx, [[MUL, MUL], [ADD]])
    dummy = UnivariatePoly.interpolate(whole.BLS12_381_FR, [(0, 10), (1, 5)])
    input_proof = gkr.KzgProof(
        kzg_setup=KZG.setup(1, [1], device="cpu"),
        commitment=hc.G1_GEN,
        proof=[[hc.G1_GEN], [hc.G1_GEN]],
        opened_evals=[1, 2],
    )
    invalid = gkr.GkrProof(
        output_poly=MultilinearPoly.from_ints(ctx, [10, 0]),
        proof_polynomials=[[dummy, dummy], [dummy, dummy, dummy, dummy]],
        claimed_evaluations=[(10, 5)],
        input_proof=input_proof,
    )
    assert not gkr.verify(invalid, circuit)
