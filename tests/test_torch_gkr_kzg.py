"""The port's whole GKR proof (layer walk + KZG input proof) vs zktpu's, on the
CPU, on the 2^5-input benchmark circuit whose input proof ``chip_smoke.py`` holds
the card's against by a stored digest (test_torch_gkr_kzg_small.py does the same
on circuits of tests/test_gkr_protocol.py and imports this file's cases).

The same gates, inputs and taus go into ``zktpu.gkr.protocol.prove`` and the
port's ``prove`` (``device="cpu"``: the kernels' plain versions). Tolerance 0:
the commitment, the 2n quotient points, the opened evaluations and the layer
proof are equal, and ``verify`` accepts both proofs and refuses tampered ones.
The port's proof encodes to zktpu's bytes (``serialize``), and the bytes decode
to a proof that verifies.
"""

import copy

import pytest
import torch

from zktpu import serialize as jser
from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.gkr import circuit as jcircuit
from zktpu.gkr import protocol as jgkr

import chip_smoke
from zktpu_torch import convert
from zktpu_torch import serialize as ser
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit
from zktpu_torch.poly.multilinear import MultilinearPoly

torch.set_num_threads(1)

P = BLS12_381_FR.modulus
ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
jctx = jfb.get_ctx(JAX_FR)


def _benchmark():
    n = chip_smoke.KZG_DIGEST_INPUTS
    structure, inputs = chip_smoke.gkr_benchmark(n)
    return structure, inputs, chip_smoke.gkr_benchmark_taus(n)


CIRCUITS = {
    "benchmark_2e5": _benchmark(),
    # tests/test_gkr_protocol.py:30-36 and :108-113
    "three_layers": ([[ADD, ADD, ADD, ADD], [MUL, ADD], [ADD]], [5, 2, 2, 4, 10, 0, 3, 3],
                     [11, 7, 13]),
    "one_gate": ([[MUL]], [3, 4], [5]),
}


class Case:
    def __init__(self, name):
        self.structure, self.inputs, self.taus = CIRCUITS[name]
        self.circuit = Circuit(ctx, self.structure)
        self.proof = gkr.prove(self.circuit, self.inputs, taus=self.taus)
        self.jproof = jgkr.prove(jcircuit.Circuit(jctx, self.structure), self.inputs,
                                 taus=self.taus)
        self.converted = convert.gkr_proof_from_zktpu(ctx, self.jproof)


_cases = {}


@pytest.fixture(params=["benchmark_2e5"])
def case(request):
    if request.param not in _cases:
        _cases[request.param] = Case(request.param)
    return _cases[request.param]


def _coeffs(layers):
    return [[poly.coefficients for poly in layer] for layer in layers]


def test_prove_equals_zktpu(case):
    got, want = case.proof, case.converted
    assert _coeffs(got.proof_polynomials) == _coeffs(want.proof_polynomials)
    assert got.claimed_evaluations == want.claimed_evaluations
    assert got.output_poly.to_ints() == want.output_poly.to_ints()
    n = len(case.taus)
    assert got.input_proof.commitment == want.input_proof.commitment
    assert got.input_proof.proof == want.input_proof.proof
    assert [len(side) for side in got.input_proof.proof] == [n, n]
    assert got.input_proof.opened_evals == want.input_proof.opened_evals
    assert got.input_proof.kzg_setup.g2_taus == want.input_proof.kzg_setup.g2_taus


def test_input_proof_is_the_hosts_scalar_multiples(case):
    """The taus are known, so the commitment is input_poly(taus) * G1 and the
    opened evaluations are the input polynomial's at the walk's point pair."""
    input_poly = MultilinearPoly.from_ints(ctx, case.inputs)
    kzg = case.proof.input_proof
    assert kzg.commitment == hc.multiply(hc.G1_GEN, input_poly.evaluate_int(case.taus))
    layers = gkr.prove_layers(case.circuit, case.inputs)
    assert tuple(kzg.opened_evals) == layers.input_evals
    assert all(pt is None or hc.is_on_curve(pt, hc.B1) for side in kzg.proof for pt in side)


def test_verify_accepts_and_refuses(case):
    proof, kzg = case.proof, case.proof.input_proof
    assert gkr.verify(proof, case.circuit)
    assert gkr.verify(case.converted, case.circuit)

    def refused(**changes):
        bad = copy.copy(proof)
        bad.input_proof = copy.copy(kzg)
        for name, value in changes.items():
            setattr(bad.input_proof, name, value)
        return not gkr.verify(bad, case.circuit)

    quotients = list(kzg.proof[0])
    quotients[0] = hc.add(quotients[0], hc.G1_GEN)
    assert refused(proof=[quotients, kzg.proof[1]])
    quotients = list(kzg.proof[1])
    quotients[-1] = hc.neg(quotients[-1]) if quotients[-1] is not None else hc.G1_GEN
    assert refused(proof=[kzg.proof[0], quotients])
    assert refused(commitment=hc.double(kzg.commitment))
    assert refused(opened_evals=[(kzg.opened_evals[0] + 1) % P, kzg.opened_evals[1]])
    assert refused(opened_evals=[kzg.opened_evals[0], (kzg.opened_evals[1] + 1) % P])
    bad = copy.deepcopy(proof)
    coeffs = bad.proof_polynomials[-1][0].coefficients
    coeffs[0] = (coeffs[0] + 1) % P
    assert not gkr.verify(bad, case.circuit)
    with pytest.raises(ValueError):  # a proof from prove_layers carries no input proof
        gkr.verify(gkr.prove_layers(case.circuit, case.inputs).proof, case.circuit)


def test_proof_bytes_equal_zktpus(case):
    """The port's blob is zktpu's; it decodes (on the CPU) to a proof that
    re-encodes to the same bytes and verifies; the blobs with one byte changed
    that ``chip_smoke.py`` phase 15 tries raise ValueError or are refused."""
    blob = ser.encode_gkr_proof(case.proof)
    assert blob == jser.encode_gkr_proof(case.jproof)
    back = ser.decode_gkr_proof(blob, device="cpu")
    assert back.output_poly.table.device == ctx.device
    assert back.input_proof.kzg_setup.g1_lagrange_basis is None
    assert ser.encode_gkr_proof(back) == blob
    assert gkr.verify(back, case.circuit)
    verdicts = {name: chip_smoke.blob_verdict(bad, case.circuit)
                for name, bad in chip_smoke.tampered_blobs(blob, case.proof).items()}
    assert set(verdicts) == {"field element", "G1 flag byte", "length prefix"}
    assert all(v in ("raised", "refused") for v in verdicts.values()), verdicts


def test_stored_digest_is_the_benchmark_proofs():
    """The digest that ``chip_smoke.py`` holds the card's 2^5 input proof
    against is the digest of the proof that this file pins to zktpu."""
    case = _cases.get("benchmark_2e5") or Case("benchmark_2e5")
    assert chip_smoke.kzg_proof_digest(case.proof.input_proof) == chip_smoke.KZG_PROOF_DIGEST_2E5
    assert chip_smoke.kzg_proof_digest(case.converted.input_proof) == chip_smoke.KZG_PROOF_DIGEST_2E5
    assert len(chip_smoke.gkr_benchmark_taus(5)) == 5
    assert chip_smoke.gkr_benchmark(5) == tuple(chip_smoke._gkr_benchmark_draws(5)[1:])
