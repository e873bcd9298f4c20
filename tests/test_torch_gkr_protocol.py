"""The GKR layer walk of zktpu_torch as a whole vs zktpu's ``gkr.protocol.prove``.

For each circuit of tests/test_gkr_protocol.py the same gates and inputs go into
both packages. zktpu proves once per circuit (its proof carries the KZG input
proof, computed on the CPU); the port's ``prove_layers`` runs dense, fused and
on a two-slot CPU mesh (the sharded prover, which fetches and squeezes a round
on the host) on the CPU (``device="cpu"``, the kernels' plain versions). Tolerance 0:
every round polynomial, claimed evaluation, output entry and input evaluation
is compared as an integer, and ``verify_layers`` must accept zktpu's proof once
converted and refuse the tampered ones. The port's whole ``prove`` / ``verify``
(with the KZG input proof) are held against zktpu's in test_torch_gkr_kzg.py and
test_torch_gkr_kzg_small.py: this file is the longest of the run as it is.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.gkr import circuit as jcircuit
from zktpu.gkr import protocol as jgkr
from zktpu.utils import tracker as jtracker

from zktpu_torch import convert
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit, Layer
from zktpu_torch.parallel import context as pctx
from zktpu_torch.parallel import mesh as pm
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.utils import tracker

torch.set_num_threads(1)

FR = BLS12_381_FR
P = FR.modulus
ctx = fb.get_ctx(FR, device="cpu")
jctx = jfb.get_ctx(JAX_FR)


def _random_circuit():
    """The 32-input random circuit of test_gkr_protocol.py:92-100."""
    rng = np.random.default_rng(19)
    structure = []
    n = 16
    while n >= 1:
        structure.append([ADD if rng.integers(2) else MUL for _ in range(n)])
        n //= 2
    inputs = [int(v) for v in rng.integers(0, 1 << 61, size=32)]
    taus = [int(t) for t in rng.integers(2, 1 << 60, size=5)]
    return structure, inputs, taus


CIRCUITS = {
    # the all-ADD first layer makes a quadratic coefficient vanish: the trim
    "three_layers": ([[ADD, ADD, ADD, ADD], [MUL, ADD], [ADD]], [5, 2, 2, 4, 10, 0, 3, 3], [11, 7, 13]),
    "two_layers": ([[ADD, ADD], [MUL]], [1, 2, 3, 4], [3, 9]),
    "one_gate": ([[MUL]], [3, 4], [5]),
    "random_32": _random_circuit(),
}
#: the circuit whose zktpu proof is dense and counted by zktpu's tracker, so
#: test_dense_prover_tracker_counts_equal_zktpu reads the counts of the proof
#: the other tests compare (zktpu's dense and lazy proofs are the same values)
TRACKED = "two_layers"
#: how ``prove_layers`` is run: the dense tensors, the lazy tables on one
#: device (the fused prover), and the lazy tables on two slots of the CPU
MODES = {
    "dense": dict(lazy=False),
    "mesh": dict(lazy=True, mesh=2),
    "fused": dict(lazy=True),
}


class Case:
    def __init__(self, name):
        self.structure, self.inputs, taus = CIRCUITS[name]
        self.circuit = Circuit(ctx, self.structure)
        self.jcircuit = jcircuit.Circuit(jctx, self.structure)
        tracked = name == TRACKED
        jtracker.reset()
        with jtracker.tracking() if tracked else contextlib.nullcontext():
            self.jproof = jgkr.prove(self.jcircuit, self.inputs, taus=taus,
                                     lazy=False if tracked else None)
        self.jcounts = dict(jtracker.summary()) if tracked else None
        jtracker.reset()
        self.converted = convert.gkr_proof_from_zktpu(ctx, self.jproof)
        self.input_evals = tuple(int(v) for v in self.jproof.input_proof.opened_evals)
        self._proofs = {}

    def proof(self, mode):
        if mode not in self._proofs:
            options = dict(MODES[mode])
            slots = options.pop("mesh", None)
            with pctx.use_mesh(pm.make_mesh(devices=["cpu"] * slots) if slots else None):
                self._proofs[mode] = gkr.prove_layers(self.circuit, self.inputs, **options)
        return self._proofs[mode]


_cases = {}


@pytest.fixture(params=list(CIRCUITS))
def case(request):
    if request.param not in _cases:
        _cases[request.param] = Case(request.param)
    return _cases[request.param]


def _coeffs(layers):
    return [[poly.coefficients for poly in layer] for layer in layers]


@pytest.mark.parametrize("mode", list(MODES))
def test_prove_layers_equals_zktpu(case, mode):
    got = case.proof(mode)
    want = case.jproof
    assert _coeffs(got.proof.proof_polynomials) == _coeffs(want.proof_polynomials)
    assert got.proof.claimed_evaluations == [tuple(int(v) for v in pair) for pair in want.claimed_evaluations]
    assert got.proof.output_poly.to_ints() == want.output_poly.to_ints()
    assert got.input_evals == case.input_evals
    assert got.proof.input_proof is None
    # the point pair is the last layer's challenges, and the evaluations are the input's there
    input_poly = MultilinearPoly.from_ints(ctx, case.inputs)
    assert len(got.r_b) == len(got.r_c) == input_poly.num_vars
    assert got.input_evals == (input_poly.evaluate_int(got.r_b), input_poly.evaluate_int(got.r_c))
    assert len(got.proof.proof_polynomials) == len(case.structure)
    assert [len(layer) for layer in got.proof.proof_polynomials] == [
        2 * max(1, len(ops).bit_length()) for ops in reversed(case.structure)
    ]


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "dense"])
def test_verify_layers_accepts_zktpu_proof(case, lazy):
    result = gkr.verify_layers(case.converted, case.circuit, case.input_evals, lazy=lazy)
    assert result.verified
    own = case.proof("fused")
    assert (result.r_b, result.r_c) == (own.r_b, own.r_c)
    assert gkr.verify_layers(own.proof, case.circuit, own.input_evals, lazy=lazy).verified
    assert jgkr.verify(case.jproof, case.jcircuit, lazy=lazy)


def test_verify_layers_refuses_tampered_proofs(case):
    def refused(proof, evals=case.input_evals):
        verdicts = [gkr.verify_layers(proof, case.circuit, evals, lazy=lz) for lz in (True, False)]
        assert all((v.r_b, v.r_c) == ([], []) for v in verdicts if not v.verified)
        return not any(v.verified for v in verdicts)

    o_1, o_2 = case.input_evals
    assert refused(case.converted, ((o_1 + 1) % P, o_2))
    assert refused(case.converted, (o_1, (o_2 + 1) % P))
    for layer in (0, len(case.structure) - 1):
        bad = copy.deepcopy(case.converted)
        coeffs = bad.proof_polynomials[layer][-1].coefficients
        coeffs[0] = (coeffs[0] + 1) % P
        assert refused(bad)
    if case.converted.claimed_evaluations:
        bad = copy.deepcopy(case.converted)
        a, b = bad.claimed_evaluations[0]
        bad.claimed_evaluations[0] = ((a + 1) % P, b)
        assert refused(bad)
    bad = copy.deepcopy(case.converted)
    bad.output_poly = MultilinearPoly.from_ints(ctx, [v + 1 for v in bad.output_poly.to_ints()])
    assert refused(bad)


def test_single_output_is_padded_to_two_entries():
    case = _cases.get("one_gate") or Case("one_gate")
    assert case.proof("fused").proof.output_poly.to_ints() == [12, 0]
    assert case.proof("dense").proof.output_poly.to_ints() == [12, 0]


def test_trimmed_round_polynomial_goes_through_the_fused_path():
    """The all-ADD layer's vanishing quadratic coefficient (test_gkr_protocol.py
    :116-130): the fused prover's device absorb must place its padding after two
    coefficients, or every later challenge differs."""
    case = _cases.get("three_layers") or Case("three_layers")
    lengths = [[len(c) for c in layer] for layer in _coeffs(case.proof("fused").proof.proof_polynomials)]
    assert any(n < 3 for layer in lengths for n in layer)
    assert lengths == [[len(c) for c in layer] for layer in _coeffs(case.jproof.proof_polynomials)]


def test_defaults_pick_lazy_and_fused(monkeypatch):
    """With no options and no mesh every layer runs the fused prover, and the
    walk takes no ``fused`` option."""
    case = _cases.get("two_layers") or Case("two_layers")
    assert gkr._lazy_ok(case.circuit)
    assert not gkr._lazy_ok(Circuit(ctx, [[ADD, ADD, ADD]]))
    assert not gkr._lazy_ok(Circuit(ctx, [[ADD] * 4]))
    calls = []
    fused = gkr.gkr_prove_lazy_fused

    def spy(*args):
        calls.append(args)
        return fused(*args)

    monkeypatch.setattr(gkr, "gkr_prove_lazy_fused", spy)
    default = gkr.prove_layers(case.circuit, case.inputs)
    assert len(calls) == len(case.structure)
    assert _coeffs(default.proof.proof_polynomials) == _coeffs(case.proof("fused").proof.proof_polynomials)
    for call in (gkr.prove_layers, gkr.prove):
        with pytest.raises(TypeError):
            call(case.circuit, case.inputs, fused=False)
    with pytest.raises(ValueError):
        gkr.prove_layers(Circuit(fb.get_ctx(BN254_FQ, device="cpu"), [[ADD]]), [1, 2])


def test_get_fbc_poly_known_vector():
    """gkr_protocol.rs:422-452: single add gate, r=5, w=[2,12]."""
    w = MultilinearPoly.from_ints(ctx, [2, 12])
    fbc = gkr.get_fbc_poly(ctx, 5, Layer([ADD]), w, w)
    got = [[f.to_ints() for f in pr.factors] for pr in fbc.products]
    assert got[0] == [[0, (-4) % P, 0, 0], [4, 14, 14, 24]]
    assert got[1] == [[0, 0, 0, 0], [4, 24, 24, 144]]


def test_dense_prover_tracker_counts_equal_zktpu():
    """The dense walk counts every field operation where zktpu does. zktpu's
    prove goes on to open the input polynomial at r_b and r_c, two evaluations
    more of the 4-entry table (3 mul and 6 add each), and counts nothing else."""
    case = _cases.get(TRACKED) or Case(TRACKED)
    tracker.reset()
    with tracker.tracking():
        gkr.prove_layers(Circuit(ctx, case.structure), case.inputs, lazy=False)
    want = dict(case.jcounts)
    want["mul"] -= 2 * 3
    want["add"] -= 2 * 6
    # the host packing routes (field.pack_fast / field.pack_exact) have no count in zktpu
    ops = {k: v for k, v in tracker.summary().items() if not k.startswith("field.pack_")}
    assert ops == want and ops
    tracker.reset()
