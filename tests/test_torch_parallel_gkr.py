"""The port's ``gkr.prove(mesh=...)`` against zktpu's ``gkr.prove``, at the real
``MIN_ROWS_PER_DEVICE`` (256), on the CPU.

The end-to-end proof is tests/test_parallel.py:161-193's: the 32-input halving
circuit of seed 31 with its taus, on an 8-slot CPU mesh. zktpu's own test lowers
the threshold to 1 to shard its MSMs; here nothing is patched, so the three
layers whose w tables the 8 slots divide run ``gkr_sumcheck_lazy_sharded``
(``min_rows=1``) and the KZG MSMs (32 points, 4 a slot) stay on one device.
The proof encodes (``serialize``) to the bytes of zktpu's ``gkr.prove`` of the
same circuit (which test_parallel.py pins to zktpu's mesh proof) and verifies.
Which paths ran is counted by a spy on the calls. Tolerance 0. (KZG's sharded
commitment at 256 points a slot: test_torch_parallel_kzg.py.)
"""

import numpy as np
import pytest
import torch

from zktpu import serialize as jser
from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.gkr import circuit as jcircuit
from zktpu.gkr import protocol as jgkr

from zktpu_torch import serialize as ser
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit
from zktpu_torch.parallel import context as pctx
from zktpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
SHARDED = ("gkr_sumcheck_lazy_sharded", "msm_pippenger_sharded", "msm_pippenger_multi_sharded")


def _circuit_of_test_parallel():
    rng = np.random.default_rng(31)
    structure = []
    n = 16
    while n >= 1:
        structure.append([ADD if rng.integers(2) else MUL for _ in range(n)])
        n //= 2
    inputs = [int(v) for v in rng.integers(0, 1 << 61, size=32)]
    taus = [int(t) for t in rng.integers(2, 1 << 60, size=5)]
    return structure, inputs, taus


@pytest.fixture
def spy(monkeypatch):
    """Calls of each sharded path of ``parallel.mesh``, by name."""
    calls = {name: 0 for name in SHARDED}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in SHARDED:
        monkeypatch.setattr(pm, name, counted(name, getattr(pm, name)))
    return calls


class Case:
    def __init__(self, spy):
        self.structure, self.inputs, self.taus = _circuit_of_test_parallel()
        self.circuit = Circuit(ctx, self.structure)
        self.mesh = pm.make_mesh(devices=["cpu"] * 8)
        self.proof = gkr.prove(self.circuit, self.inputs, taus=self.taus, mesh=self.mesh)
        self.calls = dict(spy)
        self.jproof = jgkr.prove(jcircuit.Circuit(jfb.get_ctx(JAX_FR), self.structure),
                                 self.inputs, taus=self.taus)


_cases = {}


@pytest.fixture
def case(spy):
    if "e2e" not in _cases:
        _cases["e2e"] = Case(spy)
    return _cases["e2e"]


def _coeffs(layers):
    return [[poly.coefficients for poly in layer] for layer in layers]


def test_mesh_proof_bytes_equal_zktpus(case):
    assert ser.encode_gkr_proof(case.proof) == jser.encode_gkr_proof(case.jproof)
    assert pctx.current_mesh() is None


def test_mesh_proof_shards_the_layers_and_not_the_kzg(case, spy):
    """w tables of 32, 16 and 8 entries shard over 8 slots, those of 4 and 2 do
    not; 32 points are 4 a slot, under the 256 of MIN_ROWS_PER_DEVICE. The
    same walk under ``use_mesh`` around ``prove_layers`` shards the same
    layers and gives the single device's layer proof."""
    assert case.calls == {"gkr_sumcheck_lazy_sharded": 3, "msm_pippenger_sharded": 0,
                          "msm_pippenger_multi_sharded": 0}
    single = gkr.prove_layers(case.circuit, case.inputs)
    assert spy["gkr_sumcheck_lazy_sharded"] == 0
    with pctx.use_mesh(case.mesh):
        walked = gkr.prove_layers(case.circuit, case.inputs)
    assert spy["gkr_sumcheck_lazy_sharded"] == 3
    for layers in (walked.proof, case.proof):
        assert _coeffs(layers.proof_polynomials) == _coeffs(single.proof.proof_polynomials)
        assert layers.claimed_evaluations == single.proof.claimed_evaluations
    assert (walked.r_b, walked.r_c, walked.input_evals) == (single.r_b, single.r_c,
                                                            single.input_evals)
    assert tuple(case.proof.input_proof.opened_evals) == single.input_evals


def test_mesh_proof_verifies_and_refuses_a_tampered_one(case):
    assert gkr.verify(case.proof, case.circuit)
    bad = ser.decode_gkr_proof(ser.encode_gkr_proof(case.proof), device="cpu")
    coeffs = bad.proof_polynomials[2][1].coefficients
    coeffs[0] = (coeffs[0] + 1) % BLS12_381_FR.modulus
    assert not gkr.verify(bad, case.circuit)
