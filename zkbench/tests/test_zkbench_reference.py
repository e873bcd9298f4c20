"""The plain references agree with the port's CPU path, value for value: a
2^3- and a 2^6-input GKR proof with its KZG input proof, and the NTT at 2^8
both ways. The port is only read here: the references import nothing of it."""

import random

import numpy as np
import pytest
import torch

from zkbench.generators import gkr_prove, ntt_pairs
from zkbench.harness.compare import mismatches
from zkbench.reference import gkr as rgkr
from zkbench.reference import keccak as rkeccak
from zkbench.reference import ntt as rntt
from zkbench.reference.field import PrimeField
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FR
from zktpu_torch.gkr import protocol
from zktpu_torch.gkr.circuit import Circuit
from zktpu_torch.hash import keccak as port_keccak
from zktpu_torch.ntt.ntt import ntt

torch.set_num_threads(1)


@pytest.mark.parametrize("p", [BLS12_381_FR.modulus, BN254_FR.modulus])
def test_field_against_python_ints(p):
    rnd = random.Random(p)
    F = PrimeField(p, "cpu")
    xs = [rnd.randrange(p) for _ in range(200)] + [0, 1, p - 1, p - 2]
    ys = [rnd.randrange(p) for _ in range(200)] + [p - 1, 0, p - 1, 1]
    a, b = F.from_ints(xs), F.from_ints(ys)
    assert F.to_ints(a) == xs
    assert F.to_ints(F.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.add(a, b)) == [(x + y) % p for x, y in zip(xs, ys)]
    assert F.to_ints(F.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    assert F.sum_int(torch.stack([a, b], dim=1)) == [sum(xs) % p, sum(ys) % p]
    point = [rnd.randrange(p) for _ in range(3)]
    eq = F.to_ints(F.eq_table(point))
    for x in range(8):
        want = 1
        for j, r in enumerate(point):
            want = want * (r if (x >> (2 - j)) & 1 else 1 - r) % p
        assert eq[x] == want
    words = torch.randint(-2**31, 2**31, (40, 8), dtype=torch.int32)
    assert torch.equal(F.to_words(F.from_words(words)), words)


def test_keccak_against_the_port():
    rnd = random.Random(5)
    for n in (0, 1, 135, 136, 137, 300):
        data = bytes(rnd.randrange(256) for _ in range(n))
        assert rkeccak.keccak256(data) == port_keccak.keccak256(data)


@pytest.mark.parametrize("log_n", [1, 4, 8])
def test_ntt_against_the_port(log_n):
    config = {"log_n": log_n, "words": 8,
              "field": {"modulus": str(BN254_FR.modulus), "generator": 5, "two_adicity": 28}}
    table = ntt_pairs.draw_table(config, 2**31 + log_n, 0, "cpu")
    ctx = fb.get_ctx(BN254_FR, "cpu")
    F = PrimeField(BN254_FR.modulus, "cpu")
    for inverse in (False, True):
        assert torch.equal(ntt(ctx, table, inverse), rntt.ntt_words(F, table, 5, 28, inverse))


def test_ntt_reference_is_the_definition():
    p = BN254_FR.modulus
    F = PrimeField(p, "cpu")
    config = {"log_n": 4, "words": 8, "field": {"modulus": str(p)}}
    table = ntt_pairs.draw_table(config, 3, 0, "cpu")
    xs = [sum((int(v) & 0xFFFFFFFF) << (32 * i) for i, v in enumerate(row)) for row in table.tolist()]
    w = rntt.root_of_unity(p, 5, 28, 4)
    out = rntt.ntt_words(F, table, 5, 28)
    got = [sum((int(v) & 0xFFFFFFFF) << (32 * i) for i, v in enumerate(row)) for row in out.tolist()]
    assert got == [sum(x * pow(w, i * j, p) for i, x in enumerate(xs)) % p for j in range(16)]


@pytest.mark.parametrize("num_vars, seed", [(3, 11), (6, 2**31 + 7)])
def test_gkr_proof_with_kzg_against_the_port(num_vars, seed):
    config = {"num_vars": num_vars, "input_bits": 61, "tau_low": 2, "tau_high_bits": 60}
    masks = gkr_prove.draw_circuit(config, seed)
    inputs = gkr_prove.draw_inputs(config, seed, 0)
    taus = gkr_prove.draw_taus(config, seed)
    ctx = fb.get_ctx(BLS12_381_FR, "cpu")
    circuit = Circuit(ctx, [np.where(m, "add", "mul").tolist() for m in masks])
    got = gkr_prove.proof_values(protocol.prove(circuit, inputs, taus=taus))
    want = rgkr.prove(masks, inputs, taus, "cpu")
    assert len(got["quotients"][0]) == num_vars and got["commitment"] is not None
    assert mismatches(got, want) == 0 and got == want
