"""The plain sumcheck's reference (``reference/sumcheck.py``) agrees with the
port's fused prover on the CPU, value for value, at 2^1-2^10 entries and on
tables of p - 1; the native Keccak (``reference/keccak_native.py``) agrees with
the plain Python one at every length from 0 to 600 bytes and on 64 KB."""

import random

import pytest
import torch

from zkbench.generators import sumcheck_fresh
from zkbench.harness.compare import mismatches
from zkbench.reference import keccak, keccak_native
from zkbench.reference import sumcheck as reference
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BN254_FQ
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import fused

torch.set_num_threads(1)

ctx = fb.get_ctx(BN254_FQ, "cpu")
CONFIG = {"num_vars": 0, "input_bits": 62}


def port_values(values):
    """The port's proof of a table born on the device, as the reference names
    its values."""
    table = MultilinearPoly.from_ints(ctx, values).table
    return sumcheck_fresh.proof_values(fused.prove(MultilinearPoly(ctx, table)))


def test_modulus_is_bn254_fq():
    assert reference.FQ == BN254_FQ.modulus


@pytest.mark.parametrize("num_vars", range(1, 11))
def test_reference_equals_the_port(num_vars):
    values = sumcheck_fresh.draw_table(dict(CONFIG, num_vars=num_vars), 2**31 + num_vars, 0)
    want = reference.prove(values, "cpu")
    assert len(want["round_polys"]) == num_vars
    assert port_values(values) == want


@pytest.mark.parametrize("num_vars", [1, 6])
def test_tables_of_p_minus_one(num_vars):
    values = [reference.FQ - 1] * (1 << num_vars)
    want = reference.prove(values, "cpu")
    assert want["claimed_sum"] == (reference.FQ - 1) * (1 << num_vars) % reference.FQ
    assert port_values(values) == want


def test_the_claim_left_out_changes_every_round_after_the_first():
    values = sumcheck_fresh.draw_table(dict(CONFIG, num_vars=5), 3, 0)
    want, got = reference.prove(values, "cpu"), reference.prove(values, "cpu", bind_claim=False)
    assert got["round_polys"][0] == want["round_polys"][0]
    assert mismatches(got, want) == 2 * 4


def test_native_keccak_of_nothing():
    assert keccak_native.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


def test_native_keccak_at_every_length_to_600():
    rnd = random.Random(600)
    data = bytes(rnd.randrange(256) for _ in range(600))
    for n in range(601):
        assert keccak_native.keccak256(data[:n]) == keccak.keccak256(data[:n]), n


def test_native_keccak_on_64_kb_and_the_transcript():
    rnd = random.Random(64)
    data = bytes(rnd.randrange(256) for _ in range(1 << 16))
    assert keccak_native.keccak256(data) == keccak.keccak256(data)
    plain, native = keccak.Transcript(reference.FQ), keccak_native.Transcript(reference.FQ)
    for t in (plain, native):
        t.append(data[:1000])
        t.append_field_elements([5, reference.FQ - 1])
    assert [plain.challenge(), plain.challenge()] == [native.challenge(), native.challenge()]
    assert native.pending == plain.pending
