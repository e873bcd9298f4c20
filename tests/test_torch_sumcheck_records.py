"""The plain fused sumcheck's records (``sumcheck/fused.py`` under
``tracker.record(True)``), on the CPU: the proof is the same byte for byte with
recording on and off; a proof records four spans, none inside another, and one
``sumcheck_round`` work record a round, priced by ``utils.roofline``.

Tables are born on the device (``MultilinearPoly(ctx, table)``, no cached
canonical words or sponge), as a prover's table from an earlier device stage is.
"""

import random

import pytest
import torch

from zktpu_torch import serialize
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BN254_FQ
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import fused
from zktpu_torch.utils import roofline as rl
from zktpu_torch.utils import tracker

torch.set_num_threads(1)

ctx = fb.get_ctx(BN254_FQ, device="cpu")
P = BN254_FQ.modulus
SPANS = ["sumcheck.claim", "sumcheck.absorb", "sumcheck.rounds", "sumcheck.fetch"]


@pytest.fixture(autouse=True)
def recorder_off_after():
    yield
    tracker.record(False)
    tracker.reset()


def device_table(values):
    """A table on the device with nothing of its host words kept."""
    return MultilinearPoly.from_ints(ctx, values).table


def draw(num_vars, seed):
    rnd = random.Random(seed)
    return [rnd.randrange(1 << 62) for _ in range(1 << num_vars)]


def proved(table, record):
    tracker.reset()
    tracker.record(record)
    proof = fused.prove(MultilinearPoly(ctx, table))
    tracker.record(False)
    return serialize.encode_sumcheck_proof(proof, BN254_FQ), tracker.records()


@pytest.mark.parametrize("values", [draw(1, 1), draw(5, 2), draw(9, 3), [P - 1] * 64],
                         ids=["2^1", "2^5", "2^9", "p-1 x 2^6"])
def test_recorded_proof_is_the_unrecorded_one(values):
    table = device_table(values)
    off, nothing = proved(table, False)
    on, found = proved(table, True)
    assert on == off
    assert nothing == {"spans": [], "work": [], "fetches": []}
    assert found["spans"] and found["work"]


@pytest.mark.parametrize("num_vars", [1, 4, 7])
def test_four_spans_a_proof_none_inside_another(num_vars):
    table = device_table(draw(num_vars, num_vars))
    tracker.record(True)
    for _ in range(2):
        fused.prove(MultilinearPoly(ctx, table))
    spans = tracker.records()["spans"]
    assert [s[0] for s in spans] == SPANS * 2
    assert all(depth == 0 for _, _, _, depth in spans)
    edges = [t for _, start, end, _ in spans for t in (start, end)]
    assert edges == sorted(edges)


@pytest.mark.parametrize("num_vars", [1, 3, 10])
def test_one_work_record_a_round_priced_by_the_roofline(num_vars):
    table = device_table(draw(num_vars, 7 * num_vars))
    _, found = proved(table, True)
    work = found["work"]
    assert [w[1] for w in work] == ["sumcheck_round"] * num_vars
    (queued,) = [s for s in found["spans"] if s[0] == "sumcheck.rounds"]
    assert all(queued[1] <= w[0] <= queued[2] for w in work)

    # the uploaded tail: the table's bytes and the claimed sum past the last
    # whole block, in lanes
    tail = (32 * ((1 << num_vars) + 1)) % 136 // 8
    first_step = rl.round_step_cost(2, tail, first=True)
    steady_step = rl.round_step_cost(2)
    want = [(rl.halves_sums_cost(1 << num_vars, 8), first_step)]
    want += [(rl.fold_and_halves_cost(1 << (num_vars - k + 1), 8), steady_step)
             for k in range(1, num_vars)]
    for (_, _, nbytes, ops, floor_ns), (kernel, step) in zip(work, want):
        assert (nbytes, ops) == (kernel[0] + step[0], kernel[1] + step[1])
        assert floor_ns == pytest.approx(rl.one_thread_ms(step[1]) * 1e6)
