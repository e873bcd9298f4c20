"""The port's recorder (``zktpu_torch.utils.tracker``): spans, work records
and fetches of a GKR proof, on the CPU.

The proof is the smallest the KZG tests prove (one MUL gate, two inputs,
``test_torch_gkr_kzg.py``'s ``one_gate``), through ``gkr.prove`` with its KZG
input proof. Its window combines run the host curve's Horner chain in place of
``horner_groups_plain``, whose eager chain of 256 - c doublings takes some 9 s
a launch on the CPU (``test_torch_msm_kernels.py`` holds that chain); the
wrapper ``horner_groups`` still runs and records its launch.
"""

import time

import pytest
import torch

from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.gkr import fused_lazy
from zktpu_torch.gkr import kernels as gk
from zktpu_torch.gkr import protocol as gkr
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit
from zktpu_torch.msm import kernels as mk
from zktpu_torch.utils import roofline as rl
from zktpu_torch.utils import tracker

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
ONE_GATE = ([[MUL]], [3, 4], [5])
THREE_LAYERS = [[ADD, ADD, ADD, ADD], [MUL, ADD], [ADD]], [5, 2, 2, 4, 10, 0, 3, 3]


def host_horner_groups(groups):
    """``horner_groups_plain``'s group elements by the host curve."""
    out = []
    for per_window, c in groups:
        segments, windows = per_window[0].shape[:2]
        points = dc.unpack_points(tuple(v.reshape(segments * windows, -1) for v in per_window))
        sums = []
        for s in range(segments):
            row = points[s * windows:(s + 1) * windows]
            acc = row[-1]
            for w in range(windows - 2, -1, -1):
                for _ in range(c):
                    acc = hc.double(acc) if acc is not None else None
                acc = hc.add(acc, row[w])
            sums.append(acc)
        out.append(dc.pack_points(sums, per_window[0].device))
    return out


@pytest.fixture(autouse=True)
def recorder_off_after():
    yield
    tracker.record(False)
    tracker.reset()


def recorded_proof():
    """(records, wall ns) of one recorded ``gkr.prove`` of the one-gate circuit."""
    structure, inputs, taus = ONE_GATE
    circuit = Circuit(ctx, structure)
    tracker.reset()
    tracker.record(True)
    try:
        start = time.time_ns()
        gkr.prove(circuit, inputs, taus=taus)
        wall = time.time_ns() - start
    finally:
        tracker.record(False)
    return tracker.records(), wall


_proofs = []


@pytest.fixture
def proofs(monkeypatch):
    """Two recorded proofs, made once for the module."""
    monkeypatch.setattr(mk, "horner_groups_plain", host_horner_groups)
    while len(_proofs) < 2:
        _proofs.append(recorded_proof())
    return _proofs


def children(spans, parent):
    _, start, end, depth = parent
    return [s for s in spans if s[3] == depth + 1 and start <= s[1] and s[2] <= end]


def test_prove_stages_partition_the_proof(proofs):
    records, wall = proofs[0]
    spans = sorted(records["spans"], key=lambda s: (s[1], s[3]))
    top = [s for s in spans if s[3] == 0]
    assert [s[0] for s in top] == [
        "gkr.inputs", "gkr.evaluate", "gkr.absorb", "gkr.tables", "gkr.sumcheck", "gkr.evals",
        "kzg.srs", "kzg.open", "kzg.open", "kzg.commit_msm", "kzg.unpack",
        "kzg.quotients", "kzg.quotients", "kzg.quotient_msms", "kzg.unpack"]
    for a, b in zip(top, top[1:]):
        assert a[1] <= a[2] <= b[1]
    assert sum(end - start for _, start, end, _ in top) >= 0.9 * wall
    for s in spans:
        if s[3] > 0:  # inside exactly one span a level up
            assert len([p for p in spans if p[3] == s[3] - 1 and p[1] <= s[1]
                        and s[2] <= p[2]]) == 1
    named = {s[0]: s for s in top}
    assert [c[0] for c in children(spans, named["gkr.inputs"])] == ["field.pack", "field.upload"]
    assert [c[0] for c in children(spans, named["gkr.sumcheck"])] == [
        "gkr.tables", "gkr.phase", "gkr.fetch", "gkr.replay"] * 2
    assert [c[0] for c in children(spans, named["kzg.srs"])] == [
        "kzg.srs.eq", "kzg.srs.comb", "kzg.srs.g2"]
    assert len(spans) == len(top) + 2 + 8 + 3
    # a phase a record, a launch a record: the commitment's MSM, then the
    # quotients' (each a compaction round and its densify, then one combine)
    assert [w[1] for w in records["work"]] == (
        ["gkr_phase"] * 2 + (["run_scan", "compact_add"] * 2 + ["horner"]) * 2)


def test_fetch_count_of_a_proof_repeats(proofs):
    counts = []
    for records, _ in proofs:
        sites = {}
        for _, site, nbytes in records["fetches"]:
            n, b = sites.get(site, (0, 0))
            sites[site] = (n + 1, b + nbytes)
        counts.append(sites)
    assert counts[0] == counts[1]
    assert set(counts[0]) == {"tensor_to_words", "pippenger.longest"}
    assert counts[0]["pippenger.longest"] == (2, 8)  # a window group an MSM


def test_nothing_is_recorded_when_off():
    tracker.reset()
    structure, inputs = THREE_LAYERS
    tracker.record(False)
    gkr.prove_layers(Circuit(ctx, structure), inputs)
    assert tracker.records() == {"spans": [], "work": [], "fetches": []}
    assert tracker.span("gkr.tables") is tracker.span("kzg.srs")  # one shared no-op


def expected_phase_work(size: int, ones: bool):
    """A phase's least work, from the cost model's per-round parts."""
    product, elem = rl.cios_lane_ops(8), rl.elem_bytes(8)
    rounds = rl.gkr_tail_sizes(size, False)
    ops = 0
    for k, (n, fold) in enumerate(rounds):
        ops += rl.gkr_step_cost(n, fold)[1]
        ops += rl.round_step_cost(3, 4 if fold else 0, first=k == 0)[1]
        if ones and fold:  # the ones table's fold and its three products an index
            ops -= (n // 2 + 3 * n // 4) * product
        elif ones:
            ops -= 3 * (n // 2) * product
    nbytes = 4 * size * elem + len(rounds) * (3 * elem + 25 * 8)
    floor_ns = len(rounds) * rl.one_thread_ms(rl.round_step_cost(3)[1]) * 1e6
    return nbytes, ops, floor_ns


@pytest.mark.parametrize("tail_max", [2, 1 << 16])
def test_phase_work_is_the_cost_model_whatever_the_split(monkeypatch, tail_max):
    """Each phase records the same least work whether ``TAIL_MAX`` runs it
    as big rounds and a tail or as a tail alone."""
    monkeypatch.setattr(fused_lazy, "TAIL_MAX", tail_max)
    big_rounds = []
    launched = gk.gkr_big_round
    monkeypatch.setattr(gk, "gkr_big_round",
                        lambda *a, **k: big_rounds.append(1) or launched(*a, **k))
    structure, inputs = THREE_LAYERS
    tracker.reset()
    tracker.record(True)
    gkr.prove_layers(Circuit(ctx, structure), inputs)
    tracker.record(False)
    work = [w[1:] for w in tracker.records()["work"]]
    # the walk's layers read tables of 2, 4 and 8 entries; phase 1 holds the ones
    want = [("gkr_phase", *expected_phase_work(size, ones))
            for size in (2, 4, 8) for ones in (True, False)]
    assert work == want
    assert len(big_rounds) == (0 if tail_max > 8 else 4 + 2)
