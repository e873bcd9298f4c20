"""A whole run, without the look for a card, at a small size on the CPU: sound,
its ``correct`` is true; with the timed path broken underneath, false. The
faults: a step that returns its state unchanged (the previous call's answer,
or the input), half of the work left out, an answer altered where it is
produced. Both cells run on one chip, so no exchange between chips can be
left out. And the controls, at a small size, read above their limits."""

import time

import pytest
import torch

from zkbench.generators import gkr_prove, ntt_pairs
from zkbench.harness import catalog, runner
from zktpu_torch.gkr import protocol
from zktpu_torch.ntt import ntt as port_ntt

torch.set_num_threads(1)
SEED = 2**31 + 99


def _cell(name, **config):
    cell = catalog.find_cell(catalog.load_benchmark(), name)
    cell.config.update(config)
    return cell


def _run(cell, trace=False):
    return runner.run(cell, SEED, 0.3, trace, "cpu", time.time(), log=lambda m: None)


def _gkr_cell():
    return _cell("gkr2e20.kzg_prove", num_vars=3, num_layers=3)


def _ntt_cell():
    return _cell("ntt2e22.fwd_inv", log_n=6)


@pytest.mark.parametrize("make", [_gkr_cell, _ntt_cell])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(make, trace):
    result = _run(make(), trace)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 for c in result["checks"].values())
    if not trace:
        assert set(result["metrics"]) >= {"setup_s"}


def _previous_answer(real):
    last = []

    def broken(*args, **kwargs):
        answer = real(*args, **kwargs)
        last.append(answer)
        return last[-2] if len(last) > 1 else answer

    return broken


def _gkr_half_inputs(real):
    def broken(circuit, inputs, *args, **kwargs):
        half = len(inputs) // 2
        return real(circuit, list(inputs[:half]) + [0] * (len(inputs) - half), *args, **kwargs)

    return broken


def _bump(x):
    return (x + 1) % protocol.FR.modulus


def _alter_round_poly(proof):
    poly = proof.proof_polynomials[-1][-1]
    poly.coefficients[0] = _bump(poly.coefficients[0])


def _alter_opened(proof):
    proof.input_proof.opened_evals[0] = _bump(proof.input_proof.opened_evals[0])


def _alter_commitment(proof):
    proof.input_proof.commitment = proof.input_proof.proof[0][0]


def _alter_quotient(proof):
    quotients = proof.input_proof.proof[1]
    quotients[-1] = proof.input_proof.commitment


def _gkr_altered(alter):
    def fault(real):
        def broken(*args, **kwargs):
            proof = real(*args, **kwargs)
            alter(proof)
            return proof

        return broken

    fault.__name__ = alter.__name__
    return fault


@pytest.mark.parametrize("fault", [
    _previous_answer, _gkr_half_inputs, _gkr_altered(_alter_round_poly),
    _gkr_altered(_alter_opened), _gkr_altered(_alter_commitment),
    _gkr_altered(_alter_quotient)], ids=lambda f: f.__name__)
def test_gkr_faults_are_not_correct(monkeypatch, fault):
    monkeypatch.setattr(protocol, "prove", fault(protocol.prove))
    result = _run(_gkr_cell())
    assert result["correct"] is False and result["checks"]["mismatched_values"]["value"] > 0


def _ntt_unchanged(real):
    return lambda ctx, table, inverse=False: table.clone()


def _ntt_half(real):
    def broken(ctx, table, inverse=False):
        out = real(ctx, table, inverse)
        half = table.shape[0] // 2
        out[half:] = table[half:]
        return out

    return broken


def _ntt_altered(real):
    def broken(ctx, table, inverse=False):
        out = real(ctx, table, inverse)
        out[3, 0] ^= 1
        return out

    return broken


@pytest.mark.parametrize("fault", [_ntt_unchanged, _ntt_half, _ntt_altered])
def test_ntt_faults_are_not_correct(monkeypatch, fault):
    monkeypatch.setattr(port_ntt, "ntt", fault(port_ntt.ntt))
    result = _run(_ntt_cell())
    assert result["correct"] is False and result["checks"]["mismatched_values"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_controls_read_above_their_limits(seed):
    for make, generator in ((_gkr_cell, gkr_prove), (_ntt_cell, ntt_pairs)):
        cell = make()
        for name, value, limit in generator.control(cell.config, cell.mix, seed, "cpu"):
            assert value > limit, (cell.name, name, value)
