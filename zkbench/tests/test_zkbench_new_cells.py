"""The layer-walk and plain-sumcheck cells, a whole run each without the look
for a card, at a small size on the CPU: sound, ``correct`` is true; with the
timed path broken underneath (the previous call's answer, an answer altered
where it is produced), false. And their controls read above their limits."""

import time

import pytest
import torch

from zkbench.generators import gkr_walk, sumcheck_fresh
from zkbench.harness import catalog, runner
from zktpu_torch.gkr import protocol
from zktpu_torch.sumcheck import fused

torch.set_num_threads(1)
SEED = 2**33 + 41


def _cell(name, **config):
    cell = catalog.find_cell(catalog.load_benchmark(), name)
    cell.config.update(config)
    return cell


def _walk_cell():
    return _cell("gkr2e20.walk_prove", num_vars=3, num_layers=3)


def _sumcheck_cell():
    return _cell("sumcheck2e20.fresh", num_vars=6)


def _run(cell, trace=False):
    return runner.run(cell, SEED, 0.3, trace, "cpu", time.time(), log=lambda m: None)


@pytest.mark.parametrize("make", [_walk_cell, _sumcheck_cell])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(make, trace):
    result = _run(make(), trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {"mismatched_values": {"value": 0, "limit": 0}}
    if trace:
        want = {m["name"] for m in make().per_layer} - {"device_idle_pct.gkr",
                                                         "sumcheck_round_roofline"}
        assert set(result["metrics"]) == want  # the device numbers need a card
    else:
        assert set(result["metrics"]) == {"setup_s", "prove_s", "peak_device_gb"}


def _previous_answer(real):
    last = []

    def broken(*args, **kwargs):
        last.append(real(*args, **kwargs))
        return last[-2] if len(last) > 1 else last[-1]

    return broken


def _walk_altered(real):
    def broken(*args, **kwargs):
        layers = real(*args, **kwargs)
        poly = layers.proof.proof_polynomials[-1][-1]
        poly.coefficients[0] = (poly.coefficients[0] + 1) % protocol.FR.modulus
        return layers

    return broken


def _sumcheck_altered(real):
    def broken(*args, **kwargs):
        proof = real(*args, **kwargs)
        proof.proof_polynomials[-1][1] ^= 1
        return proof

    return broken


@pytest.mark.parametrize("module, attr, make, fault", [
    (protocol, "prove_layers", _walk_cell, _previous_answer),
    (protocol, "prove_layers", _walk_cell, _walk_altered),
    (fused, "prove", _sumcheck_cell, _previous_answer),
    (fused, "prove", _sumcheck_cell, _sumcheck_altered),
], ids=["walk-previous", "walk-altered", "sumcheck-previous", "sumcheck-altered"])
def test_faults_are_not_correct(monkeypatch, module, attr, make, fault):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    result = _run(make())
    assert result["correct"] is False and result["checks"]["mismatched_values"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_controls_read_above_their_limits(seed):
    for make, generator in ((_walk_cell, gkr_walk), (_sumcheck_cell, sumcheck_fresh)):
        cell = make()
        for name, value, limit in generator.control(cell.config, cell.mix, seed, "cpu"):
            assert value > limit, (cell.name, name, value)
