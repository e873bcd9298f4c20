"""``run.py`` run as its command line says: without a card it exits with 2 and prints
no result; on a card, a short run of each cell is correct and prints the
result line."""

import json
import os
import subprocess
import sys

import pytest

from zkbench.harness import catalog

ROOT = catalog.ROOT
CELLS = [w["name"] for w in catalog.load_benchmark()["workloads"]]


def _run(cell, seconds, trace, env=None):
    cmd = [sys.executable, "zkbench/run.py", "--workload", cell, "--seed", str(2**31 + 17),
           "--seconds", str(seconds), "--trace", str(trace)]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1200,
                          env=dict(os.environ, **(env or {})))


def test_without_a_card_no_result():
    res = _run(CELLS[0], 1, 0, env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert "needs 1 CUDA card" in res.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, cell, trace):
    res = _run(cell, 3, trace)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert res.stderr.strip().splitlines()[-1].startswith("mismatched_values 0 limit 0")
