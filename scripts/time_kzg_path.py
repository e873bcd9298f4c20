#!/usr/bin/env python3
"""The whole 2^20-input GKR proof with its KZG input proof, timed alone.

Run on a machine with one CUDA device, from the root of a tree of the repo:

    python3 scripts/time_kzg_path.py

It is ``chip_smoke.py``'s phase 10 without the other phases: one first
``gkr.protocol.prove`` of the 2^20-input halving circuit (its launch counts and
the input proof's digest printed), then, through the tree's own
``chip_smoke.phase_kzg_times``, three warm proves, the stages of ``prove`` one
by one, each quotient step's MSM and the verifier's times. Host-clock times
differ between machines by over 2x, so to compare two trees, copy this script
into both and run it from each, one after the other on one card, in the order
A, B, B, A.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zktpu_torch import _build  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FR  # noqa: E402
from zktpu_torch.gkr import protocol as gkr  # noqa: E402
from zktpu_torch.gkr.circuit import Circuit  # noqa: E402
from zktpu_torch.msm import fixed_base  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kzg_path: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    cs.say(f"tree {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}")
    cs.say(cs.gpu_line())
    _build.build_cuda_libraries(list(cs.CUDA_STEMS))
    n = cs.GKR_NUM_VARS
    ctx = fb.get_ctx(BLS12_381_FR)
    structure, inputs = cs.gkr_benchmark(n)
    circuit = Circuit(ctx, structure)
    taus = cs.gkr_benchmark_taus(n)
    fixed_base._comb_table(ctx.device)
    cs.reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    proof = gkr.prove(circuit, inputs, taus=taus)
    torch.cuda.synchronize()
    cs.say(f"  first prove {time.time() - t0:.3f}s; launches {cs.all_launches()}; "
           f"input proof digest {cs.kzg_proof_digest(proof.input_proof)}")
    cs.phase_kzg_times(ctx, circuit, inputs, proof, taus)
    cs.say(f"total {time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
