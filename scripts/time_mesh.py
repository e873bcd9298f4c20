#!/usr/bin/env python3
"""The mesh paths of ``chip_smoke.py`` phase 16 on the mesh of every card.

Run on a machine with one or more CUDA devices, from the root of the repo:

    python3 scripts/time_mesh.py

It builds the kernels, makes on the first card what phase 16 takes from the
earlier phases (the seed-0 2^20 BN254 Fq sumcheck proof, the whole proof of the
2^20-input benchmark circuit and its bytes, the 2^20 and 2^22 NTTs of
``chip_smoke.ntt_benchmark``), then on ``make_mesh()`` (one slot a card) checks
``sumcheck_prove_sharded``, ``ntt_sharded``, ``msm_pippenger_sharded``, the
ladder ``msm_sharded`` and ``gkr.prove(mesh=...)`` against them (the proof's
bytes, twice) and ``dryrun_multichip``, and prints the launches of each kernel.
It times nothing. Any mismatch exits non-zero.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zktpu_torch import _build  # noqa: E402
from zktpu_torch import serialize as ser  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ, BN254_FR  # noqa: E402
from zktpu_torch.ntt import ntt as tn  # noqa: E402
from zktpu_torch.parallel import mesh as pm  # noqa: E402
from zktpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402
from zktpu_torch.sumcheck import fused  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_mesh.py needs a CUDA device", file=sys.stderr)
        return 1
    print(f"{cs.gpu_line()}; {torch.cuda.device_count()} cards", flush=True)
    _build.build_cuda_libraries(list(cs.CUDA_STEMS))
    ctx, gctx, rctx = (fb.get_ctx(s) for s in (BN254_FQ, BLS12_381_FR, BN254_FR))
    proof = fused.prove(MultilinearPoly.from_ints(ctx, cs.benchmark_values(cs.NUM_VARS)))
    structure, inputs = cs.gkr_benchmark(cs.GKR_NUM_VARS)
    taus = cs.gkr_benchmark_taus(cs.GKR_NUM_VARS)
    circuit = cs.Circuit(gctx, structure)
    full = cs.gkr.prove(circuit, inputs, taus=taus)
    blob = ser.encode_gkr_proof(full)
    commitment = full.input_proof.commitment
    del full
    outs = {}
    for log_n in cs.NTT_LOG_SIZES:
        x = cs.ntt_benchmark(rctx, log_n)[0]
        outs[log_n] = (x, tn.ntt(rctx, x))

    mesh = pm.make_mesh()
    print(f"  mesh {mesh}", flush=True)
    cs.reset_all_launches()
    cs.mesh_sumcheck(mesh, ctx, proof)
    cs.mesh_ntt(mesh, rctx, outs)
    cs.mesh_commitment(mesh, gctx, inputs, taus, commitment)
    for _ in range(2):
        cs.check(ser.encode_gkr_proof(cs.gkr.prove(circuit, inputs, taus=taus, mesh=mesh)) == blob,
                 "gkr.prove(mesh=...) does not encode to one card's bytes")
        print(f"  gkr.prove(mesh=...) == one card's {len(blob)} bytes", flush=True)
    dryrun_multichip(mesh)
    print("  dryrun_multichip passes", flush=True)
    print(f"  launches on the mesh's paths: {cs.all_launches()}", flush=True)
    print(f"  {cs.checks_run} checks passed", flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
