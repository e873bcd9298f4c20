#!/usr/bin/env python3
"""Keccak-256 of the proofs that ``chip_smoke.py`` holds the card's against.

Runs the port's provers on the CPU (the plain PyTorch path, which the tests pin
to the JAX package integer for integer) over the inputs that ``chip_smoke.py``
proves on the card, and prints the digest that ``chip_smoke.py`` stores. The
card's proof must hash to the same value.

    python3 scripts/proof_digest.py [--num-vars 20]      # sumcheck: PROOF_DIGEST_2E20
    python3 scripts/proof_digest.py --blob [--num-vars 20]  # its bytes: SUMCHECK_BLOB_DIGEST_2E20
    python3 scripts/proof_digest.py --gkr [--num-vars 16]  # GKR layers: GKR_PROOF_DIGEST_2E16
    python3 scripts/proof_digest.py --kzg [--num-vars 5]   # KZG input proof: KZG_PROOF_DIGEST_2E5
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zktpu_torch import serialize as ser  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ  # noqa: E402
from zktpu_torch.gkr import protocol as gkr  # noqa: E402
from zktpu_torch.gkr.circuit import Circuit  # noqa: E402
from zktpu_torch.hash import keccak as hk  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402
from zktpu_torch.sumcheck import fused  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gkr", action="store_true",
                    help="the GKR layer proof of chip_smoke.gkr_benchmark (default 2^16 inputs)")
    ap.add_argument("--kzg", action="store_true",
                    help="the KZG input proof of the whole GKR proof of chip_smoke.gkr_benchmark "
                         "with chip_smoke.gkr_benchmark_taus (default 2^5 inputs, about 2 minutes)")
    ap.add_argument("--blob", action="store_true",
                    help="Keccak-256 of the sumcheck proof's bytes (serialize.encode_sumcheck_proof) "
                         "in place of its values")
    ap.add_argument("--num-vars", type=int)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.kzg:
        num_vars = args.num_vars or chip_smoke.KZG_DIGEST_INPUTS
        ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
        structure, inputs = chip_smoke.gkr_benchmark(num_vars)
        t0 = time.time()
        proof = gkr.prove(Circuit(ctx, structure), inputs,
                          taus=chip_smoke.gkr_benchmark_taus(num_vars))
        print(f"kzg num_vars={num_vars} cpu prove {time.time() - t0:.1f}s", file=sys.stderr)
        print(chip_smoke.kzg_proof_digest(proof.input_proof))
        return 0
    if args.gkr:
        num_vars = args.num_vars or chip_smoke.GKR_DIGEST_INPUTS
        ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
        structure, inputs = chip_smoke.gkr_benchmark(num_vars)
        t0 = time.time()
        proved = gkr.prove_layers(Circuit(ctx, structure), inputs)
        print(f"gkr num_vars={num_vars} cpu prove_layers {time.time() - t0:.1f}s", file=sys.stderr)
        print(chip_smoke.gkr_proof_digest(BLS12_381_FR, proved))
        return 0
    args.num_vars = args.num_vars or 20
    ctx = fb.get_ctx(BN254_FQ, device="cpu")
    poly = MultilinearPoly.from_ints(ctx, chip_smoke.benchmark_values(args.num_vars))
    t0 = time.time()
    proof = fused.prove(poly)
    print(f"num_vars={args.num_vars} cpu prove {time.time() - t0:.1f}s", file=sys.stderr)
    if args.blob:
        print(hk.keccak256(ser.encode_sumcheck_proof(proof, BN254_FQ)).hex())
    else:
        print(chip_smoke.proof_digest(BN254_FQ, proof))
    return 0


if __name__ == "__main__":
    sys.exit(main())
