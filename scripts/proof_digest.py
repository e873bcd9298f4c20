#!/usr/bin/env python3
"""Keccak-256 of the serialized sumcheck proof of the seed-0 benchmark table.

Runs the port's fused prover on the CPU (the plain PyTorch path, which the tests
pin to the JAX package word for word) over the table that ``chip_smoke.py``
proves on the card, and prints the digest that ``chip_smoke.py`` stores as
``PROOF_DIGEST_2E20``. The card's proof must hash to the same value.

    python3 scripts/proof_digest.py [--num-vars 20]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BN254_FQ  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402
from zktpu_torch.sumcheck import fused  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-vars", type=int, default=20)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    ctx = fb.get_ctx(BN254_FQ, device="cpu")
    poly = MultilinearPoly.from_ints(ctx, chip_smoke.benchmark_values(args.num_vars))
    t0 = time.time()
    proof = fused.prove(poly)
    print(f"num_vars={args.num_vars} cpu prove {time.time() - t0:.1f}s", file=sys.stderr)
    print(chip_smoke.proof_digest(BN254_FQ, proof))
    return 0


if __name__ == "__main__":
    sys.exit(main())
