#!/usr/bin/env python3
"""The unbatched NTT timed alone, to compare trees on one card.

Run on a machine with one CUDA device, from the root of a tree of the repo:

    python3 scripts/time_ntt.py TAG

It prints, on lines that start with TAG, for BN254 Fr tables of 2^20 and 2^22
entries (``chip_smoke.ntt_benchmark``: numpy seed 0): ``ntt.ntt`` forward and
inverse, ``ntt_phase1`` at a 1024-entry tile, and the mean of the transform's
``ntt_stage`` passes; median milliseconds of 10 calls by CUDA events, L2
flushed before each, as ``chip_smoke.py`` phase 13 times them. The forward
transform is checked against the tree's plain versions at 2^12 first. To
compare two trees, copy this script into both and run it from each, one after
the other in one call on one card, in the order A, B, B, A.
"""

from __future__ import annotations

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zktpu_torch import _build  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BN254_FR  # noqa: E402
from zktpu_torch.ntt import ntt as tn  # noqa: E402
from zktpu_torch.ntt import ntt_kernels as nk  # noqa: E402

RUNS = 10


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage, on a machine with a CUDA device: time_ntt.py TAG", file=sys.stderr)
        return 1
    tag = sys.argv[1]
    _build.build_cuda_libraries(["sumcheck_kernels", "ntt_kernels"])
    ctx = fb.get_ctx(BN254_FR)
    cpu = fb.get_ctx(BN254_FR, device="cpu")
    x = cs.random_table(ctx, np.random.default_rng(10), 1 << 12)
    cs.check(torch.equal(tn.ntt(ctx, x).cpu(), tn.ntt(cpu, x.cpu())),
             "2^12 ntt on the card differs from the plain versions")
    flush = torch.empty(256 << 20, dtype=torch.int8, device=ctx.device)
    for log_n in cs.NTT_LOG_SIZES:
        x = cs.ntt_benchmark(ctx, log_n)[0]
        tw = nk.stage_twiddles(ctx, log_n, False)
        fwd = cs.time_events(lambda: tn.ntt(ctx, x), RUNS, flush)
        inv = cs.time_events(lambda: tn.ntt(ctx, x, inverse=True), RUNS, flush)
        phase1 = cs.time_events(lambda: nk.ntt_phase1(ctx, x, tw, nk.LOG_TILE), RUNS, flush)
        stages = [cs.time_events(lambda: nk.ntt_stage(ctx, x, tw, s), RUNS, flush)
                  for s in range(nk.LOG_TILE + 1, log_n + 1)]
        print(f"{tag} 2^{log_n}: ntt forward {fwd:.4f} ms, inverse {inv:.4f} ms; ntt_phase1 "
              f"{phase1:.4f} ms, ntt_stage mean {statistics.fmean(stages):.4f} ms", flush=True)
    print(f"{tag} {cs.gpu_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
