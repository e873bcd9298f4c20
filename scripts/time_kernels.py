#!/usr/bin/env python3
"""`gkr_round` and `ntt_phase1` timed alone, to compare trees on one card.

Run on a machine with one CUDA device, from the root of a tree of the repo:

    python3 scripts/time_kernels.py TAG

It prints, on lines that start with TAG:

  * ``gkr_round`` at every size from 2 to 2^24 entries (a BLS12-381 Fr stack):
    the device microseconds of one call by ``torch.profiler``, the kernel and
    its ``finish_rows`` pass apart (at real widths most calls are small, where
    a launch's latency is its time and CUDA events would time the host); the
    rows are held against the plain version up to 2^16;
  * ``ntt_phase1`` at a 1024-entry tile on 2^20 and 2^22 BN254 Fr entries, and
    ``point_add`` / ``point_double`` on 2^20 lanes: median milliseconds of 20
    launches by CUDA events, L2 flushed before each; ``ntt_phase1`` is held
    against its plain version at 2^12, every tile, first.
  * the registers ``nvcc`` gave ``ntt_phase1`` and ``gkr_round``.

To compare two trees, copy this script into both and run it from each, one
after the other in one call on one card, in the order A, B, B, A.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zktpu_torch import _build  # noqa: E402
from zktpu_torch.curve import point_kernels as pk  # noqa: E402
from zktpu_torch.field import kernels as fk  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FR  # noqa: E402
from zktpu_torch.ntt import ntt_kernels as nk  # noqa: E402

RUNS = 20


def gkr_round_sizes(tag: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    ctx = fb.get_ctx(BLS12_381_FR)
    rng = np.random.default_rng(0)
    line = []
    for k in range(1, 25):
        stack = cs.random_table(ctx, rng, 2, 2, 1 << k)
        got = fk.gkr_round(ctx, stack)
        if k <= 16:
            cs.check(torch.equal(got, fk.gkr_round_plain(ctx, stack)),
                     f"gkr_round differs from its plain version at 2^{k}")
        torch.cuda.synchronize()
        reps = 50 if k <= 16 else 10
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fk.gkr_round(ctx, stack)
            torch.cuda.synchronize()
        kernel = finish = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA":
                if "gkr_round_kernel" in e.name():
                    kernel += e.duration_ns()
                elif "finish_rows_kernel" in e.name():
                    finish += e.duration_ns()
        line.append(f"2^{k} {kernel / reps / 1e3:.2f}+{finish / reps / 1e3:.2f}")
        del stack
    print(f"{tag} gkr_round us (kernel+finish_rows): " + ", ".join(line), flush=True)


def ntt_and_points(tag: str) -> None:
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    rctx = fb.get_ctx(BN254_FR)
    rng = np.random.default_rng(1)
    x = cs.random_table(rctx, rng, 1 << 12)
    tw = nk.stage_twiddles(rctx, 12, False)
    plain = nk.ntt_phase1_plain(rctx, x, tw, 0)
    for log_tile in range(nk.LOG_TILE + 1):
        if log_tile:
            plain = nk.ntt_stage_plain(rctx, plain, tw, log_tile)
        cs.check(torch.equal(nk.ntt_phase1(rctx, x, tw, log_tile), plain),
                 f"ntt_phase1 differs from its plain version at tile 2^{log_tile}")
    out = []
    for log_n in (20, 22):
        x = cs.random_table(rctx, rng, 1 << log_n)
        tw = nk.stage_twiddles(rctx, log_n, False)
        ms = cs.time_events(lambda: nk.ntt_phase1(rctx, x, tw, nk.LOG_TILE), RUNS, flush)
        out.append(f"ntt_phase1 2^{log_n} {ms:.4f} ms")
    fq = fb.get_ctx(BLS12_381_FQ)
    n = 1 << 20
    p1, p2 = cs.random_points(rng, n, fq.device), cs.random_points(rng, n, fq.device)
    out.append(f"point_add 2^20 {cs.time_events(lambda: pk.point_add(fq, p1, p2), RUNS, flush):.4f} ms")
    out.append(f"point_double 2^20 {cs.time_events(lambda: pk.point_double(fq, p1), RUNS, flush):.4f} ms")
    print(f"{tag} " + "; ".join(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage, on a machine with a CUDA device: time_kernels.py TAG", file=sys.stderr)
        return 1
    tag = sys.argv[1]
    _build.build_cuda_libraries(["sumcheck_kernels", "point_kernels", "ntt_kernels"])
    fk.library()
    nk.library()
    pk.library()
    usage = []
    for stem, needle in (("ntt_kernels", "ntt_phase1_kernel"), ("sumcheck_kernels", "gkr_round_kernel")):
        usage += cs.resource_usage(_build.build_log[stem], needle)
    print(f"{tag} " + " | ".join(usage), flush=True)
    gkr_round_sizes(tag)
    ntt_and_points(tag)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
