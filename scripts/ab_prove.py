#!/usr/bin/env python3
"""The warm 2^20 sumcheck prove + verify of two trees, in one process.

Run on a machine with one CUDA device, from the root of a tree of the repo:

    python3 scripts/ab_prove.py OTHER_TREE [--pairs 100]

OTHER_TREE is the root of another tree of the repo (say the parent commit,
unpacked with ``git archive`` into a ``.tmp_*`` directory, which git ignores).
Its ``zktpu_torch`` package is imported beside this tree's under another name,
and the two provers run in turns, the order swapped every pair, on
``chip_smoke.py``'s benchmark table: each pair's two runs share the host's
drift, which between processes is wider than the difference a kernel change
can make (the prover is bound by its host's launches). It prints each tree's
median, quartiles and minimum (host clock, synchronised), the median of the
pairs' ratios (this tree's time over the other's) with its 95 % interval from
order statistics (distribution-free: the pairs' order of 0.5 either way), how
many pairs this tree won, and the host microseconds of one ``halves_sums`` and
one ``fold_and_halves`` wrapper call of each tree (on 2^4- and 2^16-entry
tables, where the host, not the card, sets the time).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import math
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

OTHER = "zktpu_torch_other"


def load(pkg: str) -> dict:
    """Build the tree's sumcheck kernels and make its benchmark polynomial."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    mod("_build").build_cuda_libraries(["sumcheck_kernels"])
    ctx = mod("field.torch_backend").get_ctx(mod("field.spec").BN254_FQ)
    poly = mod("poly.multilinear").MultilinearPoly.from_ints(ctx, cs.benchmark_values(cs.NUM_VARS))
    fused, protocol = mod("sumcheck.fused"), mod("sumcheck.protocol")
    cs.check(protocol.verify(poly, fused.prove(poly)), f"{pkg}: verify refused the proof")
    return {"ctx": ctx, "poly": poly, "fused": fused, "protocol": protocol,
            "fk": mod("field.kernels")}


def prove_verify_s(tree: dict) -> float:
    gc.collect()
    t0 = time.time()
    ok = tree["protocol"].verify(tree["poly"], tree["fused"].prove(tree["poly"]))
    torch.cuda.synchronize()
    cs.check(ok, "verify refused the proof")
    return time.time() - t0


def median_interval(xs: list[float], level: float = 0.95) -> tuple[float, float, float]:
    """The median of ``xs`` and a ``level`` interval for it from order
    statistics: [x_(k), x_(n + 1 - k)], k the largest with P(B < k) at most
    (1 - level) / 2, B binomial(n, 1/2)."""
    xs = sorted(xs)
    n, tail = len(xs), (1 - level) / 2
    k, below = 0, 0.0
    while below + math.comb(n, k) / 2 ** n <= tail:
        below += math.comb(n, k) / 2 ** n
        k += 1
    lo, hi = (xs[k - 1], xs[n - k]) if k else (xs[0], xs[-1])
    return statistics.median(xs), lo, hi


def wrapper_us(tree: dict, table, calls: int = 2000) -> dict[str, float]:
    ctx, fk = tree["ctx"], tree["fk"]
    r = table[0].clone()
    out = {}
    for name, fn in (("halves_sums", lambda: fk.halves_sums(ctx, table)),
                     ("fold_and_halves", lambda: fk.fold_and_halves(ctx, table, r))):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.time() - t0) / calls * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--pairs", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_prove: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as links:
        os.symlink(os.path.join(os.path.abspath(args.other), "zktpu_torch"),
                   os.path.join(links, OTHER))
        sys.path.insert(0, links)
        trees = {"other": load(OTHER), "this": load("zktpu_torch")}
        times = {name: [] for name in trees}
        for i in range(args.pairs):
            for name in ("other", "this") if i % 2 == 0 else ("this", "other"):
                times[name].append(prove_verify_s(trees[name]))
        for name, t in times.items():
            q = statistics.quantiles(t, n=4)
            print(f"{name}: warm 2^{cs.NUM_VARS} prove + verify s, {args.pairs} in turns: median "
                  f"{statistics.median(t):.4f}, quartiles {q[0]:.4f} / {q[2]:.4f}, "
                  f"min {min(t):.4f}", flush=True)
        ratio, lo, hi = median_interval([a / b for a, b in zip(times["this"], times["other"])])
        wins = sum(a < b for a, b in zip(times["this"], times["other"]))
        print(f"this / other, a pair's ratio: median {ratio:.4f}, 95 % interval {lo:.4f} - "
              f"{hi:.4f}; this tree faster in {wins} of {args.pairs} pairs", flush=True)
        for log_size in (4, 16):
            for rep in range(2):
                for name in ("other", "this") if rep == 0 else ("this", "other"):
                    table = cs.random_table(trees[name]["ctx"], np.random.default_rng(log_size),
                                            1 << log_size)
                    us = wrapper_us(trees[name], table)
                    print(f"{name} 2^{log_size}: host us a wrapper call: "
                          + ", ".join(f"{k} {v:.1f}" for k, v in us.items()), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
