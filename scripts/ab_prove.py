#!/usr/bin/env python3
"""A warm path of two trees, in one process: the 2^20 sumcheck prove + verify,
the 2^20-input GKR layer walk, or its whole proof.

Run on a machine with one CUDA device, from the root of a tree of the repo:

    python3 scripts/ab_prove.py OTHER_TREE [--path sumcheck|layers|whole] [--pairs 100]

OTHER_TREE is the root of another tree of the repo (say the parent commit,
unpacked with ``git archive`` into a ``.tmp_*`` directory, which git ignores).
Its ``zktpu_torch`` package is imported beside this tree's under another name,
and the two run the path in turns, the order swapped every pair (A B, B A, ...),
on ``chip_smoke.py``'s benchmark inputs: each pair's two runs share the host's
drift, which between processes is wider than the difference a kernel change
can make (the provers are bound by their host's launches). The paths:
``sumcheck`` is phase 4's ``fused.prove`` + ``protocol.verify`` of the 2^20
BN254 Fq table; ``layers`` phase 7's ``prove_layers`` + ``verify_layers`` of
the 2^20-input BLS12-381 Fr circuit; ``whole`` phase 10's ``gkr.prove`` of it
(the verifier's host pairings left out). It prints each tree's median,
quartiles and minimum (host clock, synchronised), the median of the pairs'
ratios (this tree's time over the other's) with its 95 % interval from order
statistics (distribution-free: the pairs' order of 0.5 either way), how many
pairs this tree won, and, for ``sumcheck``, the host microseconds of one
``halves_sums`` and one ``fold_and_halves`` wrapper call of each tree (on 2^4-
and 2^16-entry tables, where the host, not the card, sets the time).
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


def load(pkg: str, path: str) -> dict:
    """Build the tree's kernels and make the path's inputs; run it once."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    build = mod("_build")
    build.build_cuda_libraries([stem for stem in cs.CUDA_STEMS if os.path.exists(
        os.path.join(build.CSRC_DIR, stem + ".cu"))])
    spec = mod("field.spec")
    tree = {"fk": mod("field.kernels")}
    if path == "sumcheck":
        ctx = mod("field.torch_backend").get_ctx(spec.BN254_FQ)
        poly = mod("poly.multilinear").MultilinearPoly.from_ints(
            ctx, cs.benchmark_values(cs.NUM_VARS))
        fused, protocol = mod("sumcheck.fused"), mod("sumcheck.protocol")

        def run():
            return protocol.verify(poly, fused.prove(poly))

        tree["ctx"] = ctx
    else:
        ctx = mod("field.torch_backend").get_ctx(spec.BLS12_381_FR)
        structure, inputs = cs.gkr_benchmark(cs.GKR_NUM_VARS)
        circuit = mod("gkr.circuit").Circuit(ctx, structure)
        gkr = mod("gkr.protocol")
        if path == "layers":
            def run():
                proved = gkr.prove_layers(circuit, inputs)
                return gkr.verify_layers(proved.proof, circuit, proved.input_evals).verified
        else:
            taus = cs.gkr_benchmark_taus(cs.GKR_NUM_VARS)
            mod("msm.fixed_base")._comb_table(ctx.device)  # as a running prover holds it

            def run():
                return gkr.prove(circuit, inputs, taus=taus) is not None

    cs.check(run(), f"{pkg}: the {path} path refused its proof")
    tree["run"] = run
    return tree


def path_s(tree: dict) -> float:
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.time()
    ok = tree["run"]()
    torch.cuda.synchronize()
    cs.check(ok, "the path refused its proof")
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
    ap.add_argument("--path", choices=("sumcheck", "layers", "whole"), default="sumcheck")
    ap.add_argument("--pairs", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_prove: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as links:
        os.symlink(os.path.join(os.path.abspath(args.other), "zktpu_torch"),
                   os.path.join(links, OTHER))
        sys.path.insert(0, links)
        trees = {"other": load(OTHER, args.path), "this": load("zktpu_torch", args.path)}
        times = {name: [] for name in trees}
        for i in range(args.pairs):
            for name in ("other", "this") if i % 2 == 0 else ("this", "other"):
                times[name].append(path_s(trees[name]))
        for name, t in times.items():
            q = statistics.quantiles(t, n=4)
            print(f"{name}: warm {args.path} s, {args.pairs} in turns: median "
                  f"{statistics.median(t):.4f}, quartiles {q[0]:.4f} / {q[2]:.4f}, "
                  f"min {min(t):.4f}", flush=True)
        ratio, lo, hi = median_interval([a / b for a, b in zip(times["this"], times["other"])])
        wins = sum(a < b for a, b in zip(times["this"], times["other"]))
        print(f"this / other, a pair's ratio: median {ratio:.4f}, 95 % interval {lo:.4f} - "
              f"{hi:.4f}; this tree faster in {wins} of {args.pairs} pairs", flush=True)
        for log_size in (4, 16) if args.path == "sumcheck" else ():
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
