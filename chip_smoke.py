#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``zktpu_torch``): run it on one GPU.

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; with no card it exits non-zero at once.
It builds the CUDA kernels from ``zktpu_torch/csrc/``, then

  1. prints the card's name and power limit, the build time and the host Keccak
     backend (the pure-Python one is refused);
  2. holds each kernel against its plain PyTorch version on the card, word for
     word (tolerance 0: this is integer arithmetic), for BN254 Fq and BLS12-381
     Fr at sizes from 2 to 2^20 and BLS12-381 Fq (12 words) up to 4096, with
     edge values and unreduced operands;
  3. drives the main path at full size through the public entry points: the
     sumcheck prove + verify of a 2^20-entry BN254 Fq multilinear polynomial
     (``MultilinearPoly.from_ints`` -> ``sumcheck.fused.prove`` ->
     ``sumcheck.protocol.verify``), and reads the kernels' launch counts;
  4. ties the proof to the JAX reference package: it must equal the host-loop
     prover's, hash to a stored digest, and a 2^12 proof must equal the CPU's;
     a tampered proof must be refused;
  5. times the path and each kernel (CUDA events, median), beside each
     kernel's plain version and the least time the card could take.

Any failed comparison exits non-zero. The last line of the output is one JSON
object, ``{"ok": true, "device": {...}}``; the line before it lists the kernels
with their launch counts, errors, times and bounds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from zktpu_torch import _build
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.host import vec_to_bytes
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ
from zktpu_torch.hash import keccak as hk
from zktpu_torch.hash import keccak_device as kd
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import fused, protocol

NUM_VARS = 20
#: Keccak-256 of vec_to_bytes(claimed_sum, round polynomials) of the seed-0
#: 2^20 BN254 Fq proof, from the port's CPU path (scripts/proof_digest.py), which
#: the tests pin to the JAX package; the JAX package's own fused prover gives the
#: same digest on the CPU.
PROOF_DIGEST_2E20 = "f23438ab206af9a6f85c866807dfeb3e1b97df970b09806663a29bae9218ff91"

CHECK_SIZES = (2, 4, 64, 4096, 1 << 20)
TIME_SIZES = (1 << 20, 1 << 24)
TIMED_RUNS = 10

# Peaks of one H100 SXM used for the bounds. Memory: 3.35 TB/s (data sheet).
# Integer: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 32-bit
# multiply-adds a second; a 32x32->64 multiply-accumulate is two of them (low
# and high half).
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9

KERNEL_SOURCE = "zktpu_torch/csrc/sumcheck_kernels.cu"
REPLACES = {
    "mont_mul": "zktpu/field/pallas_kernels.py:110",
    "fold": "zktpu/field/pallas_kernels.py:140",
    "halves_sums": "zktpu/field/pallas_kernels.py:184",
    "fold_and_halves": "zktpu/field/pallas_kernels.py:227",
}
#: launches the main path must make at 2^NUM_VARS. mont_mul: to_mont of the table,
#: from_mont of each round's two sums, to_mont of each later round's challenge,
#: and the verifier's to_mont of the point and from_mont of the evaluation; then
#: round 0, rounds 1..n-1, the verifier's n folds
EXPECTED_LAUNCHES = {
    "mont_mul": 1 + NUM_VARS + (NUM_VARS - 1) + 2,
    "halves_sums": 1,
    "fold_and_halves": NUM_VARS - 1,
    "fold": NUM_VARS,
}


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def benchmark_values(num_vars: int) -> list[int]:
    """The benchmark table: 2^num_vars values below 2^62 from numpy seed 0."""
    rng = np.random.default_rng(0)
    return [int(v) for v in rng.integers(0, 1 << 62, size=1 << num_vars)]


def proof_digest(spec, proof) -> str:
    flat = [proof.claimed_sum] + [v for rp in proof.proof_polynomials for v in rp]
    return hk.keccak256(vec_to_bytes(spec, flat)).hex()


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------

def raw_words(ctx, value: int) -> np.ndarray:
    """Words of ``value`` as it is (not reduced mod p)."""
    return np.frombuffer(value.to_bytes(4 * ctx.num_words, "little"), dtype="<u4")


def random_table(ctx, rng, *shape, edges=()):
    """Random field elements below p as an int32 (*shape, W) tensor on the card;
    the first rows of the flattened table are overwritten by ``edges`` (ints)."""
    w = ctx.num_words
    words = rng.integers(0, 1 << 32, size=(*shape, w), dtype=np.uint32)
    # a top word strictly below the modulus's top word keeps the value below p
    words[..., w - 1] = rng.integers(0, ctx.p_words_host[-1], size=shape, dtype=np.uint32)
    flat = words.reshape(-1, w)
    for i, v in enumerate(edges[: flat.shape[0]]):
        flat[i] = raw_words(ctx, v)
    return ctx.to_device(words)


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        return -1
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ----------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ----------------------------------------------------------------------

def compare_kernels(ctx, rng, size: int) -> dict[str, int]:
    """Run the four kernels and their plain versions on the same inputs at one
    size; returns the largest absolute word difference per kernel."""
    p = ctx.spec.modulus
    top = (1 << (32 * ctx.num_words)) - 1
    errs = {}

    a = random_table(ctx, rng, size, edges=(top, p - 1, 0, 1, p))
    b = random_table(ctx, rng, size, edges=(p - 1, p - 1, p - 1, 0, 1))
    errs["mont_mul"] = max(
        max_abs_err(fk.mont_mul(ctx, a, b), fk.mont_mul_plain(ctx, a, b)),
        # table x one element, as to_mont of a raw table uses it
        max_abs_err(fk.mont_mul(ctx, a, ctx.r2), fk.mont_mul_plain(ctx, a, ctx.r2)),
    )

    table = random_table(ctx, rng, size, edges=(p - 1, 0, 1, p - 1))
    r = random_table(ctx, rng, edges=(p - 1,) if size == 4 else ())
    stack = random_table(ctx, rng, 2, 2, size, edges=(0, p - 1))
    errs["fold"] = max(
        max_abs_err(fk.fold(ctx, table, r), fk.fold_plain(ctx, table, r)),
        max_abs_err(fk.fold(ctx, stack, r), fk.fold_plain(ctx, stack, r)),
    )

    errs["halves_sums"] = max_abs_err(
        fk.halves_sums(ctx, table), fk.halves_sums_plain(ctx, table)
    )

    folded, rows = fk.fold_and_halves(ctx, table, r)
    folded_ref, rows_ref = fk.fold_and_halves_plain(ctx, table, r)
    errs["fold_and_halves"] = max(max_abs_err(folded, folded_ref), max_abs_err(rows, rows_ref))
    torch.cuda.synchronize()
    return errs


def phase_kernels_vs_plain() -> dict[str, int]:
    worst = {name: 0 for name in fk.KERNEL_NAMES}
    # the 12-word build (BLS12-381 Fq) is held at the small sizes only
    for spec, sizes in ((BN254_FQ, CHECK_SIZES), (BLS12_381_FR, CHECK_SIZES),
                        (BLS12_381_FQ, CHECK_SIZES[:4])):
        ctx = fb.get_ctx(spec)
        rng = np.random.default_rng(1)
        for size in sizes:
            errs = compare_kernels(ctx, rng, size)
            say(f"  {spec.name} size {size}: " + " ".join(f"{k}={v}" for k, v in errs.items()))
            for name, err in errs.items():
                check(err == 0, f"{name} differs from its plain version ({spec.name}, size {size})")
                worst[name] = max(worst[name], err)
    return worst


# ----------------------------------------------------------------------
# phases 3 and 4: the main path and its tie to the reference
# ----------------------------------------------------------------------

def phase_main_path(ctx):
    values = benchmark_values(NUM_VARS)
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.time()
    poly = MultilinearPoly.from_ints(ctx, values)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    t0 = time.time()
    proof = fused.prove(poly)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    t0 = time.time()
    ok = protocol.verify(poly, proof)
    torch.cuda.synchronize()
    t_verify = time.time() - t0
    launches = dict(fk.launches)
    say(f"  first run: table build+upload {t_build:.3f}s  prove {t_prove:.3f}s "
        f"(includes the host's Keccak pass over the table)  verify {t_verify:.3f}s")
    say(f"  launches on the main path: {launches}")
    check(ok, "verify refused the fused prover's proof")
    check(len(proof.proof_polynomials) == NUM_VARS, "wrong number of round polynomials")
    p = ctx.spec.modulus
    check(all(0 <= v < p for rp in proof.proof_polynomials for v in rp), "values not canonical")
    check(proof.claimed_sum == sum(values) % p, "claimed sum is not the table's sum")
    check(launches == EXPECTED_LAUNCHES, f"launch counts {launches} != {EXPECTED_LAUNCHES}")
    return poly, proof, launches


def phase_reference_tie(ctx, poly, proof) -> None:
    host_loop = protocol.prove(poly)
    check(host_loop.claimed_sum == proof.claimed_sum
          and host_loop.proof_polynomials == proof.proof_polynomials,
          "fused proof differs from the host-loop prover's")
    say("  fused proof == host-loop proof on the card")

    tampered = protocol.Proof([list(rp) for rp in proof.proof_polynomials], proof.claimed_sum)
    tampered.proof_polynomials[3][1] = (tampered.proof_polynomials[3][1] + 1) % ctx.spec.modulus
    check(not protocol.verify(poly, tampered), "a tampered proof was accepted")
    say("  tampered proof refused")

    digest = proof_digest(ctx.spec, proof)
    say(f"  proof digest {digest}")
    check(digest == PROOF_DIGEST_2E20, f"proof digest differs from the stored {PROOF_DIGEST_2E20}")

    small = benchmark_values(12)
    on_card = fused.prove(MultilinearPoly.from_ints(ctx, small))
    cpu_ctx = fb.get_ctx(ctx.spec, device="cpu")
    on_cpu = fused.prove(MultilinearPoly.from_ints(cpu_ctx, small))
    check(on_card.claimed_sum == on_cpu.claimed_sum
          and on_card.proof_polynomials == on_cpu.proof_polynomials,
          "2^12 proof on the card differs from the CPU's")
    say("  2^12 proof on the card == 2^12 proof on the CPU")


# ----------------------------------------------------------------------
# phase 5: times
# ----------------------------------------------------------------------

def time_events(fn, runs: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, by CUDA events;
    ``flush`` (a tensor larger than the L2 cache) is rewritten before each."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_work(name: str, size: int, w: int):
    """(bytes moved, 32-bit multiply-adds) of one call at ``size``:
    each input read once, each output written once."""
    elem = 4 * w
    mul = 2 * (2 * w * w + w)  # one Montgomery product, low and high halves
    if name == "mont_mul":  # table x one element
        return 2 * size * elem + elem, size * mul
    if name == "fold":
        return size * elem + size // 2 * elem + elem, size // 2 * mul
    rows = 2 * 4 * (w + fk.EXTRA_WORDS)
    if name == "halves_sums":  # a 64-bit column add is two 32-bit adds
        return size * elem + rows, size * 2 * w
    if name == "fold_and_halves":
        return size * elem + size // 2 * elem + elem + rows, size // 2 * (mul + 2 * w)
    raise ValueError(name)


def time_kernels_at(ctx, rng, flush, r, size: int) -> dict[str, dict]:
    table = random_table(ctx, rng, size)
    cases = {
        "mont_mul": (lambda: fk.mont_mul(ctx, table, ctx.r2),
                     lambda: fk.mont_mul_plain(ctx, table, ctx.r2)),
        "fold": (lambda: fk.fold(ctx, table, r), lambda: fk.fold_plain(ctx, table, r)),
        "halves_sums": (lambda: fk.halves_sums(ctx, table),
                        lambda: fk.halves_sums_plain(ctx, table)),
        "fold_and_halves": (lambda: fk.fold_and_halves(ctx, table, r),
                            lambda: fk.fold_and_halves_plain(ctx, table, r)),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        cold = time_events(kernel, TIMED_RUNS, flush)
        warm = time_events(kernel, TIMED_RUNS)
        plain_ms = time_events(plain, 3 if size > (1 << 20) else 5, flush)
        nbytes, mads = kernel_work(name, size, ctx.num_words)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = mads / INT32_MAD_PER_S * 1e3
        rec = {
            "ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bytes": nbytes,
            "gb_per_s": nbytes / (cold * 1e-3) / 1e9,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        out[name] = rec
        say(f"  {name} 2^{size.bit_length() - 1}: {cold:.4f} ms cold L2 "
            f"({rec['gb_per_s']:.0f} GB/s of {nbytes} bytes), {warm:.4f} ms warm, "
            f"plain {plain_ms:.2f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
    return out


def phase_kernel_times(ctx) -> dict[int, dict[str, dict]]:
    """Each kernel alone at every size of TIME_SIZES: size -> name -> record."""
    rng = np.random.default_rng(2)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=ctx.device)
    r = random_table(ctx, rng)
    out = {}
    for size in TIME_SIZES:
        out[size] = time_kernels_at(ctx, rng, flush, r, size)
        torch.cuda.empty_cache()
    return out


def phase_path_times(ctx, poly) -> None:
    """Warm prove and verify at 2^NUM_VARS, and where the prover's time goes."""
    proves, verifies = [], []
    for _ in range(3):
        t0 = time.time()
        proof = fused.prove(poly)
        torch.cuda.synchronize()
        proves.append(time.time() - t0)
        t0 = time.time()
        check(protocol.verify(poly, proof), "warm verify failed")
        torch.cuda.synchronize()
        verifies.append(time.time() - t0)
    t_prove, t_verify = statistics.median(proves), statistics.median(verifies)
    say(f"  warm 2^{NUM_VARS}: prove {t_prove:.4f}s  verify {t_verify:.4f}s  "
        f"prove+verify {t_prove + t_verify:.4f}s (median of 3, host clock, synchronised)")

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.time() - t0) / n * 1e3

    state = torch.arange(25, dtype=torch.int64, device=ctx.device)
    rows = torch.ones((2, ctx.num_words + fk.EXTRA_WORDS), dtype=torch.int32, device=ctx.device)
    ms_keccak = host_ms(lambda: kd.keccak_f(state))
    ms_digest = host_ms(lambda: fused._digest_to_mont(ctx, state[:4]))
    ms_canon = host_ms(lambda: fused._canonicalize_rows(ctx, rows))
    # one keccak-f per round, plus the extra blocks of round 0's longer absorb
    sponge = poly.transcript_sponge()
    sponge.absorb(vec_to_bytes(ctx.spec, [0]))
    tail_len = len(sponge.state_lanes()[1])
    n_keccak = NUM_VARS - 1 + (tail_len + fused.ROUND_ELEMS * ctx.spec.byte_len) // kd.RATE + 1
    share = n_keccak * ms_keccak / (t_prove * 1e3)
    say(f"  eager device glue of the prover, per call (host clock): keccak_f {ms_keccak:.3f} ms, "
        f"_digest_to_mont {ms_digest:.3f} ms, _canonicalize_rows {ms_canon:.3f} ms")
    say(f"  keccak_f share of the warm prover: {n_keccak} calls x {ms_keccak:.3f} ms = "
        f"{n_keccak * ms_keccak:.2f} ms of {t_prove * 1e3:.2f} ms = {share:.1%}; "
        f"scalar field glue {(NUM_VARS - 1) * ms_digest + NUM_VARS * ms_canon:.2f} ms")


# ----------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    t_start = time.time()
    gpu = gpu_line()
    say(f"[1] device: {gpu}")
    say(f"    torch {torch.__version__}, CUDA {torch.version.cuda}")
    fk.library()
    say(f"    kernels built from {KERNEL_SOURCE} in "
        f"{_build.build_seconds['sumcheck_kernels']:.1f}s (0.0 = already built)")
    say(f"    host Keccak backend: {hk.backend()}")
    check(hk.backend() == "c", "the host Keccak fell back to pure Python")

    say("[2] each kernel against its plain PyTorch version (exact)")
    errs = phase_kernels_vs_plain()

    ctx = fb.get_ctx(BN254_FQ)
    say(f"[3] main path: 2^{NUM_VARS} BN254 Fq sumcheck, from_ints -> fused.prove -> verify")
    poly, proof, launches = phase_main_path(ctx)

    say("[4] the tie to the reference")
    phase_reference_tie(ctx, poly, proof)

    say("[5] times")
    phase_path_times(ctx, poly)
    times = phase_kernel_times(ctx)

    kernels = []
    for name in fk.KERNEL_NAMES:
        rec = times[1 << NUM_VARS][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
        })
    say(f"total {time.time() - t_start:.1f}s")
    say(gpu)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
