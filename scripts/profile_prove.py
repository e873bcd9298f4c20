#!/usr/bin/env python3
"""Where the provers and verifiers spend their time on the card.

Run on a machine with one CUDA device, from the repo's root:

    python3 scripts/profile_prove.py [--num-vars 20]         # the plain sumcheck
    python3 scripts/profile_prove.py --gkr [--num-vars 20]   # the GKR layer walk
    python3 scripts/profile_prove.py --kzg [--num-vars 20]   # the KZG input proof

Sumcheck: (1) host-clock times of the prover's stages, each closed by a
synchronise, and (2) a ``torch.profiler`` summary of one warm prove and one warm
verify: the number of device kernels launched, their summed device time, the
device's idle share of the wall time, and the kernels that take most of it.

GKR: the stages of the input layer's fused sumcheck one by one, the whole walk
layer by layer (the ``ZKTPU_TRACE`` marks of ``prove_layers``), the verifier's
time, and a profiler summary of one small fused layer.

KZG: the stages of the input proof one by one (set-up, commitment, basis chain,
quotient tables, each step's batched quotient MSM with its window width), the
stages inside the commitment MSM (each compaction round's ``run_scan`` and
``compact_add`` by their device time), and a profiler summary of that MSM: what
share of its device time each kernel takes, and the device's idle share.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.host import vec_to_bytes  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ  # noqa: E402
from zktpu_torch.gkr import fused_lazy  # noqa: E402
from zktpu_torch.gkr import lazy as gkr_lazy  # noqa: E402
from zktpu_torch.gkr import protocol as gkr  # noqa: E402
from zktpu_torch.gkr.circuit import Circuit  # noqa: E402
from zktpu_torch.hash import keccak_device as kd  # noqa: E402
from zktpu_torch.field import kernels as fk  # noqa: E402
from zktpu_torch.msm import kernels as mk  # noqa: E402
from zktpu_torch.msm import pippenger as pp  # noqa: E402
from zktpu_torch.pcs.kzg import KZG  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402
from zktpu_torch.sumcheck import fused, protocol  # noqa: E402
from zktpu_torch.transcript import Transcript  # noqa: E402


def timed(label: str, fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    print(f"  {label}: {(time.time() - t0) * 1e3:.2f} ms", flush=True)
    return out


def prover_stages(poly) -> None:
    """The steps of ``fused.prove``, one by one."""
    ctx = poly.ctx
    claimed = timed("host: canonical table + exact column sum",
                    lambda: fused.host_sum_mod_p(ctx, poly.canonical_table()))

    def sponge_state():
        sponge = poly.transcript_sponge()
        sponge.absorb(vec_to_bytes(ctx.spec, [claimed]))
        return sponge.state_lanes()

    pairs, tail = timed("host: cached sponge copy + claimed sum", sponge_state)
    rows = timed(
        "device: all rounds (_device_prove)",
        lambda: fused._device_prove(
            ctx, poly.num_vars, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(tail), poly.table
        ),
    )
    timed("fetch + unpack of the round polynomials",
          lambda: [int(v) for v in ctx.unpack(rows.reshape(-1, ctx.num_words))])


def profiled(label: str, fn) -> None:
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    kernels = [
        e for e in prof.key_averages()
        if e.device_type.name == "CUDA" and e.device_time_total > 0
    ]
    launches = sum(e.count for e in kernels)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"  {label}: wall {wall_ms:.2f} ms under the profiler, {launches} device kernels, "
          f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.1%}", flush=True)
    if not kernels:
        print("  (the profiler recorded no device time on this machine)")
        return
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def gkr_layer_stages(ctx, w_poly, layer) -> None:
    """The steps of one layer's fused sumcheck (``lazy_folded_fbc`` ->
    ``gkr_prove_lazy_fused``) and of its two input evaluations, one by one."""
    k = w_poly.num_vars - 1
    point = list(range(3, 3 + k))
    fbc = timed("wiring coefficients (lazy_folded_fbc: 2 eq tables, masks)",
                lambda: gkr_lazy.lazy_folded_fbc(ctx, layer, w_poly, point, point[::-1], 5, 7))
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1])
    gh = timed("phase-1 tables G, H",
               lambda: gkr_lazy._phase1_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table))
    ones = ctx.one_mont.expand(fbc.w_table.shape)
    tables1 = timed("phase-1 stack [[F, G], [H, 1]]", lambda: torch.stack(
        [torch.stack([fbc.w_table, gh[0]]), torch.stack([gh[1], ones])]))
    _, challenges, wb = timed(f"phase 1: {k + 1} rounds on the device + fetch + host replay",
                              lambda: fused_lazy._run_phase(ctx, transcript, tables1))
    eqb = timed("eq(r_b, .) table",
                lambda: gkr_lazy.eq_tensor(ctx, gkr_lazy._encode(ctx, challenges)))
    tables2 = timed("phase-2 stack", lambda: gkr_lazy._phase2_tables_kernel(
        ctx, fbc.coef_a, fbc.coef_m, fbc.w_table, eqb, wb))
    timed(f"phase 2: {k + 1} rounds on the device + fetch + host replay",
          lambda: fused_lazy._run_phase(ctx, transcript, tables2))
    timed("the two input evaluations w(r_b), w(r_c)",
          lambda: (w_poly.evaluate_int(challenges), w_poly.evaluate_int(challenges[::-1])))


def gkr_mode(num_vars: int) -> int:
    ctx = fb.get_ctx(BLS12_381_FR)
    structure, inputs = chip_smoke.gkr_benchmark(num_vars)
    circuit = Circuit(ctx, structure)
    input_poly = timed("inputs upload (from_ints)", lambda: MultilinearPoly.from_ints(ctx, inputs))
    timed("circuit evaluation", lambda: circuit.evaluate(input_poly))
    proved = gkr.prove_layers(circuit, inputs)  # warm: builds the kernels
    assert gkr.verify_layers(proved.proof, circuit, proved.input_evals).verified

    print(f"stages of the input layer's sumcheck (2^{num_vars} w-entries; host clock, synchronised):")
    gkr_layer_stages(ctx, input_poly, circuit.layers[0])

    print("the whole walk, layer by layer (marks on stderr follow):", flush=True)
    os.environ["ZKTPU_TRACE"] = "1"
    try:
        timed("whole prove_layers", lambda: gkr.prove_layers(circuit, inputs))
    finally:
        del os.environ["ZKTPU_TRACE"]
    timed("whole verify_layers",
          lambda: gkr.verify_layers(proved.proof, circuit, proved.input_evals))

    print("torch.profiler, one fused layer of 2^6 w-entries (12 rounds):")
    small = MultilinearPoly(ctx, input_poly.table[:64].contiguous())
    small_circuit = Circuit(ctx, [structure[-6]])
    fbc = gkr_lazy.lazy_folded_fbc(
        ctx, small_circuit.layers[0], small, [3, 4, 5, 6, 7], [7, 6, 5, 4, 3], 5, 7)
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1])
    profiled("gkr_prove_lazy_fused", lambda: fused_lazy.gkr_prove_lazy_fused(0, fbc, transcript))
    return 0


def device_ms(fn):
    """(fn(), the milliseconds between CUDA events around it): its kernels'
    device time where the launches outrun the card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def msm_stages(points, scalars, c: int) -> None:
    """The stages of one Pippenger MSM (one window group), one by one; each
    compaction round's two kernels by their device time."""
    num_windows = 256 // c
    nbuck = (1 << (c - 1)) + 1
    n = scalars.shape[0]
    abs_d, signs = timed("digits (_recode_signed)", lambda: pp._recode_signed(scalars, c))
    fq = pp.dc.fq_ctx(points[0].device)
    neg_y = timed("0 - Y of the base (plain sub)",
                  lambda: fb.sub(fq, torch.zeros_like(points[1]), points[1]))
    skey, pt = timed(f"sort + gathers of {num_windows} x {n} lanes (_presort)",
                     lambda: pp._presort(points, neg_y, abs_d, signs, nbuck))
    sizes = pp._compaction_schedule(num_windows * n, num_windows * nbuck + 1)
    scan = mk.run_scan(skey, sizes[0] if sizes else skey.shape[0])
    longest = int(scan[2].item())
    rounds = max(1, (longest - 1).bit_length())
    sizes = sizes[:rounds]
    sizes += [sizes[-1] if sizes else skey.shape[0]] * (rounds - len(sizes))
    print(f"  longest bucket run {longest}: {rounds} compaction rounds at widths {sizes}")
    t0 = time.time()
    for r, l_next in enumerate(sizes):
        keys = skey.shape[0]
        scan, ms_scan = device_ms(lambda: mk.run_scan(skey, l_next))
        (skey, pt), ms_add = device_ms(lambda: mk.compact_add(skey, pt, *scan[:2]))
        print(f"  compaction round {r}: {keys} keys -> {l_next} slots: run_scan {ms_scan:.4f} ms, "
              f"compact_add {ms_add:.4f} ms (CUDA events)")
    print(f"  the {rounds} rounds, timed one by one: {(time.time() - t0) * 1e3:.2f} ms")
    buckets = timed("densify", lambda: pp._densify(skey, pt, num_windows, nbuck))
    per_window = timed(f"bucket reduction ({num_windows} x {nbuck - 1} buckets)",
                       lambda: pp._weighted_reduce_staged(buckets))
    timed(f"Horner chain ({256 - c} doublings, {num_windows - 1} additions; one horner launch)",
          lambda: pp._horner_single(per_window, c))


def kzg_mode(num_vars: int) -> int:
    ctx = fb.get_ctx(BLS12_381_FR)
    _, inputs = chip_smoke.gkr_benchmark(num_vars)
    taus = chip_smoke.gkr_benchmark_taus(num_vars)
    input_poly = MultilinearPoly.from_ints(ctx, inputs)
    rng_point = [(7 * k + 3) << 40 for k in range(num_vars)]
    pp.msm_pippenger(*_small_msm(ctx))  # warm: builds the kernels
    print(f"stages of the KZG input proof at 2^{num_vars} inputs (host clock, synchronised):")
    kzg = timed("set-up (eq table, comb, g2 taus on the host)",
                lambda: KZG.for_poly(input_poly, taus))
    kzg = timed("set-up again (comb table held)", lambda: KZG.for_poly(input_poly, taus))
    opened = timed("open", lambda: kzg.open(rng_point, input_poly))
    timed("commit (one MSM + unpack_points)", lambda: kzg.commit(input_poly))
    bases = timed("basis chain (collapsed_bases)", kzg.collapsed_bases)
    quotients = timed("quotient tables of one opening",
                      lambda: kzg._quotients(opened, rng_point, input_poly))
    for k in range(num_vars):
        stack = torch.stack([quotients[k], quotients[k]])
        timed(f"step {k}: batched MSM of 2 x {quotients[k].shape[0]} "
              f"(c = {pp.pick_window_bits_multi(2, quotients[k].shape[0])})",
              lambda: pp.msm_pippenger_multi(bases[k], stack))
    timed("whole commit_with_proof_pair", lambda: kzg.commit_with_proof_pair(
        (opened, rng_point), (opened, rng_point), input_poly))

    scalars = fk.from_mont(ctx, input_poly.table)
    c = pp.pick_window_bits(scalars.shape[0])
    print(f"stages of the commitment MSM (c = {c}):")
    msm_stages(kzg.g1_lagrange_basis, scalars, c)
    print("torch.profiler:")
    profiled("msm_pippenger at full size",
             lambda: pp.msm_pippenger(kzg.g1_lagrange_basis, scalars))
    small = 1 << min(num_vars - 1, 6)
    profiled(f"msm_pippenger_multi of 2 x {small}", lambda: pp.msm_pippenger_multi(
        bases[num_vars - 1 - small.bit_length() + 1], torch.stack([scalars[:small]] * 2)))
    return 0


def _small_msm(ctx):
    from zktpu_torch.curve import device as dc
    from zktpu_torch.msm import generator_comb_mul

    scalars = dc.pack_scalars(list(range(1, 9)), ctx.device)
    return generator_comb_mul(scalars), scalars


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-vars", type=int, default=20)
    ap.add_argument("--gkr", action="store_true", help="profile the GKR layer walk")
    ap.add_argument("--kzg", action="store_true", help="profile the KZG input proof")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    if args.gkr:
        return gkr_mode(args.num_vars)
    if args.kzg:
        return kzg_mode(args.num_vars)
    ctx = fb.get_ctx(BN254_FQ)
    poly = MultilinearPoly.from_ints(ctx, chip_smoke.benchmark_values(args.num_vars))
    proof = fused.prove(poly)  # warm: builds the kernels, caches the host sponge
    assert protocol.verify(poly, proof)

    print(f"prover stages at 2^{args.num_vars} (host clock, synchronised):")
    prover_stages(poly)
    timed("whole fused.prove", lambda: fused.prove(poly))
    timed("whole protocol.verify", lambda: protocol.verify(poly, proof))
    print("torch.profiler:")
    profiled("fused.prove", lambda: fused.prove(poly))
    profiled("protocol.verify", lambda: protocol.verify(poly, proof))
    return 0


if __name__ == "__main__":
    sys.exit(main())
