#!/usr/bin/env python3
"""The redesigned kernels timed alone, to compare trees on one card.

Run on a machine with one CUDA device, from the root of a tree of the repo:

    python3 scripts/time_kernels.py TAG [PART ...]

PART is one of ``gkr``, ``tail``, ``ntt``, ``sums``, ``msm``, ``transcript``
(default: all six). It prints, on lines that start with TAG:

  * the registers ``nvcc`` gave ``ntt_phase1``, ``gkr_round``, ``halves_sums``,
    ``fold_and_halves``, the MSM kernels and the transcript kernels;
  * ``gkr``: ``gkr_round`` at every size from 2 to 2^24 entries (a BLS12-381 Fr
    stack): the device microseconds of one call by ``torch.profiler``, the
    kernel and its ``finish_rows`` pass apart (at real widths most calls are
    small, where a launch's latency is its time and CUDA events would time the
    host); the rows are held against the plain version up to 2^16. Then a
    whole fused GKR phase (``fused_lazy._device_phase``, what the tree
    launches for it) at every size from 2 to 2^20: ms by CUDA events (median of
    20, warm) and its device kernels by the profiler; one round of the launches
    a round took before the phase kernels (``fold``, ``gkr_round`` with its
    ``finish_rows``, ``round_step``) at 2^15 to 2^20 by CUDA events, L2
    flushed; and, in a tree with ``zktpu_torch.gkr.kernels``, ``gkr_big_round``
    at the same sizes by CUDA events and device microseconds;
  * ``tail`` (a tree with ``zktpu_torch.gkr.kernels``): ``gkr_phase_tail``
    after a fold from 2^19 and from a phase's first round at 2^18, 2^14, 2^11,
    2^10, 2^6 and 2 (``TAIL_SIZES``), by CUDA events (median of 20, warm) and
    device microseconds a launch and a round by the profiler (median of 50),
    held against its plain version up to 2^11 first; then a 2^20-input walk's
    40 phases (two a size, 2 to 2^20; ``fused_lazy._device_phase``, ms by CUDA
    events, summed, and the device ms of their phase kernels by the
    profiler). Where the tree has ``gkr.kernels.BLOCK_MAX``, both under
    each of ``BLOCK_MAX_CHOICES``. Then a whole phase at 2^15 to 2^20 under
    each ``fused_lazy.TAIL_MAX`` of ``TAIL_MAX_CHOICES``, with the walk's 40
    phases summed; last, the device milliseconds of each phase kernel in one
    ``prove_layers`` of ``chip_smoke.py``'s 2^20-input circuit by the
    profiler (phase 14's figure for the layer walk);
  * ``ntt``: ``ntt_phase1`` at a 1024-entry tile on 2^20 and 2^22 BN254 Fr
    entries, and ``point_add`` / ``point_double`` on 2^20 lanes: median
    milliseconds of 20 launches by CUDA events, L2 flushed before each;
    ``ntt_phase1`` is held against its plain version at 2^12, every tile, first;
  * ``sums``: ``halves_sums`` and ``fold_and_halves`` on BN254 Fq tables at
    every size from 2 to 2^24, device microseconds by the profiler as for
    ``gkr_round`` (a tree whose kernels end in a ``finish_rows`` pass shows it
    apart), held against the plain versions up to 2^16; then at 2^20 and 2^24
    by CUDA events: L2 flushed as ``roofline.time_events`` flushes it (by
    writing a 256 MB buffer: cold), flushed by reading that buffer (L2 clean),
    and not flushed (warm), beside ``torch.sum(x.view(2, half, W), dim=1,
    dtype=torch.int64)`` on the same bytes, a library reduction's rate (signed
    columns: not the same function);
  * ``msm``: on the KZG path of the 2^20-input GKR proof (``chip_smoke``'s
    inputs and taus, a random opening point), ``run_scan`` and ``compact_add``
    on the commitment MSM's first compaction round (2^24 keys) and a steady
    one, and on quotient step 0's first round (``run_scan`` held against its
    plain version first, and its device kernels' microseconds apart); ``horner`` on each of the proof's chain
    shapes (the commitment's, and two segments at each quotient step's c) and
    on the whole quotient commit (every step's chains: a launch a step, and
    one ``horner_groups`` launch where the tree has it): median ms of 20
    launches by CUDA events, L2 flushed before each, and the registers of the
    two kernels;
  * ``transcript``: ``round_step`` on a steady GKR round (BLS12-381 Fr, 3 rows),
    a steady sumcheck round (BN254 Fq, 2 rows) and a GKR phase's first round
    of two blocks (a 16-lane tail), the shapes of the paths' rounds, each held
    against its plain version first, and ``keccak_f`` on one state and on 4096:
    the device microseconds of a launch by the profiler's clock, median of 200
    (20 at 4096 states).

It is the one tool that times a kernel alone; the paths are timed by the
benchmark (``zkbench/``), and ``chip_smoke.py`` only checks. To compare two
trees, copy this script into both and run it from each, one after the other in
one call on one card, in the order A, B, B, A.
"""

from __future__ import annotations

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import importlib.util  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from zktpu_torch import _build  # noqa: E402
from zktpu_torch.curve import point_kernels as pk  # noqa: E402
from zktpu_torch.field import kernels as fk  # noqa: E402
from zktpu_torch.field import torch_backend as fb  # noqa: E402
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR  # noqa: E402
from zktpu_torch.gkr import fused_lazy  # noqa: E402
from zktpu_torch.gkr import protocol as gkr  # noqa: E402
from zktpu_torch.gkr.circuit import Circuit  # noqa: E402
from zktpu_torch.hash import keccak_device as kd  # noqa: E402
from zktpu_torch.hash import kernels as tk  # noqa: E402
from zktpu_torch.transcript import Transcript  # noqa: E402
from zktpu_torch.utils.roofline import time_events  # noqa: E402
from zktpu_torch.msm import kernels as mk  # noqa: E402
from zktpu_torch.msm import pippenger as pp  # noqa: E402
from zktpu_torch.ntt import ntt_kernels as nk  # noqa: E402
from zktpu_torch.pcs.kzg import KZG  # noqa: E402
from zktpu_torch.poly.multilinear import MultilinearPoly  # noqa: E402

RUNS = 20
#: profiles of a burst taken at most while the tracer drops records
PROFILE_TRIES = 3
#: the thresholds a whole fused GKR phase is timed under (``tail`` part)
TAIL_MAX_CHOICES = tuple(1 << k for k in range(14, 21))
#: the block rounds' thresholds a phase tail is timed under (``tail`` part)
BLOCK_MAX_CHOICES = tuple(1 << k for k in range(5, 11))
#: (log2 of the stack's entries, whether the tail's first round folds) of the
#: tails timed alone (``tail`` part)
TAIL_SIZES = ((19, True), (18, False), (14, False), (11, False), (10, False), (6, False),
              (1, False))
PARTS = ("gkr", "tail", "ntt", "sums", "msm", "transcript")
#: round_step's shapes on the paths: (label, field, rows, pending tail lanes or
#: None for a steady round)
ROUND_SHAPES = (("steady GKR round", BLS12_381_FR, 3, None),
                ("steady sumcheck round", BN254_FQ, 2, None),
                ("GKR first round, two blocks", BLS12_381_FR, 3, 16))


def device_us(fn, kernel: str, reps: int) -> tuple[float, float]:
    """Device microseconds of one call of ``fn`` by the profiler, averaged over
    ``reps`` calls: (``kernel``'s, ``finish_rows``')."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    own = finish = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            if kernel + "_kernel" in e.name():
                own += e.duration_ns()
            elif "finish_rows_kernel" in e.name():
                finish += e.duration_ns()
    return own / reps / 1e3, finish / reps / 1e3


def kernel_us(fn, needle: str, reps: int = 10) -> dict[str, float]:
    """Device microseconds of one call of ``fn`` by the profiler, averaged over
    ``reps`` calls, for each device kernel whose name holds ``needle`` (by its
    name up to ``_kernel``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA" and needle in e.name():
            name = e.name().split("_kernel")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + e.duration_ns() / reps / 1e3
    return out


def gkr_round_sizes(tag: str) -> None:
    ctx = fb.get_ctx(BLS12_381_FR)
    rng = np.random.default_rng(0)
    line = []
    for k in range(1, 25):
        stack = cs.random_table(ctx, rng, 2, 2, 1 << k)
        got = fk.gkr_round(ctx, stack)
        if k <= 16:
            cs.check(torch.equal(got, fk.gkr_round_plain(ctx, stack)),
                     f"gkr_round differs from its plain version at 2^{k}")
        kernel, finish = device_us(lambda: fk.gkr_round(ctx, stack), "gkr_round",
                                   50 if k <= 16 else 10)
        line.append(f"2^{k} {kernel:.2f}+{finish:.2f}")
        del stack
    print(f"{tag} gkr_round us (kernel+finish_rows): " + ", ".join(line), flush=True)
    gkr_phase_sizes(tag)


def device_kernels(fn) -> int:
    """Device kernels ``fn`` runs, by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type().name == "CUDA" for e in prof.profiler.kineto_results.events())


def gkr_phase_sizes(tag: str) -> None:
    """A fused GKR phase at every size, one round of the launches a round took
    before the phase kernels, and the phase kernels where the tree has them
    (see the module's docstring)."""
    ctx = fb.get_ctx(BLS12_381_FR)
    rng = np.random.default_rng(1)
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1, 2])
    pairs, tail = transcript.sponge().state_lanes()
    consts = fused_lazy._PhaseConsts(ctx, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(tail))
    line = []
    for k in range(1, 21):
        stack = cs.random_table(ctx, rng, 2, 2, 1 << k)
        ms = time_events(lambda: fused_lazy._device_phase(ctx, stack, consts), RUNS)
        n = device_kernels(lambda: fused_lazy._device_phase(ctx, stack, consts))
        line.append(f"2^{k} {ms:.4f} ms / {n}")
    print(f"{tag} a fused GKR phase, ms (CUDA events, warm) / device kernels: " + ", ".join(line),
          flush=True)
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    state = cs.random_lanes(rng, 25, ctx.device)
    r = cs.random_table(ctx, rng)
    has_kernels = importlib.util.find_spec("zktpu_torch.gkr.kernels") is not None
    if has_kernels:
        from zktpu_torch.gkr import kernels as gk
    line = []
    for k in range(15, 21):
        stack = cs.random_table(ctx, rng, 2, 2, 1 << k)

        def chain():
            return tk.round_step(ctx, fk.gkr_round(ctx, fk.fold(ctx, stack, r)), state)

        item = f"2^{k} chain {time_events(chain, RUNS, flush):.4f} ms"
        if has_kernels:
            ms = time_events(lambda: gk.gkr_big_round(ctx, stack, r, state), RUNS, flush)
            us = launch_us(lambda: gk.gkr_big_round(ctx, stack, r, state), "gkr_big_round")
            item += f", gkr_big_round {ms:.4f} ms, device {us:.2f} us"
        line.append(item)
    print(f"{tag} a steady round at 2^15-2^20 (CUDA events, L2 flushed): " + "; ".join(line),
          flush=True)


def launch_us(fn, kernel: str, runs: int = 50) -> float:
    """Median device microseconds of ``kernel``'s launches over ``runs`` calls
    of ``fn``, by the profiler's clock (a launch of a one-thread kernel takes
    microseconds, and a CUDA event pair around one call would time the
    wrapper's host path instead); late in a long process the tracer may drop a
    burst's records, so the profile is taken again, up to PROFILE_TRIES times,
    while it holds fewer than half of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        durations = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA" and f"{kernel}_kernel" in e.name()]
        if runs // 2 <= len(durations):
            break
    cs.check(runs // 2 <= len(durations) <= runs,
             f"{kernel}: {len(durations)} device kernels traced for {runs} calls")
    return statistics.median(durations) / 1e3


def walk_ms(ctx, stacks, consts, sizes=range(1, 21)) -> tuple[float, float]:
    """The 40 phases of a 2^20-input walk, two at each size 2 to 2^20 (or
    those of ``sizes``): the sum of each phase's ms (CUDA events, median of
    RUNS, warm), and the device ms of their phase kernels (by the profiler,
    median of three passes whose every launch was traced)."""
    from torch.profiler import ProfilerActivity, profile

    from zktpu_torch.gkr import kernels as gk

    events = 2 * sum(time_events(lambda: fused_lazy._device_phase(ctx, stacks[k], consts), RUNS)
                     for k in sizes)
    passes = []
    for _ in range(3 * PROFILE_TRIES):
        torch.cuda.synchronize()
        gk.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for k in sizes:
                for _ in range(2):
                    fused_lazy._device_phase(ctx, stacks[k], consts)
            torch.cuda.synchronize()
        traced = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type().name == "CUDA"
                  and ("gkr_phase_tail" in e.name() or "gkr_big_round" in e.name())]
        if len(traced) == sum(gk.launches.values()):
            passes.append(sum(traced))
        if len(passes) == 3:
            break
    cs.check(passes, "the walk's phases: no profile traced every launch")
    return events, statistics.median(passes) / 1e6


def tail_part(tag: str) -> None:
    """gkr_phase_tail alone and in the walk's phases under each threshold,
    and the phase kernels' device ms in one layer walk (see the module's
    docstring)."""
    if importlib.util.find_spec("zktpu_torch.gkr.kernels") is None:
        print(f"{tag} no gkr_phase_tail in this tree", flush=True)
        return
    from zktpu_torch.gkr import kernels as gk

    ctx = fb.get_ctx(BLS12_381_FR)
    rng = np.random.default_rng(2)
    transcript = Transcript(ctx.spec)
    transcript.append_field_elements([1, 2])
    pairs, tail = transcript.sponge().state_lanes()
    consts = fused_lazy._PhaseConsts(ctx, kd.pairs_to_lanes(pairs), kd.bytes_to_lanes(tail))
    stacks = {k: cs.random_table(ctx, rng, 2, 2, 1 << k) for k in range(1, 21)}
    state = cs.random_lanes(rng, 25, ctx.device)
    r = cs.random_table(ctx, rng)
    tail_lanes = cs.random_lanes(rng, 8, ctx.device)
    tails = {k: stacks[k] if k in stacks else cs.random_table(ctx, rng, 2, 2, 1 << k)
             for k, _ in TAIL_SIZES}
    kept = getattr(gk, "BLOCK_MAX", None)
    try:
        for block_max in (BLOCK_MAX_CHOICES if kept is not None else (None,)):
            if block_max is not None:
                gk.BLOCK_MAX = block_max
            line = []
            for k, fold in TAIL_SIZES:
                args = (r, state, None) if fold else (None, state, tail_lanes)
                if k <= 11:
                    got = gk.gkr_phase_tail(ctx, tails[k], *args)
                    want = gk.gkr_phase_tail_plain(ctx, tails[k], *args)
                    cs.check(cs.phase_err(got, want) == 0,
                             f"gkr_phase_tail differs from its plain version at 2^{k}")
                ms = time_events(lambda: gk.gkr_phase_tail(ctx, tails[k], *args), RUNS)
                us = launch_us(lambda: gk.gkr_phase_tail(ctx, tails[k], *args), "gkr_phase_tail")
                rounds = gk.tail_rounds(1 << k, fold)
                line.append(f"2^{k} {'after a fold' if fold else 'first'} {ms:.4f} ms, device "
                            f"{us:.2f} us ({us / rounds:.2f} a round of {rounds})")
            label = "" if block_max is None else f" BLOCK_MAX 2^{block_max.bit_length() - 1}"
            print(f"{tag} gkr_phase_tail{label} (CUDA events, warm; device us by the profiler): "
                  + "; ".join(line), flush=True)
            events, device = walk_ms(ctx, stacks, consts)
            print(f"{tag} the walk's 40 phases{label}, TAIL_MAX 2^"
                  f"{fused_lazy.TAIL_MAX.bit_length() - 1}: {events:.4f} ms (CUDA events), "
                  f"device {device:.4f} ms", flush=True)
    finally:
        if kept is not None:
            gk.BLOCK_MAX = kept
    phase_tail_max(tag, ctx, stacks, consts)
    walk_kernels(tag, ctx, gk)


def phase_tail_max(tag: str, ctx, stacks, consts) -> None:
    """A whole fused GKR phase at 2^14 to 2^20 under each TAIL_MAX_CHOICES
    threshold (ms by CUDA events, median of 20, warm), and the walk's 40
    phases summed, by CUDA events and device ms (sizes below 2^14 run one tail
    under every threshold: timed once)."""

    def phase_ms(k):
        return time_events(lambda: fused_lazy._device_phase(ctx, stacks[k], consts), RUNS)

    small = walk_ms(ctx, stacks, consts, range(1, 14))
    kept = fused_lazy.TAIL_MAX
    try:
        for tail_max in TAIL_MAX_CHOICES:
            fused_lazy.TAIL_MAX = tail_max
            row = {k: phase_ms(k) for k in range(14, 21)}
            large = walk_ms(ctx, stacks, consts, range(14, 21))
            print(f"{tag} a fused GKR phase with TAIL_MAX 2^{tail_max.bit_length() - 1}, ms: "
                  + ", ".join(f"2^{k} {ms:.4f}" for k, ms in row.items())
                  + f"; the walk's 40 phases {small[0] + large[0]:.3f} ms (CUDA events), device "
                  f"{small[1] + large[1]:.4f} ms", flush=True)
    finally:
        fused_lazy.TAIL_MAX = kept


def walk_kernels(tag: str, ctx, gk) -> None:
    """Device ms and launches of each phase kernel in one warm ``prove_layers``
    of chip_smoke.py's 2^20-input circuit (the layer walk), by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    structure, inputs = cs.gkr_benchmark(20)
    circuit = Circuit(ctx, structure)
    gkr.prove_layers(circuit, inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gkr.prove_layers(circuit, inputs)
        torch.cuda.synchronize()
    ms = {name: 0.0 for name in gk.KERNEL_NAMES}
    n = {name: 0 for name in gk.KERNEL_NAMES}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            for name in gk.KERNEL_NAMES:
                if f"{name}_kernel" in e.name():
                    ms[name] += e.duration_ns() / 1e6
                    n[name] += 1
    print(f"{tag} one prove_layers at 2^20 inputs, device ms (kernels): "
          + ", ".join(f"{name} {ms[name]:.4f} ({n[name]})" for name in gk.KERNEL_NAMES), flush=True)


def sums_sizes(tag: str) -> None:
    ctx = fb.get_ctx(BN254_FQ)
    rng = np.random.default_rng(4)
    r = cs.random_table(ctx, rng)
    lines = {"halves_sums": [], "fold_and_halves": []}
    for k in range(1, 25):
        table = cs.random_table(ctx, rng, 1 << k)
        calls = {"halves_sums": (lambda: fk.halves_sums(ctx, table),
                                 lambda: fk.halves_sums_plain(ctx, table)),
                 "fold_and_halves": (lambda: fk.fold_and_halves(ctx, table, r),
                                     lambda: fk.fold_and_halves_plain(ctx, table, r))}
        for name, (kernel, plain) in calls.items():
            if k <= 16:
                got, want = kernel(), plain()
                same = (torch.equal(got, want) if name == "halves_sums"
                        else all(torch.equal(g, v) for g, v in zip(got, want)))
                cs.check(same, f"{name} differs from its plain version at 2^{k}")
            own, finish = device_us(kernel, name, 50 if k <= 16 else 10)
            lines[name].append(f"2^{k} {own:.2f}+{finish:.2f}")
        del table
    for name, line in lines.items():
        print(f"{tag} {name} us (kernel+finish_rows): " + ", ".join(line), flush=True)

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    out = []
    for k in (20, 24):
        table = cs.random_table(ctx, rng, 1 << k)
        half = table.shape[0] // 2
        for name, fn in (("halves_sums", lambda: fk.halves_sums(ctx, table)),
                         ("fold_and_halves", lambda: fk.fold_and_halves(ctx, table, r)),
                         ("torch.sum", lambda: torch.sum(table.view(2, half, ctx.num_words),
                                                         dim=1, dtype=torch.int64))):
            cold = time_events(fn, RUNS, flush)
            clean = time_read_flush(fn, RUNS, flush)
            warm = time_events(fn, RUNS)
            out.append(f"{name} 2^{k} {cold:.4f} / {clean:.4f} / {warm:.4f}")
        del table
    print(f"{tag} ms cold / cold, L2 flushed by a read / warm: " + "; ".join(out), flush=True)


def time_read_flush(fn, runs: int, flush) -> float:
    """As ``roofline.time_events`` with L2 flushed, but flushed by reading
    ``flush``, not writing it: L2 then holds clean lines, and the timed call
    has no dirty lines to write back as it evicts them."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        flush.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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
        ms = time_events(lambda: nk.ntt_phase1(rctx, x, tw, nk.LOG_TILE), RUNS, flush)
        out.append(f"ntt_phase1 2^{log_n} {ms:.4f} ms")
    fq = fb.get_ctx(BLS12_381_FQ)
    n = 1 << 20
    p1, p2 = cs.random_points(rng, n, fq.device), cs.random_points(rng, n, fq.device)
    out.append(f"point_add 2^20 {time_events(lambda: pk.point_add(fq, p1, p2), RUNS, flush):.4f} ms")
    out.append(f"point_double 2^20 {time_events(lambda: pk.point_double(fq, p1), RUNS, flush):.4f} ms")
    print(f"{tag} " + "; ".join(out), flush=True)


def first_round(points, scalars_batch, c: int):
    """The presorted keys and points of the first window group of an MSM of
    ``scalars_batch`` (S, m, 8) against ``points``, and its rounds' widths."""
    S, m = scalars_batch.shape[:2]
    num_windows = 256 // c
    nbuck = (1 << (c - 1)) + 1
    wg = pp._pick_window_group(m, S * num_windows)
    abs_d, signs = pp._recode_signed(scalars_batch.reshape(S * m, -1), c)
    shape = (S * num_windows // wg, wg, m)
    abs_d = abs_d.reshape(num_windows, S, m).transpose(0, 1).reshape(shape)
    signs = signs.reshape(num_windows, S, m).transpose(0, 1).reshape(shape)
    fq = pp.dc.fq_ctx(points[0].device)
    neg_y = fb.sub(fq, torch.zeros_like(points[1]), points[1])
    skey, pt = pp._presort(points, neg_y, abs_d[0], signs[0], nbuck)
    return skey, pt, pp._compaction_schedule(skey.shape[0], wg * nbuck + 1)


def time_run_scan(flush, skey, l_next: int) -> str:
    """run_scan on one round, held against its plain version first: CUDA events
    (median, L2 flushed) and the device microseconds of each of its kernels."""
    got, want = mk.run_scan(skey, l_next), mk.run_scan_plain(skey, l_next)
    cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
             f"run_scan differs from its plain version on {skey.shape[0]} keys")
    ms = time_events(lambda: mk.run_scan(skey, l_next), RUNS, flush)
    split = " + ".join(f"{name} {us:.2f}" for name, us in
                       kernel_us(lambda: mk.run_scan(skey, l_next), "run_scan").items())
    return f"{skey.shape[0]} keys -> {l_next} slots {ms:.4f} ms (device us {split})"


def time_compact_add(flush, skey, pt, l_next: int) -> str:
    scan = mk.run_scan(skey, l_next)
    ms = time_events(lambda: mk.compact_add(skey, pt, *scan[:2]), RUNS, flush)
    return f"{skey.shape[0]} keys -> {l_next} slots {ms:.4f} ms"


def msm_kernels(tag: str) -> None:
    """compact_add and horner at the KZG path's shapes (see the module's
    docstring)."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    gctx = fb.get_ctx(BLS12_381_FR)
    n = cs.GKR_NUM_VARS
    _, inputs = cs.gkr_benchmark(n)
    poly = MultilinearPoly.from_ints(gctx, inputs)
    kzg = KZG.for_poly(poly, cs.gkr_benchmark_taus(n))
    scalars = fk.from_mont(gctx, poly.table)
    point = [(7 * k + 3) << 40 for k in range(n)]
    quotients = kzg._quotients(kzg.open(point, poly), point, poly)
    bases = kzg.collapsed_bases()

    out, scans = [], []
    c = pp.pick_window_bits(1 << n)
    skey, pt, sizes = first_round(kzg.g1_lagrange_basis, scalars[None], c)
    scans.append("commitment first round " + time_run_scan(flush, skey, sizes[0]))
    out.append("commitment first round " + time_compact_add(flush, skey, pt, sizes[0]))
    for l_next in sizes:
        skey, pt = pp._compact_round(skey, pt, l_next)
    scans.append("commitment steady round " + time_run_scan(flush, skey, sizes[-1]))
    out.append("commitment steady round " + time_compact_add(flush, skey, pt, sizes[-1]))
    stack0 = torch.stack([quotients[0], quotients[0].flip(0)])
    skey, pt, sizes = first_round(bases[0], stack0, pp.pick_window_bits_multi(*stack0.shape[:2]))
    scans.append("quotient step 0 first round " + time_run_scan(flush, skey, sizes[0]))
    out.append("quotient step 0 first round " + time_compact_add(flush, skey, pt, sizes[0]))
    del skey, pt
    print(f"{tag} run_scan ms: " + "; ".join(scans), flush=True)
    print(f"{tag} compact_add ms: " + "; ".join(out), flush=True)

    per_window = tuple(v.contiguous() for v in pp._window_sums(kzg.g1_lagrange_basis,
                                                               scalars[None], c))
    shapes = [("commitment, 1 segment", per_window, c)]
    groups = []
    for k, q in enumerate(quotients):
        stack = torch.stack([q, q.flip(0)])
        ck = pp.pick_window_bits_multi(*stack.shape[:2])
        pw = tuple(v.contiguous() for v in pp._window_sums(bases[k], stack, ck))
        groups.append((pw, ck))
        if k == 0 or ck != groups[k - 1][1]:
            shapes.append((f"quotient step {k}, 2 segments", pw, ck))
    out = [f"{label}, c = {cc}: {time_events(lambda: mk.horner(pw, cc), RUNS, flush):.4f} ms"
           for label, pw, cc in shapes]
    ms = time_events(lambda: [mk.horner(pw, cc) for pw, cc in groups], RUNS, flush)
    out.append(f"quotient commit, a launch a step: {ms:.4f} ms")
    if hasattr(mk, "horner_groups"):
        ms = time_events(lambda: mk.horner_groups(groups), RUNS, flush)
        out.append(f"quotient commit, one launch: {ms:.4f} ms")
    print(f"{tag} horner ms: " + "; ".join(out), flush=True)


def transcript_kernels(tag: str) -> None:
    """round_step at ROUND_SHAPES and keccak_f (see the module's docstring)."""
    rng = np.random.default_rng(17)
    out = []
    for label, spec, k, tail in ROUND_SHAPES:
        ctx = fb.get_ctx(spec)
        rows, state, tail_lanes = cs.round_check_inputs(ctx, rng, k, tail, 3)
        got = tk.round_step(ctx, rows, state, tail_lanes)
        want = tk.round_step_plain(ctx, rows, state, tail_lanes)
        cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                 f"round_step differs from its plain version on a {label}")
        us = launch_us(lambda: tk.round_step(ctx, rows, state, tail_lanes), "round_step", 200)
        out.append(f"{label} {us:.3f} us")
    for states, runs in ((1, 200), (4096, 20)):
        x = cs.random_lanes(rng, 25 * states, torch.device("cuda")).reshape(states, 25)
        cs.check(torch.equal(tk.keccak_f(x), tk.keccak_f_plain(x)),
                 f"keccak_f differs from its plain version on {states} states")
        us = launch_us(lambda: tk.keccak_f(x), "keccak_f", runs)
        out.append(f"keccak_f {states} state(s) {us:.3f} us")
    print(f"{tag} transcript, device us a launch: " + "; ".join(out), flush=True)


def main() -> int:
    parts = sys.argv[2:] or list(PARTS)
    if not torch.cuda.is_available() or len(sys.argv) < 2 or not set(parts) <= set(PARTS):
        print("usage, on a machine with a CUDA device: time_kernels.py TAG [PART ...], "
              f"PART in {PARTS}", file=sys.stderr)
        return 1
    tag = sys.argv[1]
    _build.build_cuda_libraries(list(cs.CUDA_STEMS))
    fk.library()
    nk.library()
    pk.library()
    mk.library()
    tk.library()
    usage = []
    for stem, needle in (("ntt_kernels", "ntt_phase1_kernel"),
                         ("sumcheck_kernels", "gkr_round_kernel"),
                         ("sumcheck_kernels", "halves_sums_kernel"),
                         ("sumcheck_kernels", "fold_and_halves_kernel"),
                         ("msm_kernels", "run_scan"),
                         ("msm_kernels", "compact_add_kernel"),
                         ("msm_kernels", "horner_kernel"),
                         ("transcript_kernels", "round_step_kernel"),
                         ("transcript_kernels", "keccak_f_kernel"),
                         ("gkr_phase_kernels", "gkr_big_round_kernel"),
                         ("gkr_phase_kernels", "gkr_phase_tail_kernel")):
        if stem in cs.CUDA_STEMS:
            usage += cs.resource_usage(_build.build_log[stem], needle)
    print(f"{tag} " + " | ".join(usage), flush=True)
    for part, fn in (("gkr", gkr_round_sizes), ("tail", tail_part), ("ntt", ntt_and_points),
                     ("sums", sums_sizes),
                     ("msm", msm_kernels), ("transcript", transcript_kernels)):
        if part in parts:
            fn(tag)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
