"""One step of every sharded path of ``parallel.mesh`` over a mesh, checked
against the single-device path: the counterpart of zktpu's
``__graft_entry__.dryrun_multichip``.

    from zktpu_torch.parallel import mesh as pm
    from zktpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(pm.make_mesh())                       # every card present
    dryrun_multichip(pm.make_mesh(devices=["cuda:0"] * 4))  # four slots on one card

Unlike zktpu's, it leaves ``MIN_ROWS_PER_DEVICE`` as it is: the sizes grow
with the mesh so that every sharded path engages with at least 256 rows a slot
(the KZG commitment of the GKR proof with exactly 256 points a slot). Tables
are made from numpy seed 0 on the device of the mesh's first slot. A result
that differs from the single device's raises ``RuntimeError``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..curve import bls12_381 as hc
from ..curve import device as dc
from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.spec import BLS12_381_FR, BN254_FR
from ..gkr import lazy as lazy_mod
from ..gkr import protocol as gkr
from ..gkr.circuit import ADD, MUL, Circuit, Layer
from ..gkr.fused_lazy import gkr_prove_lazy_fused
from ..msm import pippenger as pp
from ..ntt import ntt as tn
from ..poly.multilinear import MultilinearPoly
from ..transcript import Transcript
from . import context as pctx
from . import mesh as pm


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dryrun_multichip(mesh: pm.Mesh) -> dict[str, float]:
    """Run and check one step of each sharded path over ``mesh``; returns the
    seconds of each step (host clock, synchronised)."""
    d = mesh.size
    home = mesh.devices[0]
    rows = pctx.MIN_ROWS_PER_DEVICE
    # a power of two with at least 256 rows a slot, and at least 2^13
    size = 1 << max(13, (rows * d - 1).bit_length())
    ctx = fb.get_ctx(BLS12_381_FR, home)
    rng = np.random.default_rng(0)
    seconds = {}

    def step(name, fn):
        _sync(home)
        t0 = time.time()
        fn()
        _sync(home)
        seconds[name] = time.time() - t0

    # a sharded sumcheck round: the half sums and the fold of each shard
    poly = MultilinearPoly.from_ints(ctx, [int(v) for v in rng.integers(0, 1 << 60, size=size)])
    r_mont = poly.encode_scalar(7)

    def sumcheck_round():
        sharded = pm.ShardedMLE.shard(poly, mesh)
        _require(sharded.halves_sums()
                 == fk.lazy_rows_to_ints(ctx, fk.halves_sums(ctx, poly.table)),
                 "sharded half sums differ")
        _require(torch.equal(sharded.fold(r_mont).gather().table, fk.fold(ctx, poly.table, r_mont)),
                 "sharded fold differs")

    step("sumcheck round", sumcheck_round)

    # the lazy-GKR sumcheck of a layer of size / 2 gates
    n_gates = size // 2
    ops = [ADD if bit else MUL for bit in rng.integers(2, size=n_gates)]
    w = MultilinearPoly.from_ints(ctx, [int(v) for v in rng.integers(0, 1 << 60, size=size)])
    r_b = [int(v) for v in rng.integers(1, 1 << 60, size=n_gates.bit_length() - 1)]
    fbc = lazy_mod.lazy_folded_fbc(ctx, Layer(ops), w, r_b, r_b, 3, 5)

    def lazy_gkr():
        sharded = pm.gkr_sumcheck_lazy_sharded(777, fbc, Transcript(BLS12_381_FR), mesh)
        single = gkr_prove_lazy_fused(777, fbc, Transcript(BLS12_381_FR))
        _require([p.coefficients for p in sharded.proof_polynomials]
                 == [p.coefficients for p in single.proof_polynomials],
                 "sharded lazy-GKR sumcheck differs")

    step("lazy-GKR sumcheck", lazy_gkr)

    # the four-step NTT, forward and back
    fr = fb.get_ctx(BN254_FR, home)
    words = rng.integers(0, 1 << 32, size=(size, fr.num_words), dtype=np.uint32)
    table = fk.to_mont(fr, fr.to_device(words))

    def ntt():
        out = pm.ntt_sharded(fr, mesh, table)
        _require(torch.equal(out, tn.ntt(fr, table)), "ntt_sharded differs from ntt")
        _require(torch.equal(pm.ntt_sharded(fr, mesh, out, inverse=True), table),
                 "the inverse ntt_sharded is not the inverse")

    step("ntt", ntt)

    # Pippenger with 256 points a slot, and the point tree alone
    n_pts = rows * d
    base = [hc.multiply(hc.G1_GEN, k + 1) for k in range(8)]
    pts = dc.pack_points([base[i % 8] for i in range(n_pts)], home)
    scalars = dc.pack_scalars([int(v) for v in rng.integers(1, 1 << 62, size=n_pts)], home)

    def point(jac):
        return dc.unpack_points(tuple(t[None] for t in jac))[0]

    def pippenger():
        _require(pctx.shardable(n_pts, mesh), "the MSM does not reach MIN_ROWS_PER_DEVICE")
        _require(point(pm.msm_pippenger_sharded(mesh, pts, scalars))
                 == point(pp.msm_pippenger(pts, scalars)), "msm_pippenger_sharded differs")

    step("msm_pippenger", pippenger)

    def tree():
        _require(point(pm.point_tree_sum_sharded(mesh, pts)) == point(dc.tree_sum_points(pts)),
                 "point_tree_sum_sharded differs")

    step("point tree", tree)

    # the whole GKR proof of a halving circuit of 256 inputs a slot: sharded
    # layers and a sharded commitment, then verified
    structure, gates = [], n_pts // 2
    while gates >= 1:
        structure.append([ADD if bit else MUL for bit in rng.integers(2, size=gates)])
        gates //= 2
    circuit = Circuit(ctx, structure)
    inputs = [int(v) for v in rng.integers(0, 1 << 60, size=n_pts)]
    taus = [int(t) for t in rng.integers(2, 1 << 60, size=n_pts.bit_length() - 1)]

    def prove():
        proof = gkr.prove(circuit, inputs, taus=taus, mesh=mesh)
        _require(gkr.verify(proof, circuit), "the mesh gkr.prove round trip failed")

    step("gkr.prove + verify", prove)
    return seconds
