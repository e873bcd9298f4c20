"""The port's sharded MSMs (zktpu_torch.parallel.mesh) against zktpu's sharded
MSMs on its 8-device CPU mesh, the port's single-device MSMs and the host
curve, on the CPU.

tests/test_parallel.py's three MSM tests with the same seeds and points (the
segment-sharded batched MSM of the KZG quotients and the sharded commitment are
in test_torch_parallel_kzg.py). A plain point operation on the
CPU is some 10,000 eager calls (about 40 ms) and a CPU MSM costs 11-20 s a call
whatever its size (its 255-step ladder or its Horner chain), so the port's
sharded MSMs run on 2 slots (the tree sum, cheap, on 8); each slot still runs
the whole pipeline. MSM results differ in their Jacobian words where the window
or the order of the additions differs, so group elements are compared.
Tolerance 0.
"""

import numpy as np
import pytest
import torch

from zktpu.curve import device as jdc
from zktpu.parallel import mesh as jpm

from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.msm import pippenger as pp
from zktpu_torch.parallel import mesh as pm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jmesh():
    return jpm.make_mesh(8)


def _host_msm(pts, scalars):
    expect = None
    for p, s in zip(pts, scalars):
        expect = hc.add(expect, hc.multiply(p, s))
    return expect


def _point(jac):
    """A Jacobian triple of (12,) coordinates -> the host affine point."""
    return dc.unpack_points(tuple(t[None] for t in jac))[0]


def _jax_point(jac):
    """zktpu's result -> the port's host point (same FQ integers)."""
    pt = jdc.unpack_points(tuple(t[None] for t in jac))[0]
    return None if pt is None else (hc.FQ(int(pt[0].n)), hc.FQ(int(pt[1].n)))


def test_sharded_point_tree_sum(jmesh):
    pts_host = [hc.multiply(hc.G1_GEN, k) for k in range(1, 17)]
    want = hc.multiply(hc.G1_GEN, sum(range(1, 17)))
    pts = dc.pack_points(pts_host, "cpu")
    got = pm.point_tree_sum_sharded(pm.make_mesh(devices=["cpu"] * 8), pts)
    assert _point(got) == want == _point(dc.tree_sum_points(pts))
    assert _jax_point(jpm.point_tree_sum_sharded(jmesh, jdc.pack_points(pts_host))) == want
    with pytest.raises(ValueError, match="divide"):
        pm.point_tree_sum_sharded(pm.make_mesh(devices=["cpu"] * 3), pts)


def test_sharded_ladder_msm_matches_host(jmesh):
    pts_host = [hc.multiply(hc.G1_GEN, k) for k in range(1, 17)]
    scalars = list(range(3, 19))
    want = _host_msm(pts_host, scalars)
    pts, sc = dc.pack_points(pts_host, "cpu"), dc.pack_scalars(scalars, "cpu")
    got = pm.msm_sharded(pm.make_mesh(devices=["cpu"] * 2), pts, sc)
    assert _point(got) == want == _point(dc.msm(pts, sc))
    jgot = jpm.msm_sharded(jmesh, jdc.pack_points(pts_host), jdc.pack_scalars(scalars))
    assert _jax_point(jgot) == want


def test_sharded_pippenger_matches_host(jmesh):
    rng = np.random.default_rng(5)
    n = 64
    base = [hc.multiply(hc.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, size=8)]
    pts_host = [base[i % 8] for i in range(n)]
    scalars = [int(a) * int(b) % hc.R_ORDER for a, b in rng.integers(1, 1 << 62, size=(n, 2))]
    want = _host_msm(pts_host, scalars)

    pts, sc = dc.pack_points(pts_host, "cpu"), dc.pack_scalars(scalars, "cpu")
    got = pm.msm_pippenger_sharded(pm.make_mesh(devices=["cpu"] * 2), pts, sc, c=4)
    assert _point(got) == want == _point(pp.msm_pippenger(pts, sc, 4))
    jgot = jpm.msm_pippenger_sharded(jmesh, jdc.pack_points(pts_host), jdc.pack_scalars(scalars),
                                     c=4)
    assert _jax_point(jgot) == want
