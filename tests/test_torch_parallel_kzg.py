"""KZG under a mesh: the sharded commitment at the real ``MIN_ROWS_PER_DEVICE``
(256) and the segment-sharded batched MSM of the quotient steps, on the CPU.

A 2^9-entry commitment under a 2-slot mesh gives each slot 256 points and takes
``msm_pippenger_sharded``: counted by a spy on the call, never by a patched
threshold. The batched MSM of a quotient step pads its segments to a multiple
of the slots with zero scalars and drops the pads; its results are held against
the host curve, the port's single-device batched MSM and zktpu's sharded one on
its 8-device CPU mesh. A CPU MSM costs 11-20 s a call whatever its size, so
the port's meshes have 2 slots here. Group elements are compared (the Jacobian
words differ where the window does). Tolerance 0.
"""

import numpy as np
import pytest
import torch

from zktpu.curve import device as jdc
from zktpu.parallel import mesh as jpm

from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR
from zktpu_torch.msm import pippenger as pp
from zktpu_torch.parallel import context as pctx
from zktpu_torch.parallel import mesh as pm
from zktpu_torch.pcs.kzg import KZG
from zktpu_torch.poly.multilinear import MultilinearPoly

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")


def _host_msm(pts, scalars):
    expect = None
    for p, s in zip(pts, scalars):
        expect = hc.add(expect, hc.multiply(p, s))
    return expect


@pytest.fixture
def spy(monkeypatch):
    """Calls of ``parallel.mesh.msm_pippenger_sharded``."""
    calls = {"msm_pippenger_sharded": 0}
    real = pm.msm_pippenger_sharded

    def counted(*args, **kwargs):
        calls["msm_pippenger_sharded"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(pm, "msm_pippenger_sharded", counted)
    return calls


def test_kzg_commit_shards_at_256_points_a_slot(spy):
    """2^9 entries under 2 slots: 256 points a slot, the sharded MSM (one call,
    no threshold patched); the commitment is the host's poly(taus) * G1, which
    is the single-device commitment's (test_torch_kzg.py)."""
    rng = np.random.default_rng(12)
    taus = [int(t) for t in rng.integers(2, 1 << 60, size=9)]
    poly = MultilinearPoly.from_ints(ctx, [int(v) for v in rng.integers(0, 1 << 62, size=512)])
    kzg = KZG.setup(9, taus, device="cpu")
    two = pm.make_mesh(devices=["cpu"] * 2)
    assert pctx.shardable(512, two) and not pctx.shardable(510, two)
    with pctx.use_mesh(two):
        commitment = kzg.commit(poly)
    assert spy["msm_pippenger_sharded"] == 1
    assert commitment == hc.multiply(hc.G1_GEN, poly.evaluate_int(taus))


def test_sharded_pippenger_multi_pads_and_drops_segments():
    """Three segments of one base on 2 slots: padded to four by a segment of
    zero scalars, which is dropped; each segment is the host's MSM, the port's
    single-device batched MSM's and zktpu's sharded one's (8 devices: five
    zero segments)."""
    rng = np.random.default_rng(6)
    m, S = 16, 3
    base_host = [hc.multiply(hc.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, size=m)]
    rows = [[int(v) for v in rng.integers(0, 1 << 62, size=m)] for _ in range(S)]
    rows[1][3] = 0
    want = [_host_msm(base_host, row) for row in rows]

    base = dc.pack_points(base_host, "cpu")
    stacked = torch.stack([dc.pack_scalars(row, "cpu") for row in rows])
    got = pm.msm_pippenger_multi_sharded(pm.make_mesh(devices=["cpu"] * 2), base, stacked)
    assert all(tuple(v.shape) == (S, 12) for v in got)
    assert dc.unpack_points(got) == want == dc.unpack_points(pp.msm_pippenger_multi(base, stacked))

    jgot = jpm.msm_pippenger_multi_sharded(
        jpm.make_mesh(8), jdc.pack_points(base_host),
        np.stack([np.asarray(jdc.pack_scalars(row)) for row in rows]))
    assert [None if pt is None else (hc.FQ(int(pt[0].n)), hc.FQ(int(pt[1].n)))
            for pt in jdc.unpack_points(jgot)] == want
