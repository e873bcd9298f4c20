"""The port's bit-split MSM, ladder and fixed-base comb vs the host curve oracle
and zktpu, on the CPU: the cases of tests/test_msm.py with the same seeds and
sizes. Tolerance 0: the same affine points."""

import numpy as np
import pytest
import torch

from zktpu.curve import device as jdc
from zktpu.msm import generator_comb_mul as jgenerator_comb_mul

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.msm import fixed_base, generator_comb_mul
from zktpu_torch.msm.bit_split import msm_bitsplit_host

torch.set_num_threads(1)


def _host_msm(pts, scalars):
    expect = None
    for p, s in zip(pts, scalars):
        expect = hc.add(expect, hc.multiply(p, s))
    return expect


@pytest.fixture(scope="module")
def sample():
    rng = np.random.default_rng(11)
    n = 8
    ks = [int(k) for k in rng.integers(1, 1 << 40, size=n)]
    pts = [hc.multiply(hc.G1_GEN, k) for k in ks]
    scalars = [int(a) * int(b) % hc.R_ORDER for a, b in rng.integers(1, 1 << 62, size=(n, 2))]
    return pts, scalars


EDGE_POINTS = [hc.G1_GEN, hc.multiply(hc.G1_GEN, 5), None]
# zero scalar, order-1 scalar, scalar on the infinity point
EDGE_SCALARS = [0, hc.R_ORDER - 1, 7]
EDGE_EXPECT = hc.neg(hc.multiply(hc.G1_GEN, 5))


def test_bitsplit_matches_host(sample):
    pts, scalars = sample
    assert msm_bitsplit_host(pts, scalars, device="cpu") == _host_msm(pts, scalars)


def test_bitsplit_edge_cases():
    assert msm_bitsplit_host(EDGE_POINTS, EDGE_SCALARS, device="cpu") == EDGE_EXPECT


def test_ladder_msm_matches_host(sample):
    pts, scalars = sample
    assert dc.msm_host(pts[:3], scalars[:3], device="cpu") == _host_msm(pts[:3], scalars[:3])


def test_generator_comb(sample):
    _, scalars = sample
    all_scalars = scalars + [0, 1, hc.R_ORDER - 1]
    jac = generator_comb_mul(dc.pack_scalars(all_scalars, "cpu"))
    affs = dc.unpack_points(jac)
    for s, a in zip(all_scalars, affs):
        assert a == (hc.multiply(hc.G1_GEN, s) if s else None)
    jaffs = jdc.unpack_points(jgenerator_comb_mul(jdc.pack_scalars(all_scalars)))
    assert affs == [convert.host_point_from_zktpu(pt) for pt in jaffs]


def test_comb_matches_ladder(sample):
    _, scalars = sample
    sc = dc.pack_scalars(scalars, "cpu")
    a = dc.unpack_points(generator_comb_mul(sc))
    b = dc.unpack_points(dc.batch_generator_mul(sc))
    assert a == b


def test_comb_table_rows():
    """T[w * 256 + d] = d * 2^(8w) * G, held once a device."""
    table = fixed_base._comb_table("cpu")
    assert fixed_base._comb_table(torch.device("cpu")) is table
    assert all(tuple(t.shape) == (32 * 256, 12) for t in table)
    rows = [0, 1, 2, 255, 256 + 3, 31 * 256 + 127]
    got = dc.unpack_points(dc.gather_pt(table, torch.tensor(rows)))
    want = [hc.multiply(hc.G1_GEN, (r % 256) << (8 * (r // 256))) for r in rows]
    assert got == want
