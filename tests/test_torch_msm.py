"""The port's Pippenger MSM vs the host curve oracle and zktpu, on the CPU.

The Pippenger cases of tests/test_msm.py with the same seeds and sizes (the
bit-split MSM, the ladder and the comb are in test_torch_msm_ladders.py). Each result must
be the same affine point as the host loop's (and zktpu's own result, where
zktpu's run is cheap enough to repeat here: its tests pin the others to the same
host loop). Tolerance 0.
"""

import numpy as np
import pytest
import torch

from zktpu.curve import bls12_381 as jhc
from zktpu.msm.pippenger import msm_pippenger_host as jmsm_pippenger_host

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.msm import msm_bitsplit
from zktpu_torch.msm import pippenger as pp
from zktpu_torch.msm.pippenger import msm_pippenger_host, msm_pippenger_multi

torch.set_num_threads(1)


def _host_msm(pts, scalars):
    expect = None
    for p, s in zip(pts, scalars):
        expect = hc.add(expect, hc.multiply(p, s))
    return expect


def _to_j(pt):
    return None if pt is None else (jhc.FQ(pt[0].n), jhc.FQ(pt[1].n))


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


@pytest.mark.parametrize("c", [4, 8])
def test_pippenger_matches_host(sample, c):
    pts, scalars = sample
    got = msm_pippenger_host(pts, scalars, c=c, device="cpu")
    assert got == _host_msm(pts, scalars)
    if c == 4:
        want = jmsm_pippenger_host([_to_j(p) for p in pts], scalars, c=c)
        assert got == convert.host_point_from_zktpu(want)


def test_pippenger_edge_cases():
    assert msm_pippenger_host(EDGE_POINTS, EDGE_SCALARS, c=4, device="cpu") == EDGE_EXPECT


def test_pippenger_duplicate_points():
    """Duplicate (point, digit) pairs force the doubling branch inside the
    compaction tree."""
    pts = [hc.G1_GEN] * 4 + [hc.multiply(hc.G1_GEN, 3)] * 3
    scalars = [123456789] * 4 + [987654321] * 3
    expect = hc.add(
        hc.multiply(hc.G1_GEN, 4 * 123456789),
        hc.multiply(hc.G1_GEN, 9 * 987654321),
    )
    assert msm_pippenger_host(pts, scalars, c=4, device="cpu") == expect


def test_pippenger_all_scalars_equal(sample):
    """One bucket run a window: the worst-case round count of the compaction."""
    pts, _ = sample
    assert msm_pippenger_host(pts, [12345] * len(pts), c=4, device="cpu") == _host_msm(
        pts, [12345] * len(pts))


def test_pippenger_matches_bitsplit_larger():
    """128-point cross-check of two independent device strategies."""
    rng = np.random.default_rng(7)
    base = [hc.multiply(hc.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, size=8)]
    pts = [base[i % 8] for i in range(128)]
    scalars = [int(a) * int(b) % hc.R_ORDER for a, b in rng.integers(1, 1 << 62, size=(128, 2))]
    a = msm_pippenger_host(pts, scalars, c=8, device="cpu")
    packed = dc.pack_points(pts, "cpu")
    sc = dc.pack_scalars(scalars, "cpu")
    b = dc.unpack_points(tuple(t[None] for t in msm_bitsplit(packed, sc)))[0]
    assert a == b
    # the host's own sum, by the 8 distinct bases
    folded = [sum(scalars[i::8]) % hc.R_ORDER for i in range(8)]
    assert a == _host_msm(base, folded)


def test_msm_multi_matches_individual(sample):
    """Segment-batched MSM (shared base): each segment's result must equal its
    individual MSM."""
    pts, _ = sample
    rng = np.random.default_rng(17)
    packed = dc.pack_points(pts, "cpu")
    batch = [[int(a) for a in rng.integers(1, 1 << 62, size=len(pts))] for _ in range(3)]
    sc = torch.stack([dc.pack_scalars(s, "cpu") for s in batch])
    got = dc.unpack_points(msm_pippenger_multi(packed, sc, c=4))
    assert got == [_host_msm(pts, sc_ints) for sc_ints in batch]


def test_recode_signed_digits_rebuild_the_scalar(sample):
    _, scalars = sample
    values = scalars + [0, 1, hc.R_ORDER - 1, (1 << 255) - 19]
    sc = dc.pack_scalars(values, "cpu")
    for c in (4, 8, 16):
        abs_d, signs = pp._recode_signed(sc, c)
        assert tuple(abs_d.shape) == (256 // c, len(values)) and int(abs_d.max()) <= 1 << (c - 1)
        digits = torch.where(signs, -abs_d, abs_d).tolist()
        for i, v in enumerate(values):
            assert sum(digits[w][i] << (c * w) for w in range(256 // c)) == v % hc.R_ORDER


def test_window_pickers_and_groups():
    assert pp.pick_window_bits(8) == 4
    assert pp.pick_window_bits(1 << 20) == 16
    assert pp.pick_window_bits_multi(2, 1 << 19) == 16
    assert pp.pick_window_bits_multi(2, 4) == 4
    # a bucket table beyond the cap is never picked, whatever the add count says
    assert pp.pick_window_bits_multi(4096, 1 << 20) != 16
    assert pp._pick_window_group(1 << 20, 16) == 16
    assert pp._pick_window_group(1 << 24, 16) == 2
    assert pp._pick_window_group(1 << 30, 6) == 3
    sizes = pp._compaction_schedule(1 << 16, 100)
    assert sizes[0] < 1 << 16 and sizes == sorted(sizes, reverse=True) and sizes[-1] <= 202
    assert pp._compaction_schedule(10, 100) == []
