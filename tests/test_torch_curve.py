"""The port's G1 point operations and host curve vs zktpu's, on the CPU.

The same Jacobian words go through ``zktpu.curve.device.point_add`` /
``point_double`` (plain JAX on the CPU, as zktpu's own tests run them) and
through the port's wrappers, which take their plain PyTorch versions because the
tensors lie on the CPU. Tolerance 0: the Jacobian words must be equal word for
word, lanes of no meaning included. The host curve copy is held against zktpu's
on ``multiply``, ``add`` and one pairing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.curve import bls12_381 as jhc
from zktpu.curve import device as jdc

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.curve import point_kernels as pk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FQ

torch.set_num_threads(1)

P = BLS12_381_FQ.modulus
ctx = fb.get_ctx(BLS12_381_FQ, device="cpu")


def _to_j(pt):
    return tuple(jnp.asarray(c) for c in convert.points_to_zktpu(pt))


def _equal(got, jwant) -> bool:
    want = convert.points_from_zktpu([np.asarray(c) for c in jwant])
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _host_points(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [hc.multiply(hc.G1_GEN, int(k)) for k in rng.integers(1, 1 << 40, size=n)]


@pytest.fixture(scope="module")
def batches():
    """Two batches of 8 random points with Z == 1, and the same with Z != 1 (the
    sums and doublings of the first two, whose words zktpu agrees on)."""
    a = dc.pack_points(_host_points(41, 8), "cpu")
    b = dc.pack_points(_host_points(43, 8), "cpu")
    return a, b, dc.point_add(a, b), dc.point_double(b)


def _raw(values):
    """Reduced integers taken as Montgomery words, as they are."""
    return ctx.to_device(ctx.pack(values))


def _edge_cases(batches):
    a, b, s, d = batches
    inf = dc.infinity_like((8,), "cpu")
    neg_b = (b[0], fb.sub(ctx, torch.zeros_like(b[1]), b[1]), b[2])
    # 2a in another Jacobian form than d: (a + b) + (a - b), so that P == Q
    # meets with Z != 1 on both sides and unequal coordinates
    two_a = dc.point_add(s, dc.point_add(a, neg_b))
    weird = (_raw([0, P - 1, 1, 0, P - 1, 5, 0, P - 1]),
             _raw([P - 1, 0, P - 1, 1, 0, 0, P - 1, P - 1]),
             _raw([1, 1, P - 1, P - 1, 0, 2, 0, 7]))
    mixed = tuple(torch.cat([x[:3], y[3:6], z[6:]]) for x, y, z in zip(a, inf, b))
    return {
        "random_affine": (a, b),
        "z_not_one_both": (s, d),
        "z_not_one_left": (s, b),
        "p_equals_q_affine": (a, a),
        "p_equals_q_jacobian": (dc.point_double(a), two_a),
        "p_equals_minus_q": (b, neg_b),
        "left_infinite": (inf, b),
        "right_infinite": (s, inf),
        "both_infinite": (inf, inf),
        "infinity_mixed_lanes": (mixed, s),
        "coordinates_0_and_p_minus_1": (weird, tuple(t.flip(0).contiguous() for t in weird)),
        "coordinates_against_points": (weird, d),
    }


CASES = ["random_affine", "z_not_one_both", "z_not_one_left", "p_equals_q_affine",
         "p_equals_q_jacobian", "p_equals_minus_q", "left_infinite", "right_infinite",
         "both_infinite", "infinity_mixed_lanes", "coordinates_0_and_p_minus_1",
         "coordinates_against_points"]


@pytest.mark.parametrize("name", CASES)
def test_point_add_words_equal_zktpu(batches, name):
    p1, p2 = _edge_cases(batches)[name]
    got = dc.point_add(p1, p2)
    assert all(t.dtype == torch.int32 and tuple(t.shape) == (8, 12) for t in got)
    assert _equal(got, jdc.point_add(_to_j(p1), _to_j(p2)))
    assert all(torch.equal(g, w) for g, w in zip(got, pk.point_add_plain(ctx, p1, p2)))


@pytest.mark.parametrize("name", ["random_affine", "z_not_one_both", "both_infinite",
                                  "coordinates_0_and_p_minus_1"])
def test_point_double_words_equal_zktpu(batches, name):
    pt = _edge_cases(batches)[name][0]
    got = dc.point_double(pt)
    assert _equal(got, jdc.point_double(_to_j(pt)))
    assert all(torch.equal(g, w) for g, w in zip(got, pk.point_double_plain(ctx, pt)))


def test_edge_cases_are_the_group_law(batches):
    a, b, s, d = batches
    cases = _edge_cases(batches)
    pa, pb = _host_points(41, 8), _host_points(43, 8)
    assert dc.unpack_points(s) == [hc.add(x, y) for x, y in zip(pa, pb)]
    assert dc.unpack_points(d) == [hc.double(y) for y in pb]
    assert dc.unpack_points(dc.point_add(*cases["p_equals_q_jacobian"])) == [
        hc.multiply(x, 4) for x in pa]
    assert dc.unpack_points(dc.point_add(*cases["p_equals_minus_q"])) == [None] * 8
    assert dc.unpack_points(dc.point_add(*cases["both_infinite"])) == [None] * 8
    assert dc.unpack_points(dc.point_add(*cases["left_infinite"])) == pb
    assert dc.unpack_points(dc.point_double(dc.infinity_like((3,), "cpu"))) == [None] * 3


def test_pack_unpack_round_trip():
    pts = _host_points(47, 5) + [None, hc.G1_GEN]
    packed = dc.pack_points(pts, "cpu")
    assert all(t.dtype == torch.int32 and tuple(t.shape) == (7, 12) for t in packed)
    assert dc.unpack_points(packed) == pts
    jpacked = jdc.pack_points([convert_host(pt) for pt in pts])
    assert _equal(packed, jpacked)
    assert torch.equal(packed[2][5], torch.zeros(12, dtype=torch.int32))
    inf = dc.infinity_like((2, 3), "cpu")
    assert tuple(inf[0].shape) == (2, 3, 12) and dc.unpack_points(inf) == [None] * 6
    jinf = jdc.infinity_like((6,))
    assert _equal(tuple(t.reshape(6, 12) for t in inf), jinf)


def convert_host(pt):
    """The port's host point over zktpu's field class."""
    return None if pt is None else (jhc.FQ(pt[0].n), jhc.FQ(pt[1].n))


def test_points_convert_both_ways_and_limb_major(batches):
    s = batches[2]
    digits = convert.points_to_zktpu(s)
    assert all(d.shape == (8, 24) and d.dtype == np.uint32 for d in digits)
    back = convert.points_from_zktpu(digits)
    assert all(torch.equal(x, y) for x, y in zip(back, s))
    lm = convert.points_to_zktpu(s, limb_major=True)
    assert all(d.shape == (24, 8) for d in lm)
    back = convert.points_from_zktpu(lm, limb_major=True)
    assert all(torch.equal(x, y) for x, y in zip(back, s))
    assert jdc.unpack_points(tuple(jnp.asarray(d) for d in digits)) == [
        convert_host(pt) for pt in dc.unpack_points(s)]
    sc = dc.pack_scalars([0, 1, hc.R_ORDER - 1, hc.R_ORDER + 5], "cpu")
    assert np.array_equal(convert.scalars_to_zktpu(sc), np.asarray(jdc.pack_scalars(
        [0, 1, hc.R_ORDER - 1, hc.R_ORDER + 5])))
    assert torch.equal(convert.scalars_from_zktpu(convert.scalars_to_zktpu(sc)), sc)


@pytest.mark.parametrize("k", [1, 2, 0xDEADBEEF, hc.R_ORDER - 1, hc.R_ORDER])
def test_host_curve_copy_multiply_and_add(k):
    got = hc.multiply(hc.G1_GEN, k)
    assert convert_host(got) == jhc.multiply(jhc.G1_GEN, k)
    if got is not None:
        assert hc.is_on_curve(got, hc.B1)
        assert convert_host(hc.add(got, hc.G1_GEN)) == jhc.add(jhc.multiply(jhc.G1_GEN, k), jhc.G1_GEN)
        assert hc.add(got, hc.neg(got)) is None
    g2 = hc.multiply(hc.G2_GEN, k)
    assert convert.host_point_from_zktpu(jhc.multiply(jhc.G2_GEN, k)) == g2


def test_host_curve_copy_pairing():
    a, b = 5, 7
    lhs = hc.pairing(hc.multiply(hc.G1_GEN, a), hc.multiply(hc.G2_GEN, b))
    assert lhs.coeffs == jhc.pairing(jhc.multiply(jhc.G1_GEN, a), jhc.multiply(jhc.G2_GEN, b)).coeffs
    assert hc.pairing_product_equals(
        [(hc.multiply(hc.G1_GEN, a), hc.multiply(hc.G2_GEN, b))],
        [(hc.multiply(hc.G1_GEN, a * b), hc.G2_GEN)],
    )
    assert not hc.pairing_product_equals(
        [(hc.multiply(hc.G1_GEN, a), hc.multiply(hc.G2_GEN, b))],
        [(hc.multiply(hc.G1_GEN, a * b + 1), hc.G2_GEN)],
    )


def test_ladder_and_tree_sum_small():
    pts = _host_points(53, 3)
    scalars = [0, 5, hc.R_ORDER - 2]
    sc = dc.pack_scalars(scalars, "cpu")
    got = dc.unpack_points(dc.batch_scalar_mul(dc.pack_points(pts, "cpu"), sc))
    assert got == [hc.multiply(p, s) if s else None for p, s in zip(pts, scalars)]
    total = dc.tree_sum_points(dc.pack_points(pts, "cpu"))
    assert dc.unpack_points(tuple(t[None] for t in total)) == [hc.add(hc.add(pts[0], pts[1]), pts[2])]
