"""``point_double`` with a repeat count, and the card as the default device of
``convert``'s KZG helpers, on the CPU.

``point_double_plain(ctx, pt, times=k)`` must give the words of k applications
of zktpu's ``zktpu.curve.device.point_double`` (plain JAX on the CPU), infinity
lanes included, tolerance 0; a count below 1 raises. The Pippenger MSM, which
now doubles a whole window in one call, is held against zktpu and the host in
``test_torch_msm.py``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.curve import device as jdc

from zktpu_torch import convert
from zktpu_torch.curve import bls12_381 as hc
from zktpu_torch.curve import device as dc
from zktpu_torch.curve import point_kernels as pk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FQ

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FQ, device="cpu")


@pytest.fixture(scope="module")
def lanes():
    """8 lanes with Z != 1 (sums of two batches), lanes 2 and 5 infinite."""
    rng = np.random.default_rng(29)
    pts = [hc.multiply(hc.G1_GEN, int(k)) for k in rng.integers(1, 1 << 40, size=16)]
    a, b = dc.pack_points(pts[:8], "cpu"), dc.pack_points(pts[8:], "cpu")
    s = dc.point_add(a, b)
    z = s[2].clone()
    z[2] = 0
    z[5] = 0
    return (s[0], s[1], z)


@pytest.mark.parametrize("times", [1, 3, 16])
def test_point_double_times_equals_zktpu_applied_times(lanes, times):
    got = pk.point_double_plain(ctx, lanes, times)
    assert all(torch.equal(g, w) for g, w in zip(got, dc.point_double(lanes, times)))
    want = tuple(jnp.asarray(c) for c in convert.points_to_zktpu(lanes))
    for _ in range(times):
        want = jdc.point_double(want)
    want = convert.points_from_zktpu([np.asarray(c) for c in want])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [got[2][i].abs().sum().item() for i in (2, 5)] == [0, 0]


@pytest.mark.parametrize("call", ["plain", "wrapper", "curve"])
def test_point_double_times_below_one_raises(lanes, call):
    fn = {"plain": lambda t: pk.point_double_plain(ctx, lanes, t),
          "wrapper": lambda t: pk.point_double(ctx, lanes, t),
          "curve": lambda t: dc.point_double(lanes, t)}[call]
    for times in (0, -1):
        with pytest.raises(ValueError, match="times"):
            fn(times)


def test_kzg_from_zktpu_defaults_to_the_card():
    """No device means the card: where there is none, it raises rather than
    carry on on the CPU; with one, the basis lands on it. The set-up is a
    stand-in with zktpu's attributes and layout (a basis of 4 points)."""
    basis = dc.pack_points([hc.multiply(hc.G1_GEN, k) for k in (1, 2, 3, 4)], "cpu")
    setup = types.SimpleNamespace(g1_lagrange_basis=convert.points_to_zktpu(basis),
                                  g2_taus=[None], num_vars=2)
    if torch.cuda.is_available():
        assert convert.kzg_from_zktpu(setup).g1_lagrange_basis[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.kzg_from_zktpu(setup)
    carried = convert.kzg_from_zktpu(setup, device="cpu")
    assert carried.g1_lagrange_basis[0].device.type == "cpu" and carried.num_vars == 2
    assert all(torch.equal(c, b) for c, b in zip(carried.g1_lagrange_basis, basis))
