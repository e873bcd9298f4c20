"""``FieldCtx.pack``'s two routes on the CPU: the C packer for flat lists of
small ints, and the exact route that takes everything else.

Every input is packed twice, once as it comes and once with the C packer out
of reach (``_pack_small`` returning None, as where it cannot be built), and the
two arrays must agree in words, dtype and shape; both must hold ``int(v) % p``.
"""

import numpy as np
import pytest
import torch

from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ, BN254_FR
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.utils import tracker

SPECS = [BN254_FQ, BN254_FR, BLS12_381_FR]
by_spec = pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)

#: name -> the probe value for modulus p
CASES = {
    "zero": lambda p: 0,
    "one": lambda p: 1,
    "2^62": lambda p: 1 << 62,
    "2^64-1": lambda p: (1 << 64) - 1,
    "minus_one": lambda p: -1,
    "minus_p_minus_2": lambda p: -p - 2,
    "p": lambda p: p,
    "p+1": lambda p: p + 1,
    "2^64": lambda p: 1 << 64,
    "2^300+7": lambda p: (1 << 300) + 7,
    "np_uint64_max": lambda p: np.uint64((1 << 64) - 1),
    "np_uint64": lambda p: np.uint64(7),
    "np_int64": lambda p: np.int64(5),
    "np_int64_minus_one": lambda p: np.int64(-1),
    "true": lambda p: True,
    "false": lambda p: False,
    "float": lambda p: 1.5,
}

#: container name -> (build from the probe value, its values in pack's order)
GOOD = list(range(3, 3 + (1 << 12)))
CONTAINERS = {
    "list": (lambda v: [v], lambda v: [v]),
    "tuple": (lambda v: (v,), lambda v: [v]),
    "declined_last": (lambda v: GOOD + [v], lambda v: GOOD + [v]),
    "nested": (lambda v: [[v, 1], [2, 3]], lambda v: [v, 1, 2, 3]),
    "scalar": (lambda v: v, lambda v: [v]),
}


def _exact(ctx, values, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(fb, "_pack_small", lambda: None)
        return ctx.pack(values)


def _words(ctx, values):
    p, w = ctx.spec.modulus, ctx.num_words
    blob = b"".join((int(v) % p).to_bytes(4 * w, "little") for v in values)
    return np.frombuffer(blob, dtype="<u4").reshape(len(values), w)


def test_packer_builds():
    assert fb._pack_small() is not None


@by_spec
@pytest.mark.parametrize("case", list(CASES))
def test_pack_equals_exact_route(spec, case, monkeypatch):
    ctx = fb.get_ctx(spec, device="cpu")
    v = CASES[case](spec.modulus)
    for name, (build, flat) in CONTAINERS.items():
        got = ctx.pack(build(v))
        want = _exact(ctx, build(v), monkeypatch)
        assert got.dtype == want.dtype == np.uint32, name
        assert got.shape == want.shape == np.shape(build(v)) + (ctx.num_words,), name
        assert np.array_equal(got, want), name
        assert np.array_equal(got.reshape(-1, ctx.num_words), _words(ctx, flat(v))), name


@by_spec
def test_pack_routes_counted(spec):
    ctx = fb.get_ctx(spec, device="cpu")
    small = np.random.default_rng(1).integers(0, 1 << 61, size=1 << 12).tolist()
    tracker.reset()
    with tracker.tracking():
        ctx.pack(small)
        assert tracker.summary() == {"field.pack_fast": 1 << 12}
        tracker.reset()
        ctx.pack(small + [1 << 64])
        assert tracker.summary() == {"field.pack_exact": (1 << 12) + 1}
        tracker.reset()
        ctx.pack(7)
        assert tracker.summary() == {"field.pack_exact": 1}
    tracker.reset()


@by_spec
def test_from_ints_same_table_and_no_reference(spec, monkeypatch):
    ctx = fb.get_ctx(spec, device="cpu")
    values = np.random.default_rng(2).integers(0, 1 << 61, size=1 << 10).tolist()
    values[:3] = [0, (1 << 64) - 1, 1]
    with monkeypatch.context() as m:
        m.setattr(fb, "_pack_small", lambda: None)
        before = MultilinearPoly.from_ints(ctx, list(values))
    for given in (values, tuple(values), iter(values)):
        poly = MultilinearPoly.from_ints(ctx, given)
        assert torch.equal(poly.table, before.table)
        assert np.array_equal(poly.canonical_table(), before.canonical_table())
    poly = MultilinearPoly.from_ints(ctx, values)
    values[0] = 12345
    values.append(6)
    assert np.array_equal(poly.canonical_table(), before.canonical_table())
    assert torch.equal(poly.table, before.table)
    assert poly.to_ints() == before.to_ints()
