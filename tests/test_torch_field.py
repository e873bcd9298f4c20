"""zktpu_torch field layer vs zktpu's, on the CPU, word for word.

The same inputs, made from a seed, go through ``zktpu.field.jnp_backend`` and
``zktpu_torch.field.torch_backend`` (``device="cpu"``); ``zktpu_torch.convert``
maps the 16-bit digit layout to the packed 32-bit word layout. Tolerance 0: this
is integer arithmetic, every comparison is exact equality.
"""

import random

import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field import spec as jspec
from zktpu.sumcheck.protocol import Proof as JaxProof

from zktpu_torch import convert
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ
from zktpu_torch.sumcheck.protocol import Proof

torch.set_num_threads(1)

SPECS = [BN254_FQ, BLS12_381_FR, BLS12_381_FQ]
by_name = pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)


def _ctxs(spec):
    jax_spec = next(s for s in jspec.ALL_SPECS if s.name == spec.name)
    assert jax_spec.modulus == spec.modulus
    return fb.get_ctx(spec, device="cpu"), jfb.get_ctx(jax_spec)


def _rand_elems(spec, n, seed):
    rng = random.Random(seed)
    special = [0, 1, 2, spec.modulus - 1, spec.modulus - 2, spec.R % spec.modulus]
    vals = special + [rng.randrange(spec.modulus) for _ in range(n - len(special))]
    return vals[:n]


def _raw_digits(spec, values):
    """Digits of the values as they are -- not reduced mod p, unlike pack."""
    blob = b"".join(int(v).to_bytes(2 * spec.num_limbs, "little") for v in values)
    return np.frombuffer(blob, dtype="<u2").astype(np.uint32).reshape(-1, spec.num_limbs)


def _same(port_tensor, jax_array):
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


@by_name
def test_pack_unpack_bytes(spec):
    ctx, jctx = _ctxs(spec)
    vals = _rand_elems(spec, 10, 0) + [spec.modulus + 5, 1 << 70]
    words = ctx.pack(vals)
    digits = jctx.pack(vals)
    assert words.shape == (12, spec.num_limbs // 2)
    assert np.array_equal(convert.table_to_zktpu(words.view(np.int32)), digits)
    assert torch.equal(convert.table_from_zktpu(digits), ctx.to_device(words))
    assert [int(v) for v in ctx.unpack(words)] == [v % spec.modulus for v in vals]
    assert [int(v) for v in ctx.unpack(ctx.to_device(words))] == [int(v) for v in jctx.unpack(digits)]
    # small values take the numpy fast path; the layouts must not depend on it
    assert np.array_equal(ctx.pack([3, 1 << 63]), ctx.pack([3, (1 << 63) + spec.modulus]))
    blob = ctx.canonical_to_bytes(words)
    assert blob == jctx.canonical_to_bytes(digits)
    assert np.array_equal(ctx.bytes_to_canonical(blob), words)


@by_name
def test_add_sub_neg(spec):
    ctx, jctx = _ctxs(spec)
    a_vals = _rand_elems(spec, 32, 1)
    b_vals = list(reversed(_rand_elems(spec, 32, 2)))  # pairs 0 with p-ish values
    ja, jb = jctx.pack(a_vals), jctx.pack(b_vals)
    a, b = convert.table_from_zktpu(ja), convert.table_from_zktpu(jb)
    assert _same(fb.add(ctx, a, b), jfb.add(jctx, ja, jb))
    assert _same(fb.sub(ctx, a, b), jfb.sub(jctx, ja, jb))
    assert _same(fb.neg(ctx, a), jfb.neg(jctx, ja))
    got = [int(v) for v in ctx.unpack(fb.sub(ctx, a, b))]
    assert got == [(x - y) % spec.modulus for x, y in zip(a_vals, b_vals)]


@by_name
def test_mont_mul_with_unreduced_left_operand(spec):
    ctx, jctx = _ctxs(spec)
    p = spec.modulus
    top = (1 << (16 * spec.num_limbs)) - 1
    # left operands at or above p: p itself, p + 1, the largest N-digit integer
    a_vals = [top, p, p + 1] + _rand_elems(spec, 29, 3)
    b_vals = [p - 1, p - 1, 1] + _rand_elems(spec, 29, 4)
    ja, jb = _raw_digits(spec, a_vals), _raw_digits(spec, b_vals)
    a, b = convert.table_from_zktpu(ja), convert.table_from_zktpu(jb)
    got = fb.mont_mul(ctx, a, b)
    assert _same(got, jfb.mont_mul(jctx, ja, jb))
    r_inv = pow(spec.R, -1, p)
    assert [int(v) for v in ctx.unpack(got)] == [
        x * y * r_inv % p for x, y in zip(a_vals, b_vals)
    ]
    # one element against a whole table (broadcast), as the fold uses it
    assert _same(fb.mont_mul(ctx, a[5], b), jfb.mont_mul(jctx, ja[5], jb))


@by_name
def test_to_mont_from_mont(spec):
    ctx, jctx = _ctxs(spec)
    vals = _rand_elems(spec, 16, 5)
    digits = jctx.pack(vals)
    words = convert.table_from_zktpu(digits)
    mont = fb.to_mont(ctx, words)
    assert _same(mont, jfb.to_mont(jctx, digits))
    assert [int(v) for v in ctx.unpack(mont)] == [v * spec.R % spec.modulus for v in vals]
    assert torch.equal(fb.from_mont(ctx, mont), words)
    assert _same(fb.from_mont(ctx, mont), jfb.from_mont(jctx, jfb.to_mont(jctx, digits)))


@by_name
def test_field_sum(spec):
    ctx, jctx = _ctxs(spec)
    for n in (1, 3, 7, 64):
        vals = _rand_elems(spec, n, 100 + n)
        digits = jctx.pack(vals)
        got = fb.field_sum(ctx, convert.table_from_zktpu(digits), axis=0)
        assert _same(got, jfb.field_sum(jctx, digits, axis=0))
        assert int(ctx.unpack(got)) == sum(vals) % spec.modulus


@by_name
def test_constants_and_predicates(spec):
    ctx, jctx = _ctxs(spec)
    assert spec.n0_prime32 * spec.modulus % (1 << 32) == (1 << 32) - 1
    assert spec.n0_prime32 % (1 << 16) == spec.n0_prime
    for name in ("r2", "one_plain", "one_mont", "zero"):
        assert _same(getattr(ctx, name), getattr(jctx, name)), name
    assert _same(ctx.p, jctx.p_arr)
    vals = _rand_elems(spec, 8, 6)
    a = ctx.to_device(ctx.pack(vals))
    assert fb.is_zero(ctx, a).tolist() == [v == 0 for v in vals]
    assert fb.eq(ctx, a, a[3]).tolist() == [v == vals[3] for v in vals]


def test_convert_round_trips():
    rng = np.random.default_rng(11)
    digits = rng.integers(0, 1 << 16, size=(2, 5, 16), dtype=np.uint32)
    words = convert.table_from_zktpu(digits)
    assert words.dtype == torch.int32 and tuple(words.shape) == (2, 5, 8)
    assert np.array_equal(convert.table_to_zktpu(words), digits)
    assert int(words[1, 2, 3]) & 0xFFFFFFFF == int(digits[1, 2, 6]) | int(digits[1, 2, 7]) << 16
    with pytest.raises(ValueError):
        convert.table_from_zktpu(digits + 0x10000)

    # lazy rows: N + 2 digits <-> N/2 + 1 words; delayed carries are carried
    rows = rng.integers(0, 1 << 16, size=(3, 18), dtype=np.uint32)
    lazy = convert.lazy_rows_from_zktpu(rows)
    assert tuple(lazy.shape) == (3, 9)
    assert np.array_equal(convert.lazy_rows_to_zktpu(lazy), rows)
    unclean = rows.copy()
    unclean[:, 0] += 0x10000  # one carry held in lane 0 == one more in lane 1
    carried = rows.copy()
    carried[:, 1] += 1
    carried[:, 2] += carried[:, 1] >> 16
    carried[:, 1] &= 0xFFFF
    assert (carried[:, 2] <= 0xFFFF).all()
    assert torch.equal(convert.lazy_rows_from_zktpu(unclean), convert.lazy_rows_from_zktpu(carried))

    pairs = rng.integers(0, 1 << 32, size=(25, 2), dtype=np.uint32)
    lanes = convert.sponge_state_from_zktpu(pairs)
    assert lanes.dtype == torch.int64 and tuple(lanes.shape) == (25,)
    assert int(lanes[7]) & ((1 << 64) - 1) == int(pairs[7, 0]) | int(pairs[7, 1]) << 32
    assert np.array_equal(convert.sponge_state_to_zktpu(lanes), pairs)

    proof = JaxProof([[1, 2], [3, 4]], 3)
    ported = convert.proof_from_zktpu(proof)
    assert isinstance(ported, Proof)
    assert ported.proof_polynomials == [[1, 2], [3, 4]] and ported.claimed_sum == 3
    back = convert.proof_to_zktpu(ported, JaxProof)
    assert isinstance(back, JaxProof) and back == proof
