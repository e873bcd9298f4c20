"""The plain versions of zktpu_torch's five kernels vs the JAX kernels they port.

Each plain PyTorch version (what a CPU tensor gets from the wrapper, and what
the CUDA kernel is held against on the card) is compared with the Pallas TPU
kernel run in interpret mode, as tests/test_pallas_kernels.py runs it, and with
the plain JAX reference. Same table, 4096 x BLS12-381 Fr, in the Montgomery
domain, carried across by ``zktpu_torch.convert``. Tolerance 0: integer
arithmetic, every comparison is exact equality; lazy sum rows are compared both
word for word and after reduction mod p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field import pallas_kernels as pk
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.poly.multilinear import halves_sum_kernel
from zktpu.sumcheck.protocol import fold_tables_kernel, gkr_round_kernel

from zktpu_torch import convert
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR

torch.set_num_threads(1)

SIZE = 4096


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    """Interpret mode for this module only, set while its tests run and never at
    import time (it would leak into every other test file)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ZKTPU_PALLAS_INTERPRET", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def data():
    jctx = jfb.get_ctx(JAX_FR)
    ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
    rng = np.random.default_rng(7)
    p = ctx.spec.modulus
    vals = [int(a) * int(b) % p for a, b in rng.integers(0, 2**62, size=(SIZE, 2))]
    vals[:3] = [0, p - 1, 1]
    ja = jfb.to_mont(jctx, jnp.asarray(jctx.pack(vals)))
    jb = jnp.roll(ja, 1, axis=0)
    a, b = convert.table_from_zktpu(ja), convert.table_from_zktpu(jb)
    return ctx, jctx, vals, (a, b), (ja, jb)


def _scalar(ctx, jctx, value):
    jr = jfb.to_mont(jctx, jnp.asarray(jctx.pack(value)))
    return convert.table_from_zktpu(jr), jr


def _same(port_tensor, jax_array):
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


def test_mont_mul_plain(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    got = fk.mont_mul(ctx, a, b)  # a CPU tensor: the wrapper takes the plain version
    assert torch.equal(got, fk.mont_mul_plain(ctx, a, b))
    assert _same(got, pk.mont_mul_pallas(jctx, ja, jb))
    assert _same(got, jfb.mont_mul(jctx, ja, jb))
    # table x one element (to_mont of a whole table)
    assert _same(fk.mont_mul(ctx, a, ctx.r2), jfb.to_mont(jctx, ja))


def test_mont_mul_plain_unreduced_left_operand(data):
    """A raw 256-bit left operand (at or above p), as the fused prover feeds it
    for digests and lazy sums."""
    ctx, jctx, vals, (a, b), (ja, jb) = data
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 1 << 16, size=(64, 16), dtype=np.uint32)
    raw[0] = 0xFFFF
    raw[1] = np.asarray(jctx.p_arr)
    words = convert.table_from_zktpu(raw)
    assert _same(fk.mont_mul_plain(ctx, words, b[:64]), jfb.mont_mul(jctx, raw, jb[:64]))
    assert _same(fk.mont_mul_plain(ctx, words, ctx.r2), jfb.mont_mul(jctx, raw, jctx.r2))


def test_fold_plain_and_leading_dims(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    r, jr = _scalar(ctx, jctx, 987654321)
    got = fk.fold(ctx, a, r)
    assert torch.equal(got, fk.fold_plain(ctx, a, r))
    assert _same(got, pk.fold_pallas(jctx, ja, jr))
    assert _same(got, fold_tables_kernel(jctx, ja, jr))
    tables = torch.stack([torch.stack([a, b]), torch.stack([b, a])])
    jtables = jnp.stack([jnp.stack([ja, jb]), jnp.stack([jb, ja])])
    got4 = fk.fold(ctx, tables, r)
    assert tuple(got4.shape) == (2, 2, SIZE // 2, 8)
    assert _same(got4, pk.fold_pallas(jctx, jtables, jr))
    assert _same(got4, fold_tables_kernel(jctx, jtables, jr))


@pytest.mark.parametrize("size", [2, 4])
def test_fold_plain_small_sizes(data, size):
    """Sizes the TPU kernels do not take: only the plain JAX reference covers them."""
    ctx, jctx, vals, (a, b), (ja, jb) = data
    r, jr = _scalar(ctx, jctx, ctx.spec.modulus - 1)
    assert _same(fk.fold(ctx, a[:size].contiguous(), r), fold_tables_kernel(jctx, ja[:size], jr))
    stack = torch.stack([a[:size], b[:size]]).reshape(1, 2, size, 8)
    jstack = jnp.stack([ja[:size], jb[:size]]).reshape(1, 2, size, 16)
    assert _same(fk.fold(ctx, stack, r), fold_tables_kernel(jctx, jstack, jr))


def test_halves_sums_plain(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    p = ctx.spec.modulus
    rows = fk.halves_sums(ctx, a)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (2, 8 + fk.EXTRA_WORDS)
    jrows = pk.halves_sums_pallas(jctx, ja)
    assert torch.equal(rows, convert.lazy_rows_from_zktpu(np.asarray(jrows)))
    want = [sum(vals[: SIZE // 2]) % p, sum(vals[SIZE // 2 :]) % p]
    assert fk.lazy_rows_to_ints(ctx, rows) == want
    assert pk.lazy_rows_to_ints(jctx, jrows) == want
    assert pk.lazy_rows_to_ints(jctx, convert.lazy_rows_to_zktpu(rows)) == want
    reduced = jfb.from_mont(jctx, halves_sum_kernel(jctx, ja))
    assert [int(v) for v in jctx.unpack(np.asarray(reduced))] == want
    # size 2: one entry a half
    small = fk.halves_sums(ctx, a[1:3].contiguous())
    assert fk.lazy_rows_to_ints(ctx, small) == [vals[1], vals[2]]


def test_fold_and_halves_plain(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    p = ctx.spec.modulus
    r, jr = _scalar(ctx, jctx, 31337)
    folded, rows = fk.fold_and_halves(ctx, a, r)
    jfolded, jrows = pk.fold_and_halves_pallas(jctx, ja, jr)
    assert _same(folded, jfolded)
    assert _same(folded, fold_tables_kernel(jctx, ja, jr))
    assert torch.equal(rows, convert.lazy_rows_from_zktpu(np.asarray(jrows)))
    fv = [int(v) for v in ctx.unpack(fb.from_mont(ctx, folded))]
    want = [sum(fv[: SIZE // 4]) % p, sum(fv[SIZE // 4 :]) % p]
    assert fk.lazy_rows_to_ints(ctx, rows) == want
    assert pk.lazy_rows_to_ints(jctx, jrows) == want
    # size 4 folds to 2 entries, one a half; size 2 to one entry, in the second half
    f4, rows4 = fk.fold_and_halves(ctx, a[:4].contiguous(), r)
    v4 = [int(v) for v in ctx.unpack(fb.from_mont(ctx, f4))]
    assert fk.lazy_rows_to_ints(ctx, rows4) == v4
    f2, rows2 = fk.fold_and_halves(ctx, a[:2].contiguous(), r)
    assert fk.lazy_rows_to_ints(ctx, rows2) == [0, int(ctx.unpack(fb.from_mont(ctx, f2))[0])]


def test_lazy_sum_headroom():
    """2^16 rows of all-ones words: the column sums need the extra word."""
    ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
    table = torch.full((1 << 17, 8), -1, dtype=torch.int32)
    rows = fk.halves_sums_plain(ctx, table)
    total = ctx.spec.from_words(fb.tensor_to_words(rows)[0])
    assert total == (2**256 - 1) * (1 << 16)


def test_wrappers_refuse_what_the_kernels_do_not_take(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    r = ctx.one_mont
    before = dict(fk.launches)
    with pytest.raises(TypeError):
        fk.fold(ctx, a.to(torch.int64), r)
    with pytest.raises(ValueError):
        fk.fold(ctx, a[:, :4], r[:4])  # wrong word count
    with pytest.raises(ValueError):
        fk.fold(ctx, a[::2], r)  # not contiguous
    with pytest.raises(ValueError):
        fk.fold(ctx, a[:6].contiguous(), r)  # not a power of two
    with pytest.raises(ValueError):
        fk.halves_sums(ctx, a[:1].contiguous())
    with pytest.raises(ValueError):
        fk.mont_mul(ctx, a, b[: SIZE // 2].contiguous())
    with pytest.raises(ValueError):
        fk.fold_and_halves(ctx, torch.stack([a, b]), r)
    with pytest.raises(TypeError):
        fk.halves_sums(ctx, np.zeros((4, 8), np.int32))
    # nothing on the CPU counts as a kernel launch
    assert fk.launches == before == {name: 0 for name in fk.KERNEL_NAMES}


# ----------------------------------------------------------------------
# gkr_round
# ----------------------------------------------------------------------

def _gkr_stacks(data, size):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    tables = torch.stack([torch.stack([a[:size], b[:size]]), torch.stack([b[:size], a[:size]])])
    jtables = jnp.stack([jnp.stack([ja[:size], jb[:size]]), jnp.stack([jb[:size], ja[:size]])])
    return tables.contiguous(), jtables


def _reduced(jctx, jys):
    return [int(v) for v in jctx.unpack(np.asarray(jfb.from_mont(jctx, jys)))]


@pytest.mark.parametrize("size", [1024, 2048])
def test_gkr_round_plain_equals_the_tpu_kernel(data, size):
    """Sizes the Pallas kernel takes (interpret mode): rows word for word once
    zktpu's uncarried digit rows are carried, and the reduced values."""
    ctx, jctx = data[0], data[1]
    tables, jtables = _gkr_stacks(data, size)
    rows = fk.gkr_round(ctx, tables)  # a CPU tensor: the wrapper takes the plain version
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (3, 8 + fk.EXTRA_WORDS)
    assert torch.equal(rows, fk.gkr_round_plain(ctx, tables))
    assert pk.pallas_available(size, pk.TILE // 4)
    jrows = pk.gkr_round_pallas(jctx, jtables, 2)
    assert torch.equal(rows, convert.lazy_rows_from_zktpu(np.asarray(jrows)))
    want = _reduced(jctx, gkr_round_kernel(jctx, jtables, 2))
    assert fk.lazy_rows_to_ints(ctx, rows) == want == pk.lazy_rows_to_ints(jctx, jrows)


@pytest.mark.parametrize("size", [2, 4, 64])
def test_gkr_round_plain_small_sizes(data, size):
    """Sizes the TPU kernel does not take: the plain JAX round function covers them."""
    ctx, jctx = data[0], data[1]
    tables, jtables = _gkr_stacks(data, size)
    want = _reduced(jctx, gkr_round_kernel(jctx, jtables, 2))
    assert fk.lazy_rows_to_ints(ctx, fk.gkr_round(ctx, tables)) == want


def test_gkr_round_plain_edge_tables(data):
    """All-zero factors, the constant-one table of phase 1, and p - 1 next to 0
    and 1 (b - a borrows, b + (b - a) crosses p)."""
    ctx, jctx, vals, (a, b), (ja, jb) = data
    size = 8
    edge = a[:size].clone()  # vals[:3] = 0, p - 1, 1
    jedge = ja[:size]
    ones, jones = ctx.one_mont.expand(size, 8), jnp.broadcast_to(jnp.asarray(jctx.one_mont), (size, 16))
    zeros, jzeros = torch.zeros_like(edge), jnp.zeros_like(jedge)
    tables = torch.stack([torch.stack([edge, edge.flip(0)]), torch.stack([zeros, ones])]).contiguous()
    jtables = jnp.stack([jnp.stack([jedge, jedge[::-1]]), jnp.stack([jzeros, jones])])
    want = _reduced(jctx, gkr_round_kernel(jctx, jtables, 2))
    assert fk.lazy_rows_to_ints(ctx, fk.gkr_round(ctx, tables)) == want
    nothing = torch.zeros((2, 2, size, 8), dtype=torch.int32)
    assert not fk.gkr_round(ctx, nothing).any()


def test_gkr_round_refuses_what_the_kernel_does_not_take(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    tables, _ = _gkr_stacks(data, 8)
    with pytest.raises(ValueError):
        fk.gkr_round(ctx, tables[0])  # not a (2, 2, size, W) stack
    with pytest.raises(ValueError):
        fk.gkr_round(ctx, tables[:, :, :6].contiguous())  # not a power of two
    with pytest.raises(ValueError):
        fk.gkr_round(ctx, tables[:, :, ::2])  # not contiguous
    with pytest.raises(TypeError):
        fk.gkr_round(ctx, tables.to(torch.int64))
    assert fk.launches["gkr_round"] == 0


def test_mont_mul_takes_leading_dimensions(data):
    ctx, jctx, vals, (a, b), (ja, jb) = data
    a3, b3 = a.reshape(4, SIZE // 4, 8), b.reshape(4, SIZE // 4, 8)
    assert torch.equal(fk.mont_mul(ctx, a3, b3).reshape(SIZE, 8), fk.mont_mul(ctx, a, b))
    assert torch.equal(fk.mont_mul(ctx, a3, ctx.r2).reshape(SIZE, 8), fk.mont_mul(ctx, a, ctx.r2))
    assert torch.equal(fk.mont_mul(ctx, a[5], b[5]), fk.mont_mul(ctx, a, b)[5])


def test_point_wrappers_refuse_what_the_kernels_do_not_take():
    from zktpu_torch.curve import bls12_381 as hc
    from zktpu_torch.curve import device as dc
    from zktpu_torch.curve import point_kernels as ptk
    from zktpu_torch.field.spec import BLS12_381_FQ, BN254_FQ

    ctx = fb.get_ctx(BLS12_381_FQ, device="cpu")
    a = dc.pack_points([hc.multiply(hc.G1_GEN, k) for k in range(1, 9)], "cpu")
    b = dc.pack_points([hc.multiply(hc.G1_GEN, k) for k in range(11, 19)], "cpu")
    ptk.reset_launches()
    with pytest.raises(TypeError):
        ptk.point_add(ctx, tuple(t.to(torch.int64) for t in a), b)  # wrong dtype
    with pytest.raises(TypeError):
        ptk.point_double(ctx, (a[0], a[1]))  # not a triple
    with pytest.raises(TypeError):
        ptk.point_double(ctx, tuple(t.numpy() for t in a))  # not tensors
    with pytest.raises(ValueError):
        ptk.point_add(ctx, a, tuple(t[:4].contiguous() for t in b))  # shapes differ
    with pytest.raises(ValueError):
        ptk.point_double(ctx, tuple(t[:, :8].contiguous() for t in a))  # not 12 words
    with pytest.raises(ValueError):
        ptk.point_add(ctx, tuple(t[::2] for t in a), tuple(t[::2] for t in b))  # not contiguous
    with pytest.raises(ValueError):
        ptk.point_double(ctx, tuple(t[:0] for t in a))  # empty batch
    with pytest.raises(ValueError):
        ptk.point_double(fb.get_ctx(BN254_FQ, device="cpu"), a)  # not the curve's field
    with pytest.raises(ValueError):
        ptk.point_double(ctx, tuple(t.to("meta") for t in a))  # another device than the context's
    # nothing on the CPU counts as a kernel launch
    ptk.point_add(ctx, a, b)
    ptk.point_double(ctx, a)
    assert ptk.launches == {"point_add": 0, "point_double": 0}
