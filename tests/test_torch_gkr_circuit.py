"""zktpu_torch's circuits and composed polynomials vs zktpu's.

The same gate lists and the same values, made from a numpy seed, go into both
packages; the port runs on the CPU (``device="cpu"``, the kernels' plain
versions). Tolerance 0: integer arithmetic, every comparison is exact equality,
tables word for word through ``zktpu_torch.convert``.
"""

import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_FR
from zktpu.field.spec import BN254_FQ as JAX_FQ
from zktpu.gkr import circuit as jcircuit
from zktpu.poly import composed as jcomposed
from zktpu.poly.multilinear import MultilinearPoly as JaxPoly
from zktpu.poly.univariate import UnivariatePoly as JaxUnivariate

from zktpu_torch import convert
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ
from zktpu_torch.gkr.circuit import ADD, MUL, Circuit, Layer, layer_eval_kernel
from zktpu_torch.poly.composed import ProductPoly, SumPoly
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.poly.univariate import UnivariatePoly

torch.set_num_threads(1)

ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
jctx = jfb.get_ctx(JAX_FR)


def _same(port_tensor, jax_array):
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


def _ops(rng, n):
    return [ADD if rng.integers(2) else MUL for _ in range(n)]


def _values(rng, n, spec=BLS12_381_FR):
    return [int(a) * int(b) % spec.modulus for a, b in rng.integers(0, 2**62, size=(n, 2))]


@pytest.mark.parametrize("n_gates", [1, 2, 4, 8])
def test_layer_wiring_equals_zktpu(n_gates):
    rng = np.random.default_rng(n_gates)
    ops = _ops(rng, n_gates)
    layer, jlayer = Layer(ops), jcircuit.Layer(ops)
    assert layer.bits_for_gates() == jlayer.bits_for_gates()
    assert list(layer.gate_positions()) == list(jlayer.gate_positions())
    for op in (ADD, MUL):
        got = layer.get_add_mul_i(ctx, op)
        want = jlayer.get_add_mul_i(jctx, op)
        assert _same(got.table, want.table)
        assert sum(got.to_ints()) == sum(o == op for o in ops)


def test_single_gate_layer_uses_three_bits():
    """gkr_circuit.rs:204-256: the one-gate layer's wiring table has 8 entries."""
    assert Layer([ADD]).bits_for_gates() == 3
    assert list(Layer([ADD]).gate_positions()) == [0b001]
    assert Layer([ADD]).get_add_mul_i(ctx, ADD).to_ints() == [0, 1, 0, 0, 0, 0, 0, 0]
    assert Layer([MUL]).get_add_mul_i(ctx, ADD).to_ints() == [0] * 8
    assert Layer([MUL]).get_add_mul_i(ctx, MUL).to_ints() == [0, 1, 0, 0, 0, 0, 0, 0]
    two = Layer([ADD, MUL])
    assert two.bits_for_gates() == 5 and list(two.gate_positions()) == [0b00001, 0b11011]


@pytest.mark.parametrize("n_gates", [1, 2, 4, 8])
def test_circuit_evaluate_equals_zktpu(n_gates):
    """A halving circuit whose first layer has ``n_gates`` gates."""
    rng = np.random.default_rng(10 + n_gates)
    structure = []
    n = n_gates
    while n >= 1:
        structure.append(_ops(rng, n))
        n //= 2
    inputs = _values(rng, 2 * n_gates)
    circuit, jcirc = Circuit(ctx, structure), jcircuit.Circuit(jctx, structure)
    got = circuit.evaluate_ints(inputs)
    assert got == jcirc.evaluate_ints(inputs)
    layers = circuit.evaluate(MultilinearPoly.from_ints(ctx, inputs))
    jlayers = jcirc.evaluate(JaxPoly.from_ints(jctx, inputs))
    assert all(_same(a.table, b.table) for a, b in zip(layers, jlayers))
    # against the gates themselves
    p = BLS12_381_FR.modulus
    current = inputs
    for ops, out in zip(structure, got):
        current = [
            (current[2 * g] + current[2 * g + 1]) % p if op == ADD
            else current[2 * g] * current[2 * g + 1] % p
            for g, op in enumerate(ops)
        ]
        assert out == current


def test_circuit_reference_vectors_bn254():
    """gkr_circuit.rs:151-202, over the other 256-bit field."""
    fq = fb.get_ctx(BN254_FQ, device="cpu")
    circuit = Circuit(fq, [[MUL, MUL, MUL, MUL], [ADD, ADD], [ADD]])
    assert circuit.evaluate_ints([5, 2, 2, 4, 10, 0, 3, 3]) == [[10, 8, 0, 9], [18, 9], [27]]
    assert Circuit(fq, [[ADD, MUL, ADD, MUL]]).evaluate_ints([1, 2, 3, 4, 5, 6, 7, 8]) == [[3, 12, 11, 56]]
    jfq = jfb.get_ctx(JAX_FQ)
    table = MultilinearPoly.from_ints(fq, [1, 2, 3, 4]).table
    mask = torch.tensor([True, False])
    want = jcircuit.layer_eval_kernel(jfq, JaxPoly.from_ints(jfq, [1, 2, 3, 4]).table, np.asarray([True, False]))
    assert _same(layer_eval_kernel(fq, table, mask), want)


def test_circuit_and_layer_refuse_bad_shapes():
    with pytest.raises(ValueError):
        Circuit(ctx, [[ADD, ADD]]).evaluate_ints([1, 2])  # needs 4 inputs
    with pytest.raises(ValueError):
        Layer([])
    with pytest.raises(ValueError):
        Layer(["xor"])


# ----------------------------------------------------------------------
# composed polynomials
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def composed():
    rng = np.random.default_rng(3)
    evals = [[_values(rng, 8) for _ in range(2)] for _ in range(2)]
    port = SumPoly(ctx, [ProductPoly.from_ints(ctx, e) for e in evals])
    ref = jcomposed.SumPoly(jctx, [jcomposed.ProductPoly.from_ints(jctx, e) for e in evals])
    return evals, port, ref, _values(rng, 3)


def test_reduce_table_equals_zktpu(composed):
    evals, port, ref, _ = composed
    p = BLS12_381_FR.modulus
    assert _same(port.reduce_table(), ref.reduce_table())
    for prod, jprod in zip(port.products, ref.products):
        assert _same(prod.reduce_table(), jprod.reduce_table())
    got = MultilinearPoly(ctx, port.reduce_table()).to_ints()
    assert got == [
        (evals[0][0][i] * evals[0][1][i] + evals[1][0][i] * evals[1][1][i]) % p for i in range(8)
    ]


def test_reduce_keeps_the_two_factor_quirk(composed):
    """reduce multiplies the first two factors and adds the first two products,
    whatever else is there (composed_polynomial.rs:52-54, :88-99)."""
    evals, port, ref, _ = composed
    extra = MultilinearPoly.from_ints(ctx, list(range(8)))
    three = ProductPoly(ctx, port.products[0].factors + [extra])
    assert three.get_degree() == 3
    assert torch.equal(three.reduce_table(), port.products[0].reduce_table())
    more = SumPoly(ctx, port.products + [port.products[0]])
    assert torch.equal(more.reduce_table(), port.reduce_table())


def test_evaluate_and_partial_evaluate_equal_zktpu(composed):
    evals, port, ref, point = composed
    assert port.get_degree() == ref.get_degree() == 2 and port.num_vars == ref.num_vars == 3
    enc = port.products[0].factors[0].encode_scalar
    jenc = ref.products[0].factors[0].encode_scalar
    assert port.evaluate_int(point, enc) == ref.evaluate_int(point, jenc)
    folded, jfolded = port.partial_evaluate(enc(point[0])), ref.partial_evaluate(jenc(point[0]))
    for prod, jprod in zip(folded.products, jfolded.products):
        for f, jf in zip(prod.factors, jprod.factors):
            assert _same(f.table, jf.table)
    assert folded.evaluate_int(point[1:], enc) == port.evaluate_int(point, enc)


def test_composed_refuses_bad_shapes(composed):
    evals, port, ref, _ = composed
    short = MultilinearPoly.from_ints(ctx, [1, 2])
    with pytest.raises(ValueError):
        ProductPoly(ctx, [])
    with pytest.raises(ValueError):
        ProductPoly(ctx, [port.products[0].factors[0], short])
    with pytest.raises(ValueError):
        SumPoly(ctx, [])
    with pytest.raises(ValueError):
        SumPoly(ctx, [port.products[0], ProductPoly(ctx, [short])])


# ----------------------------------------------------------------------
# univariate polynomials (host integers)
# ----------------------------------------------------------------------

def test_univariate_equals_zktpu():
    rng = np.random.default_rng(5)
    ys = _values(rng, 4)
    points = list(enumerate(ys))
    poly = UnivariatePoly.interpolate(BLS12_381_FR, points)
    jpoly = JaxUnivariate.interpolate(JAX_FR, points)
    assert poly.coefficients == jpoly.coefficients
    assert [poly.evaluate(x) for x, _ in points] == ys
    x = _values(rng, 1)[0]
    assert poly.evaluate(x) == jpoly.evaluate(x)
    assert (poly * poly).coefficients == (jpoly * jpoly).coefficients
    assert (poly + poly).scalar_mul(x).coefficients == (jpoly + jpoly).scalar_mul(x).coefficients
    assert convert.round_polys_from_zktpu(BLS12_381_FR, [jpoly]) == [poly]
    assert convert.round_polys_to_zktpu([poly], JaxUnivariate, JAX_FR) == [jpoly]


def test_interpolate_trims_trailing_zeros():
    """A line through three points has no quadratic coefficient: the trimmed
    coefficient vector is what the transcript absorbs."""
    line = UnivariatePoly.interpolate(BLS12_381_FR, [(0, 7), (1, 10), (2, 13)])
    assert line.coefficients == [7, 3] and line.degree() == 1
    assert UnivariatePoly.interpolate(BLS12_381_FR, [(0, 0), (1, 0), (2, 0)]).coefficients == []
    assert UnivariatePoly.interpolate(BLS12_381_FR, [(0, 4), (1, 4), (2, 4)]).coefficients == [4]
