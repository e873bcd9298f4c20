"""The port's field oracle against Python integers, and the port's field layer
against the oracle, on the CPU, for all four fields.

Mirrors tests/test_oracle.py: the oracle (``zktpu_torch.oracle``, plain-bigint
C++ that shares no code with the Montgomery arithmetic) against Python's own
integers, then the port's ``mont_mul``, ``fold_tables_kernel``, ``field_sum``,
``halves_sums``, ``fold_and_halves``, ``pow_static`` and ``inverse`` (``device=
"cpu"``: the kernels' plain versions) against it; ``inverse`` against zktpu's
``jnp_backend.inverse`` too. Also ``chip_smoke.py`` phase 15's check, run here at
16 entries. Tolerance 0.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field import spec as jspec

import chip_smoke
from zktpu_torch import _build, oracle
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import ALL_SPECS, BN254_FQ
from zktpu_torch.sumcheck.protocol import fold_tables_kernel

torch.set_num_threads(1)

by_field = pytest.mark.parametrize("spec", ALL_SPECS, ids=lambda s: s.name)


def _values(spec, n, seed):
    return chip_smoke.oracle_values(spec, np.random.default_rng(seed), n)


def _mont(ctx, values):
    return fk.to_mont(ctx, ctx.to_device(ctx.pack(values)))


def _ints(ctx, table):
    return [int(v) for v in ctx.unpack(fk.from_mont(ctx, table)).reshape(-1)]


@by_field
def test_oracle_matches_python(spec):
    p = spec.modulus
    rng = np.random.default_rng(1)
    for _ in range(10):
        a = int(rng.integers(0, 2**62)) * int(rng.integers(0, 2**62)) % p
        b = int(rng.integers(0, 2**62)) * int(rng.integers(0, 2**62)) % p
        assert oracle.add(a, b, p) == (a + b) % p
        assert oracle.sub(a, b, p) == (a - b) % p
        assert oracle.mul(a, b, p) == a * b % p
    a = p - 3
    assert oracle.pow_(a, 5, p) == pow(a, 5, p)
    assert oracle.pow_(a, 0, p) == 1
    assert oracle.pow_(a, p - 1, p) == 1
    assert oracle.inverse(a, p) == pow(a, -1, p)
    assert oracle.inverse(0, p) == 0
    with pytest.raises(ValueError):
        oracle.pow_(a, -1, p)
    values = _values(spec, 16, 2)
    assert oracle.vec_sum(values, p) == sum(values) % p
    r = values[5]
    assert oracle.sumcheck_fold(values, r, p) == [
        (x + r * (y - x)) % p for x, y in zip(values[:8], values[8:])]


@by_field
def test_mont_mul_matches_oracle(spec):
    p = spec.modulus
    ctx = fb.get_ctx(spec, device="cpu")
    a, b = _values(spec, 16, 3), _values(spec, 16, 4)[::-1]
    got = _ints(ctx, fk.mont_mul(ctx, _mont(ctx, a), _mont(ctx, b)))
    assert got == [oracle.mul(x, y, p) for x, y in zip(a, b)]


@by_field
def test_fold_and_sums_match_oracle(spec):
    p = spec.modulus
    ctx = fb.get_ctx(spec, device="cpu")
    values = _values(spec, 32, 5)
    table = _mont(ctx, values)
    assert _ints(ctx, fb.field_sum(ctx, table, axis=0)) == [oracle.vec_sum(values, p)]
    assert fk.lazy_rows_to_ints(ctx, fk.halves_sums(ctx, table)) == [
        oracle.vec_sum(values[:16], p), oracle.vec_sum(values[16:], p)]
    for r in (values[7], 0, 1, p - 1):
        want = oracle.sumcheck_fold(values, r, p)
        assert _ints(ctx, fold_tables_kernel(ctx, table, _mont(ctx, r))) == want
        folded, rows = fk.fold_and_halves(ctx, table, _mont(ctx, r))
        assert _ints(ctx, folded) == want
        assert fk.lazy_rows_to_ints(ctx, rows) == [oracle.vec_sum(want[:8], p),
                                                   oracle.vec_sum(want[8:], p)]


@by_field
def test_pow_static_inverse_and_mont_sqr(spec):
    """Any (..., W) shape; inverse(0) == 0; inverse equal to zktpu's."""
    p = spec.modulus
    ctx = fb.get_ctx(spec, device="cpu")
    values = _values(spec, 8, 6)
    table = _mont(ctx, values).reshape(2, 4, ctx.num_words)
    exponent = 0xDEADBEEF12345
    assert _ints(ctx, fb.pow_static(ctx, table, exponent)) == [
        oracle.pow_(v, exponent, p) for v in values]
    assert _ints(ctx, fb.pow_static(ctx, table, 0)) == [1] * 8
    assert _ints(ctx, fb.pow_static(ctx, table, 1)) == values
    assert _ints(ctx, fb.mont_sqr(ctx, table)) == [v * v % p for v in values]
    inverses = _ints(ctx, fb.inverse(ctx, table))
    assert inverses == [oracle.inverse(v, p) for v in values]
    assert inverses[0] == 0 and values[0] == 0
    assert _ints(ctx, fb.inverse(ctx, table[1, 2])) == [inverses[6]]

    jspec_ = next(s for s in jspec.ALL_SPECS if s.name == spec.name)
    jctx = jfb.get_ctx(jspec_)
    jinv = jfb.from_mont(jctx, jfb.inverse(jctx, jfb.to_mont(jctx, jctx.pack(values))))
    assert [int(v) for v in jctx.unpack(np.asarray(jinv))] == inverses


@by_field
def test_chip_smoke_oracle_phase_on_the_cpu(spec):
    """Phase 15's check of the card, run on the CPU's plain versions."""
    ctx = fb.get_ctx(spec, device="cpu")
    bad = chip_smoke.oracle_mismatches(ctx, np.random.default_rng(7), 4)
    assert bad == {name: 0 for name in ("mont_mul", "pow_static", "inverse", "halves_sums",
                                        "fold", "fold_and_halves")}
    assert chip_smoke.oracle_mismatches(ctx, np.random.default_rng(7), 4, False) == {"mont_mul": 0}


def test_oracle_built_into_the_build_directory_and_shared_by_threads():
    """16 threads load and call the oracle at once (as chip_smoke.py's phase 15
    calls it): one library, every result right."""
    lib = oracle._load()
    assert any(f.startswith("libzkoracle_") and f.endswith(".so")
               for f in os.listdir(_build.BUILD_DIR))
    p = BN254_FQ.modulus
    values = _values(BN254_FQ, 64, 8)
    results, loaded = {}, set()

    def worker(k):
        loaded.add(id(oracle._load()))
        results[k] = [oracle.mul(v, v + k, p) for v in values]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    oracle._lib = None
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        if oracle._lib is None:
            oracle._lib = lib
    assert not any(t.is_alive() for t in threads)
    assert len(loaded) == 1
    assert results == {k: [v * (v + k) % p for v in values] for k in range(16)}


def test_failed_host_build_raises(tmp_path):
    source = tmp_path / "broken.cpp"
    source.write_text("this is not C++\n")
    with pytest.raises(_build.CompileError):
        _build.host_library_path("zkbroken", str(source), ["-O2"], "g++")
    with pytest.raises(_build.CompileError):
        _build.host_library_path("zkbroken", str(source), ["-O2"], "no-such-compiler")
