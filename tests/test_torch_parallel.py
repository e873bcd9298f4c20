"""The port's multi-device layer (zktpu_torch.parallel) against zktpu's and
against the port's own single-device paths, on the CPU.

The mesh is ``make_mesh(devices=["cpu"] * 8)``: eight slots on one device, the
counterpart of the 8 virtual CPU devices of ``tests/conftest.py``. The same
values, made from a seed with numpy, go into both packages; each of
``tests/test_parallel.py``'s sumcheck and NTT tests is mirrored here (its MSM
tests in test_torch_parallel_msm.py, its end-to-end GKR proof in
test_torch_parallel_gkr.py). Tolerance 0: integer arithmetic, every comparison
is exact equality. ``MIN_ROWS_PER_DEVICE`` is never patched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BLS12_381_FR as JAX_BLS_FR
from zktpu.field.spec import BN254_FQ as JAX_FQ
from zktpu.field.spec import BN254_FR as JAX_FR
from zktpu.gkr import lazy as jlazy
from zktpu.gkr.circuit import Layer as JaxLayer
from zktpu.parallel import context as jpctx
from zktpu.parallel import mesh as jpm
from zktpu.poly.multilinear import MultilinearPoly as JaxPoly
from zktpu.sumcheck import protocol as jsc
from zktpu.transcript import Transcript as JaxTranscript

from zktpu_torch import convert
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FR, BN254_FQ, BN254_FR
from zktpu_torch.gkr import lazy as lazy_mod
from zktpu_torch.gkr.circuit import ADD, MUL, Layer
from zktpu_torch.ntt import ntt as tn
from zktpu_torch.ntt import ntt_kernels as nk
from zktpu_torch.parallel import context as pctx
from zktpu_torch.parallel import mesh as pm
from zktpu_torch.poly.multilinear import MultilinearPoly
from zktpu_torch.sumcheck import protocol as sc
from zktpu_torch.transcript import Transcript

torch.set_num_threads(1)

SLOTS = 8


@pytest.fixture(scope="module")
def mesh():
    return pm.make_mesh(devices=["cpu"] * SLOTS)


@pytest.fixture(scope="module")
def jmesh():
    return jpm.make_mesh(SLOTS)


# -- the mesh and the context ---------------------------------------------------

def test_mesh_slots_may_repeat_a_device(mesh):
    assert mesh.size == SLOTS and set(mesh.devices) == {torch.device("cpu")}
    assert pm.make_mesh(3, devices=["cpu"] * 5).size == 3
    with pytest.raises(ValueError):
        pm.Mesh([])


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() takes the cards")
    for n in (None, 1, 4):
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.make_mesh(n)


def test_min_rows_is_zktpus_and_shardable_counts_slots(mesh, jmesh):
    """At the real threshold (never patched): 256 rows a slot shard, 255 do not;
    a size the slots do not divide never shards; zktpu answers the same."""
    assert pctx.MIN_ROWS_PER_DEVICE == jpctx.MIN_ROWS_PER_DEVICE == 256
    two = pm.make_mesh(devices=["cpu"] * 2)
    assert pctx.shardable(512, two) and not pctx.shardable(510, two)
    assert not pctx.shardable(2 * 255 + 1, two) and not pctx.shardable(256, two)
    cases = [(8 * 256, None), (8 * 255, None), (8 * 256 + 4, None), (1 << 20, None),
             (8, 1), (4, 1), (16, 1), (12, 1)]
    got = [pctx.shardable(size, mesh, rows) for size, rows in cases]
    assert got == [jpctx.shardable(size, jmesh, rows) for size, rows in cases]
    assert got == [True, False, False, True, True, False, True, False]


def test_use_mesh_is_a_stack(mesh):
    other = pm.make_mesh(devices=["cpu"] * 2)
    assert pctx.current_mesh() is None
    with pctx.use_mesh(mesh):
        assert pctx.current_mesh() is mesh
        with pctx.use_mesh(None):
            assert pctx.current_mesh() is mesh
        with pctx.use_mesh(other):
            assert pctx.current_mesh() is other
        assert pctx.current_mesh() is mesh
    assert pctx.current_mesh() is None


# -- sharded MLE and sumcheck (tests/test_parallel.py:27-63) ---------------------

def test_sharded_fold_and_sums_match_dense(mesh, jmesh):
    ctx = fb.get_ctx(BN254_FQ, device="cpu")
    jctx = jfb.get_ctx(JAX_FQ)
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(0, 1 << 40, size=256)]
    poly = MultilinearPoly.from_ints(ctx, vals)
    jpoly = JaxPoly.from_ints(jctx, vals)

    sharded = pm.ShardedMLE.shard(poly, mesh)
    assert sharded.rows == 256 // SLOTS and sharded.num_entries == 256
    dense = sc._to_ints(ctx, poly.halves_sums())
    jsharded = jpm.ShardedMLE.shard(jpoly, jmesh)
    assert sharded.halves_sums() == dense == jsc._to_ints(jctx, jsharded.halves_sums())
    assert sharded.total_sum() == sum(vals) % BN254_FQ.modulus
    assert torch.equal(sharded.gather().table, poly.table)

    r = poly.encode_scalar(987654321)
    folded = sharded.fold(r).gather()
    assert torch.equal(folded.table, poly.partial_evaluate(0, r).table)
    assert folded.to_ints() == jsharded.fold(jpoly.encode_scalar(987654321)).gather().to_ints()


def test_sharded_sumcheck_prove_matches_dense(mesh, jmesh):
    ctx = fb.get_ctx(BN254_FQ, device="cpu")
    rng = np.random.default_rng(1)
    vals = [int(v) for v in rng.integers(0, 1 << 40, size=128)]
    poly = MultilinearPoly.from_ints(ctx, vals)

    dense = sc.prove(poly)
    sharded = pm.sumcheck_prove_sharded(poly, mesh)
    jproof = jpm.sumcheck_prove_sharded(JaxPoly.from_ints(jfb.get_ctx(JAX_FQ), vals), jmesh)
    assert sharded.claimed_sum == dense.claimed_sum == jproof.claimed_sum
    assert sharded.proof_polynomials == dense.proof_polynomials == jproof.proof_polynomials
    assert sc.verify(poly, sharded)


def test_sharded_sumcheck_small_table(mesh):
    """Table no bigger than the mesh: every round runs on the gathered path."""
    ctx = fb.get_ctx(BN254_FQ, device="cpu")
    poly = MultilinearPoly.from_ints(ctx, [3, 1, 4, 1, 5, 9, 2, 6])
    sharded = pm.sumcheck_prove_sharded(poly, mesh)
    assert sharded.proof_polynomials == sc.prove(poly).proof_polynomials
    assert sharded.claimed_sum == 31
    with pytest.raises(ValueError, match="smaller than mesh"):
        pm.sumcheck_prove_sharded(MultilinearPoly.from_ints(ctx, [1, 2, 3, 4]), mesh)


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_sharded_sumcheck_on_fewer_slots(slots):
    """A 2^9 BLS12-381 Fr table on 1, 2 and 4 slots: shards of 512 / D rows down
    to one row, then log2(D) gathered rounds."""
    ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
    rng = np.random.default_rng(9)
    poly = MultilinearPoly.from_ints(ctx, [int(v) for v in rng.integers(0, 1 << 62, size=512)])
    sharded = pm.sumcheck_prove_sharded(poly, pm.make_mesh(devices=["cpu"] * slots))
    dense = sc.prove(poly)
    assert (sharded.claimed_sum, sharded.proof_polynomials) == (dense.claimed_sum,
                                                                dense.proof_polynomials)


# -- the NTT: batch axis and four-step (tests/test_parallel.py:66-80) ------------

def _fr_table(ctx, rng, *shape):
    words = rng.integers(0, 1 << 32, size=(*shape, ctx.num_words), dtype=np.uint32)
    return fk.to_mont(ctx, ctx.to_device(words))


@pytest.mark.parametrize("log_n", [0, 1, 2, 5, 11])
def test_batched_ntt_equals_a_loop_of_tables(log_n):
    """A (B, 2^k, W) batch through both plain kernels and the whole transform,
    forward and inverse, against the tables one at a time; rows of 1, 2 and 4
    entries among them."""
    ctx = fb.get_ctx(BN254_FR, device="cpu")
    x = _fr_table(ctx, np.random.default_rng(20 + log_n), 3, 1 << log_n)
    for inverse in (False, True):
        tw = nk.stage_twiddles(ctx, log_n, inverse)
        log_tile = min(nk.LOG_TILE, log_n)
        phase1 = nk.ntt_phase1(ctx, x, tw, log_tile)
        assert torch.equal(phase1, torch.stack([nk.ntt_phase1(ctx, row, tw, log_tile) for row in x]))
        for stage in range(1, log_n + 1):
            assert torch.equal(nk.ntt_stage(ctx, x, tw, stage),
                               torch.stack([nk.ntt_stage(ctx, row, tw, stage) for row in x]))
        got = tn.ntt(ctx, x, inverse)
        assert torch.equal(got, torch.stack([tn.ntt(ctx, row, inverse) for row in x]))
        assert torch.equal(tn.ntt(ctx, got, not inverse), x)


def test_ntt_refuses_a_malformed_batch():
    ctx = fb.get_ctx(BN254_FR, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        nk.ntt_stage(ctx, torch.zeros((2, 2, 4, 8), dtype=torch.int32),
                     nk.stage_twiddles(ctx, 2, False), 1)
    with pytest.raises(ValueError, match="power of 2"):
        tn.ntt(ctx, torch.zeros((2, 3, 8), dtype=torch.int32))


@pytest.mark.parametrize("log_n", [1, 2, 4, 5, 6])
def test_twiddle_matrix_equals_the_host_build(log_n):
    """w^(m1 k2) from the cached stage table and w^(n/2) = -1, word for word
    against the host's products (zktpu/parallel/mesh.py:456-463)."""
    ctx = fb.get_ctx(BN254_FR, device="cpu")
    p = BN254_FR.modulus
    n = 1 << log_n
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    for inverse in (False, True):
        omega = BN254_FR.root_of_unity(n)
        if inverse:
            omega = pow(omega, -1, p)
        host = [[pow(omega, m1 * k2, p) for k2 in range(n2)] for m1 in range(n1)]
        got = pm.twiddle_matrix(ctx, log_n, inverse)
        assert tuple(got.shape) == (n1, n2, 8)
        assert torch.equal(got, fk.to_mont(ctx, ctx.to_device(ctx.pack(host))))


def test_sharded_ntt_matches_dense(mesh, jmesh):
    ctx = fb.get_ctx(BN254_FR, device="cpu")
    jctx = jfb.get_ctx(JAX_FR)
    rng = np.random.default_rng(2)
    vals = [int(v) for v in rng.integers(0, 1 << 40, size=64)]
    table = fk.to_mont(ctx, ctx.to_device(ctx.pack(vals)))
    jtable = jfb.to_mont(jctx, jnp.asarray(jctx.pack(vals)))
    for inverse in (False, True):
        got = pm.ntt_sharded(ctx, mesh, table, inverse)
        assert torch.equal(got, tn.ntt(ctx, table, inverse))
        jgot = jpm.ntt_sharded(jctx, jmesh, jtable, inverse=inverse)
        assert torch.equal(got, convert.table_from_zktpu(np.asarray(jgot)))


@pytest.mark.parametrize("log_n,slots", [(5, 4), (6, 8), (7, 8), (8, 1), (9, 8), (9, 2)])
def test_sharded_ntt_odd_and_even_sizes(log_n, slots):
    """n1 != n2 at odd log_n: the inverse's n^-1 is applied once, not n1^-1 and
    n2^-1 on top of it."""
    ctx = fb.get_ctx(BN254_FR, device="cpu")
    x = _fr_table(ctx, np.random.default_rng(40 + log_n), 1 << log_n)
    mesh = pm.make_mesh(devices=["cpu"] * slots)
    for inverse in (False, True):
        got = pm.ntt_sharded(ctx, mesh, x, inverse)
        assert torch.equal(got, tn.ntt(ctx, x, inverse))
    assert torch.equal(pm.ntt_sharded(ctx, mesh, pm.ntt_sharded(ctx, mesh, x), True), x)


def test_sharded_ntt_refuses_a_table_the_slots_do_not_divide(mesh):
    ctx = fb.get_ctx(BN254_FR, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        pm.ntt_sharded(ctx, mesh, _fr_table(ctx, np.random.default_rng(3), 32))
    with pytest.raises(ValueError, match="power of 2"):
        pm.ntt_sharded(ctx, mesh, _fr_table(ctx, np.random.default_rng(3), 48))


# -- lazy-GKR sumcheck (tests/test_parallel.py:93-123) ---------------------------

def _lazy_case(seed: int, n_gates: int):
    rng = np.random.default_rng(seed)
    ops = [ADD if rng.integers(2) else MUL for _ in range(n_gates)]
    w_vals = [int(v) for v in rng.integers(0, 1 << 60, size=2 * n_gates)]
    k = n_gates.bit_length() - 1
    r_b = [int(v) for v in rng.integers(1, 1 << 60, size=k)]
    r_c = [int(v) for v in rng.integers(1, 1 << 60, size=k)]
    return ops, w_vals, r_b, r_c


def test_sharded_lazy_gkr_sumcheck_matches_dense(mesh, jmesh):
    """The exact round polynomials and challenges of the single-device lazy
    prover (the fused one) and of zktpu's sharded one, and the same next
    transcript challenge."""
    from zktpu_torch.gkr.fused_lazy import gkr_prove_lazy_fused

    ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
    jctx = jfb.get_ctx(JAX_BLS_FR)
    ops, w_vals, r_b, r_c = _lazy_case(3, 16)
    alpha, beta = 12345, 67890

    w = MultilinearPoly.from_ints(ctx, w_vals)
    fbc = lazy_mod.lazy_folded_fbc(ctx, Layer(ops), w, r_b, r_c, alpha, beta)
    t_dense = Transcript(BLS12_381_FR)
    dense = gkr_prove_lazy_fused(777, fbc, t_dense)
    t_shard = Transcript(BLS12_381_FR)
    sharded = pm.gkr_sumcheck_lazy_sharded(777, fbc, t_shard, mesh)

    jfbc = jlazy.lazy_folded_fbc(jctx, JaxLayer(ops), JaxPoly.from_ints(jctx, w_vals),
                                 r_b, r_c, alpha, beta)
    t_jax = JaxTranscript(JAX_BLS_FR)
    jsharded = jpm.gkr_sumcheck_lazy_sharded(777, jfbc, t_jax, jmesh)

    coeffs = [p.coefficients for p in sharded.proof_polynomials]
    assert coeffs == [p.coefficients for p in dense.proof_polynomials]
    assert coeffs == [p.coefficients for p in jsharded.proof_polynomials]
    assert sharded.random_challenges == dense.random_challenges == jsharded.random_challenges
    nxt = t_shard.get_random_challenge()
    assert nxt == t_dense.get_random_challenge() == t_jax.get_random_challenge()


@pytest.mark.parametrize("n_gates,slots", [(1, 2), (2, 8), (64, 4), (64, 1)])
def test_sharded_lazy_gkr_sumcheck_sizes(n_gates, slots):
    """Phases no larger than the mesh (never sharded), shards of one row, and one
    slot, against the fused single-device prover."""
    from zktpu_torch.gkr.fused_lazy import gkr_prove_lazy_fused

    ctx = fb.get_ctx(BLS12_381_FR, device="cpu")
    ops, w_vals, r_b, r_c = _lazy_case(50 + n_gates, n_gates)
    w = MultilinearPoly.from_ints(ctx, w_vals)
    k = max(1, n_gates.bit_length() - 1)
    fbc = lazy_mod.lazy_folded_fbc(ctx, Layer(ops), w, (r_b + [5])[:k], (r_c + [7])[:k], 3, 5)
    t_fused, t_shard = Transcript(BLS12_381_FR), Transcript(BLS12_381_FR)
    fused = gkr_prove_lazy_fused(11, fbc, t_fused)
    sharded = pm.gkr_sumcheck_lazy_sharded(11, fbc, t_shard, pm.make_mesh(devices=["cpu"] * slots))
    assert [p.coefficients for p in sharded.proof_polynomials] == \
        [p.coefficients for p in fused.proof_polynomials]
    assert sharded.random_challenges == fused.random_challenges
    assert t_shard.get_random_challenge() == t_fused.get_random_challenge()
