"""The port's NTT (zktpu_torch.ntt) against zktpu's, word for word.

The twiddle table, the plain versions of the two kernels (what a CPU tensor gets
from the wrappers, and what the CUDA kernels are held against on the card) and
the whole transform are compared with zktpu on the same Montgomery tables,
carried across by ``zktpu_torch.convert``: the plain kernels against zktpu's
Pallas kernels run in interpret mode at a 16-entry tile, the transform against
``zktpu.ntt.ntt.ntt`` (its dense ladder at these sizes). Tolerance 0: integer
arithmetic, every comparison is exact equality. zktpu compiles once per
(log_n, inverse), so each of its transforms is called once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktpu.field import jnp_backend as jfb
from zktpu.field.spec import BN254_FR as JAX_FR
from zktpu.ntt import ntt as zn
from zktpu.ntt import pallas_ntt as zp

from zktpu_torch import convert
from zktpu_torch.field import kernels as fk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BN254_FQ, BN254_FR
from zktpu_torch.ntt import ntt as tn
from zktpu_torch.ntt import ntt_kernels as nk
from zktpu_torch.poly.univariate import UnivariatePoly

torch.set_num_threads(1)

FR = BN254_FR
P = FR.modulus
#: the Pallas kernels' tile in these tests, and the table they run on
LOG_TILE = 4
LOG_N = 7


@pytest.fixture(scope="module", autouse=True)
def _interpret_mode():
    """Interpret mode for this module only, set while its tests run."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ZKTPU_PALLAS_INTERPRET", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ctxs():
    return fb.get_ctx(FR, device="cpu"), jfb.get_ctx(JAX_FR)


def _table(ctxs, log_n: int, seed: int):
    """A Montgomery table of 2^log_n values (0, 1 and p - 1 first), in both
    packages' layouts. Put into Montgomery form by the port (zktpu would compile
    its product once more for every size; the two agree, test_torch_field.py)."""
    ctx, _ = ctxs
    rng = np.random.default_rng(seed)
    vals = [int(a) * int(b) % P for a, b in rng.integers(0, 2**62, size=(1 << log_n, 2))]
    vals[:3] = [0, 1, P - 1][: 1 << log_n]
    table = fk.to_mont(ctx, ctx.to_device(ctx.pack(vals)))
    return table, jnp.asarray(convert.table_to_zktpu(table))


def _same(port_tensor, jax_array) -> bool:
    return np.array_equal(convert.table_to_zktpu(port_tensor), np.asarray(jax_array))


def test_bitrev_perm_matches_zktpu():
    for log_n in range(11):
        assert np.array_equal(nk.bitrev_perm(log_n), zn._bitrev_perm(log_n)), log_n


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_stage_twiddles_match_zktpu(ctxs, log_n, inverse):
    """Stage s of zktpu's per-stage tables is the port's one table read at
    stride n / 2^s."""
    ctx, _ = ctxs
    tw = nk.stage_twiddles(ctx, log_n, inverse)
    assert tuple(tw.shape) == (1 << (log_n - 1), 8)
    assert nk.stage_twiddles(ctx, log_n, inverse) is tw  # cached
    assert torch.equal(nk.build_twiddles(ctx, log_n, inverse), tw)
    stages = zn._twiddles(JAX_FR, log_n, inverse)
    pallas_stages = zp._stage_twiddles_mont_np(JAX_FR, log_n, inverse)
    assert len(stages) == len(pallas_stages) == log_n
    for s in range(1, log_n + 1):
        got = tw.index_select(0, torch.arange(1 << (s - 1)) << (log_n - s))
        assert _same(got, stages[s - 1]), s
        assert _same(got, ctxs[1].pack(pallas_stages[s - 1])), s


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernels_plain_match_pallas_interpret(ctxs, inverse):
    """Phase 1 (bit-reversal gather, stages 1..4 in 16-entry tiles) against
    ``_phase1_kernel``, then each later stage against ``_phase2_stage``, at 2^7."""
    ctx, jctx = ctxs
    x, jx = _table(ctxs, LOG_N, 11)
    tw = nk.stage_twiddles(ctx, LOG_N, inverse)

    y = nk.ntt_phase1_plain(ctx, x, tw, LOG_TILE)
    assert torch.equal(nk.ntt_phase1(ctx, x, tw, LOG_TILE), y)  # the CPU wrapper
    jy = zp._phase1_kernel(
        jctx, jnp.take(jx, jnp.asarray(zn._bitrev_perm(LOG_N)), axis=0),
        zp._phase1_twiddles(jctx, LOG_N, inverse, LOG_TILE), LOG_TILE)
    assert _same(y, jy)

    for stage in range(LOG_TILE + 1, LOG_N + 1):
        z = nk.ntt_stage_plain(ctx, y, tw, stage)
        assert torch.equal(nk.ntt_stage(ctx, y, tw, stage), z)
        jz = zp._phase2_stage(
            jctx, jnp.asarray(convert.table_to_zktpu(y)),
            zp._phase2_twiddles(jctx, LOG_N, inverse, stage, 1 << LOG_TILE), stage, 1 << LOG_TILE)
        assert _same(z, jz), stage
        y = z
    # the port's transform (tile 1024 here: one phase-1 pass) gives the same words
    want = tn.ntt(ctx, x, inverse)
    if inverse:
        want = fk.mont_mul(ctx, want, fk.to_mont(ctx, ctx.to_device(ctx.pack(1 << LOG_N))))
    assert torch.equal(y, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [0, 1, 3, 6, 10])
def test_ntt_matches_zktpu(ctxs, log_n, inverse):
    ctx, jctx = ctxs
    x, jx = _table(ctxs, log_n, 100 + log_n)
    got = tn.ntt(ctx, x, inverse)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << log_n, 8)
    assert _same(got, zn.ntt(jctx, jx, inverse))
    assert torch.equal(tn.ntt(ctx, got, not inverse), x)


def test_ntt_rejects_non_pow2(ctxs):
    ctx, _ = ctxs
    for rows in (0, 3, 6):
        with pytest.raises(ValueError, match="power of 2"):
            tn.ntt(ctx, torch.zeros((rows, 8), dtype=torch.int32))


# -- fft.rs test vectors (tests/test_ntt_merkle_shamir.py) ------------------

def test_split_poly():
    """fft.rs:88-101."""
    poly = [2, (-14) % P, 2, 1]
    even, odd = tn.split_poly(poly)
    assert even == [2, 2]
    assert odd == [(-14) % P, 1]


def test_fft_evaluate_matches_direct():
    """fft.rs:104-125: evaluations at the 4th roots of unity."""
    poly = UnivariatePoly(FR, [1, 2, 3, 4])
    got = tn.fft_evaluate(poly, device="cpu")
    omega = FR.root_of_unity(4)
    assert got == [poly.evaluate(pow(omega, i, P)) for i in range(4)]
    assert tn.DEFAULT_SPEC is FR


@pytest.mark.parametrize("size", [4, 256])
def test_fft_roundtrip(size):
    """fft.rs:127-138 and a larger power-of-two size."""
    coeffs = list(range(1, size + 1))
    evals = tn.fft_evaluate(UnivariatePoly(FR, coeffs), device="cpu")
    back = tn.fft_interpolate(FR, evals, device="cpu")
    assert back.coefficients == coeffs


def test_fft_rejects_non_pow2():
    with pytest.raises(ValueError):
        tn.fft_evaluate(UnivariatePoly(FR, [1, 2, 3]), device="cpu")


def test_fft_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context is the card's")
    with pytest.raises(RuntimeError, match="CUDA"):
        tn.fft_evaluate(UnivariatePoly(FR, [1, 2, 3, 4]))


# -- the wrappers refuse what the kernels do not take -------------------------

def _bad_calls(ctx):
    x = torch.zeros((16, 8), dtype=torch.int32)
    tw = nk.stage_twiddles(ctx, 4, False)
    fq = fb.get_ctx(BN254_FQ, device="cpu")
    return {
        "dtype": (TypeError, lambda f, a: f(ctx, x.to(torch.int64), tw, a)),
        "rows": (ValueError, lambda f, a: f(ctx, x[:8].contiguous(), tw, a)),
        "words": (ValueError, lambda f, a: f(ctx, x[:, :4].contiguous(), tw, a)),
        "twiddles": (ValueError, lambda f, a: f(ctx, x, tw[:4], a)),
        "strided": (ValueError, lambda f, a: f(ctx, x.t().contiguous().t(), tw, a)),
        "device": (ValueError, lambda f, a: f(ctx, x.to("meta"), tw, a)),
        "field": (ValueError, lambda f, a: f(fq, x, tw, a)),
        "pow2": (ValueError, lambda f, a: f(ctx, x[:12].contiguous(), tw, a)),
    }


@pytest.mark.parametrize("fault", ["dtype", "rows", "words", "twiddles", "strided", "device",
                                   "field", "pow2"])
def test_wrappers_refuse(ctxs, fault):
    ctx, _ = ctxs
    exc, call = _bad_calls(ctx)[fault]
    with pytest.raises(exc):
        call(nk.ntt_phase1, 2)
    with pytest.raises(exc):
        call(nk.ntt_stage, 2)


def test_wrappers_refuse_tile_and_stage(ctxs):
    ctx, _ = ctxs
    x = torch.zeros((16, 8), dtype=torch.int32)
    tw = nk.stage_twiddles(ctx, 4, False)
    for log_tile in (-1, 5, 11):
        with pytest.raises(ValueError, match="log_tile"):
            nk.ntt_phase1(ctx, x, tw, log_tile)
    for stage in (0, 5):
        with pytest.raises(ValueError, match="stage"):
            nk.ntt_stage(ctx, x, tw, stage)
