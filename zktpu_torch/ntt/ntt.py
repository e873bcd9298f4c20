"""Radix-2 NTT/iNTT over BN254 Fr.

Capability parity with the reference's fft/src/fft.rs: ``fft_evaluate``
(:31-41), ``fft_interpolate`` (:43-60), ``split_poly`` (:62-68), with roots from
the field's two-adic generator exactly like arkworks ``Fr::get_root_of_unity``
(``spec.root_of_unity``). The counterpart of ``zktpu/ntt/ntt.py``: the same
values, entry for entry.

A transform is the bit-reversal gather and the first ten stages in 1024-entry
tiles (``ntt_kernels.ntt_phase1``), then one pass a later stage
(``ntt_kernels.ntt_stage``), over one cached twiddle table
(``ntt_kernels.stage_twiddles``); the inverse scales by n^-1 through the
``mont_mul`` kernel. On a CPU tensor each step is its plain PyTorch version.
A leading batch axis transforms many tables of one size in the same launches
(the four-step NTT of ``parallel.mesh.ntt_sharded`` runs its row DFTs so).

What zktpu has and this module has not, because each answers the TPU's compiler
or layout: the engine choice (``select_engine``, ``ZKTPU_NTT_ENGINE``,
``_LM_MIN``), the limb-major four-step engine (``ntt_lm.py``), the XLA ladder
``_ntt_kernel`` as an engine of its own (its plain counterpart is the two plain
versions in turn), ``ntt_pallas_available`` with its minimum of four tiles (the
kernels here take every power of two from 1), and the per-group concatenation
after each phase-2 stage (``ntt_stage`` writes every butterfly's outputs to
their final rows).
"""

from __future__ import annotations

import functools

from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.spec import BN254_FR, FieldSpec
from ..field.torch_backend import FieldCtx
from ..poly.univariate import UnivariatePoly
from . import ntt_kernels as nk


@functools.lru_cache(maxsize=None)
def _n_inv_mont(ctx: FieldCtx, log_n: int):
    """n^-1 R mod p as one (W,) element on ``ctx.device``."""
    spec = ctx.spec
    return ctx.to_device(ctx.pack(pow(1 << log_n, -1, spec.modulus) * spec.R % spec.modulus))


def transform(ctx: FieldCtx, table, inverse: bool = False):
    """The transform of ``ntt`` without the inverse's scaling by n^-1: one
    ``ntt_phase1`` and one ``ntt_stage`` a later stage, for one table or for
    every table of a (B, 2^k, W) batch."""
    n = table.shape[-2] if table.dim() >= 2 else 0
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError("Length must be a power of 2")
    tw = nk.stage_twiddles(ctx, log_n, inverse)
    log_tile = min(nk.LOG_TILE, log_n)
    out = nk.ntt_phase1(ctx, table, tw, log_tile)
    for stage in range(log_tile + 1, log_n + 1):
        out = nk.ntt_stage(ctx, out, tw, stage)
    return out


def ntt(ctx: FieldCtx, table, inverse: bool = False):
    """NTT of a (2^k, W) Montgomery table -> same shape; of a (B, 2^k, W) batch,
    table by table, in the same launches as one table.

    Forward: values -> evaluations at successive powers of the 2^k-th root
    (natural order), identical to the reference's recursive ``dft``. Inverse:
    the transform at the inverse root, scaled by n^-1.
    """
    out = transform(ctx, table, inverse)
    if inverse:
        out = fk.mont_mul(ctx, out, _n_inv_mont(ctx, table.shape[-2].bit_length() - 1))
    return out


# ----------------------------------------------------------------------
# reference-shaped API (host ints in/out)
# ----------------------------------------------------------------------

def fft_evaluate(poly: UnivariatePoly, device=None) -> list[int]:
    """Evaluate at all n-th roots of unity (reference :31-41). ``device=None``
    means the CUDA device, as ``get_ctx``."""
    ctx = fb.get_ctx(poly.spec, device)
    table = fk.to_mont(ctx, ctx.to_device(ctx.pack(poly.coefficients)))
    out = fk.from_mont(ctx, ntt(ctx, table))
    return [int(v) for v in ctx.unpack(out)]


def fft_interpolate(spec: FieldSpec, evaluations: list[int], device=None) -> UnivariatePoly:
    """Inverse transform back to coefficients (reference :43-60)."""
    ctx = fb.get_ctx(spec, device)
    table = fk.to_mont(ctx, ctx.to_device(ctx.pack(evaluations)))
    out = fk.from_mont(ctx, ntt(ctx, table, inverse=True))
    return UnivariatePoly(spec, [int(v) for v in ctx.unpack(out)])


def split_poly(values: list[int]) -> tuple[list[int], list[int]]:
    """Even/odd coefficient split (reference :62-68)."""
    return list(values[0::2]), list(values[1::2])


DEFAULT_SPEC = BN254_FR
