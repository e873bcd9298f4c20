"""The radix-2 NTT's two kernels: CUDA wrappers, plain versions, twiddle table.

The counterpart of ``zktpu/ntt/pallas_ntt.py``. Two functions, each with a
hand-written CUDA kernel (``csrc/ntt_kernels.cu``) and, beside it, a plain
PyTorch version built on ``torch_backend`` that computes the same words:

  * ``ntt_phase1`` -- the bit-reversal gather, then stages 1..log_tile inside
                      tiles of 2^log_tile entries; replaces ``_phase1_kernel``
  * ``ntt_stage``  -- one radix-2 stage over the whole table, written to its
                      final rows; replaces ``_phase2_stage``

A transform of 2^log_n entries is ``ntt_phase1`` at ``log_tile = min(10,
log_n)`` and one ``ntt_stage`` for each later stage (``ntt.ntt`` does that).
Both take a batch: a (B, 2^log_n, W) stack of tables is transformed table by
table in one launch of each (the row DFTs of the four-step ``parallel.mesh.
ntt_sharded``); a (2^log_n, W) table is a batch of one.

Twiddles: ``stage_twiddles`` keeps ONE device table of the n/2 Montgomery powers
of the n-th root of unity (of its inverse for the inverse transform); the stage
of span m = 2^s reads ``w_m^j = table[j * n/m]``. It is built on the device by
doubling through the ``mont_mul`` kernel and cached per (context, log_n,
direction). Beside it, ``tile_twiddles`` keeps the compact table that the
``ntt_phase1`` kernel stages into shared memory: the 2^(c-1) powers of the
2^c-th root, c = min(LOG_TILE, log_n), gathered from the big table by index
(no product), built and cached with it.

Dispatch is by where the tensor lies and by nothing else: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel or the call raises. Both
kernels take every power-of-two size from 1 and BN254 Fr / BLS12-381 Fr tables
(8 words an element).

``launches`` counts, per kernel, the wrapper calls that launched it, and
``lanes`` the table entries those launches covered (every table of a batch).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx

#: log2 of the phase-1 tile (1024 entries: 32 KB of shared memory a block, and
#: 16 KB of twiddles)
LOG_TILE = 10

KERNEL_NAMES = ("ntt_phase1", "ntt_stage")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: kernel name -> table entries of those launches
lanes: dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        lanes[name] = 0


@functools.lru_cache(maxsize=None)
def bitrev_perm(log_n: int) -> np.ndarray:
    """Bit-reversal permutation of 2^log_n indices (zktpu ``ntt._bitrev_perm``)."""
    i = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


# ----------------------------------------------------------------------
# the twiddle table
# ----------------------------------------------------------------------

def build_twiddles(ctx: FieldCtx, log_n: int, inverse: bool):
    """The (n/2, W) table of w^k R mod p, k < n/2, w the n-th root of unity (or
    its inverse), on ``ctx.device``: t[k:2k] = t[0:k] * w^k, log2(n/2)
    ``mont_mul`` launches. Uncached; ``stage_twiddles`` caches it."""
    spec = ctx.spec
    n = 1 << log_n
    half = n // 2
    t = torch.empty((half, ctx.num_words), dtype=torch.int32, device=ctx.device)
    if half == 0:
        return t
    p = spec.modulus
    omega = spec.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, p)
    t[0] = ctx.one_mont
    k = 1
    while k < half:
        step = ctx.to_device(ctx.pack(pow(omega, k, p) * spec.R % p))
        t[k : 2 * k] = fk.mont_mul(ctx, t[:k], step)
        k *= 2
    return t


#: (ctx, log_n, inverse) -> device twiddle table; held for the life of the
#: process, as zktpu's ``_DEVICE_TW``: building it anew on every transform
#: would cost log2(n/2) launches and an upload a call
_TWIDDLES: dict = {}


#: id(table) -> (table, its compact table), for every table of ``_TWIDDLES``:
#: filled with it, and holding the table, so an id is never reused while its
#: entry exists
_TILE_TWIDDLES: dict = {}


def stage_twiddles(ctx: FieldCtx, log_n: int, inverse: bool):
    """The cached twiddle table of ``build_twiddles``."""
    key = (ctx, log_n, bool(inverse))
    table = _TWIDDLES.get(key)
    if table is None:
        table = _TWIDDLES[key] = build_twiddles(ctx, log_n, inverse)
        _TILE_TWIDDLES[id(table)] = (table, _gather_tile_twiddles(table, log_n))
    return table


def _gather_tile_twiddles(tw, log_n: int):
    c = min(LOG_TILE, log_n)
    return tw[:: 1 << (log_n - c)].contiguous()


def tile_twiddles(tw, log_n: int):
    """The compact table of ``ntt_phase1``'s kernel for the (n/2, W) twiddle
    table ``tw`` of 2^log_n entries: rows k 2^(log_n - c), k < 2^(c-1), of
    ``tw``, c = min(LOG_TILE, log_n), i.e. the powers of the 2^c-th root, which
    are all that stages 1..c read. Cached with ``stage_twiddles``' tables; for
    any other table (an uncached ``build_twiddles``) gathered anew."""
    hit = _TILE_TWIDDLES.get(id(tw))
    return hit[1] if hit is not None else _gather_tile_twiddles(tw, log_n)


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def _log_n(x) -> int:
    return x.shape[-2].bit_length() - 1


def ntt_stage_plain(ctx: FieldCtx, x, tw, stage: int):
    """Stage ``stage`` of a (2^log_n, W) table or of each table of a
    (B, 2^log_n, W) batch: a span divides the table, so the batch's groups are
    those of one table of B 2^log_n rows."""
    log_n = _log_n(x)
    half = 1 << (stage - 1)
    idx = torch.arange(half, device=x.device) << (log_n - stage)
    w = tw.index_select(0, idx)
    shaped = x.reshape(-1, 2, half, ctx.num_words)
    u, v = shaped[:, 0], shaped[:, 1]
    t = fb.mont_mul(ctx, w[None], v)
    return torch.stack([fb.add(ctx, u, t), fb.sub(ctx, u, t)], dim=1).reshape(x.shape)


def ntt_phase1_plain(ctx: FieldCtx, x, tw, log_tile: int):
    """The bit-reversal of each table (of a batch), then stages 1..log_tile."""
    perm = torch.from_numpy(bitrev_perm(_log_n(x))).to(x.device)
    y = x.index_select(-2, perm)
    for stage in range(1, log_tile + 1):
        y = ntt_stage_plain(ctx, y, tw, stage)
    return y


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "zk_ntt_phase1": [_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P],
    "zk_ntt_stage": [_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("ntt_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib._zk_typed = True
    return lib


#: tables a batch may hold (``ntt_phase1``'s grid takes them on its y axis)
MAX_BATCH = 65535


def _check(ctx: FieldCtx, name: str, x, tw) -> tuple[int, int]:
    """Raise on anything the kernels do not take; return (tables in the batch,
    log2 of a table's size). (Past 2^30 entries in all the kernels' C entry
    points refuse the call.)"""
    if ctx.num_words != 8 or not ctx.spec.two_adicity:
        raise ValueError(f"{name}: the NTT takes 8-word fields with a two-adic root, "
                         f"got {ctx.spec.name}")
    fk._check(ctx, f"{name} x", x)
    n = x.shape[-2] if x.dim() >= 2 else 0
    batch = x.shape[0] if x.dim() == 3 else 1
    if (x.dim() not in (2, 3) or not 1 <= batch <= MAX_BATCH or n < 1 or n & (n - 1)
            or n > 1 << ctx.spec.two_adicity):
        raise ValueError(f"{name}: x must be a (2^k, W) table or a (B, 2^k, W) batch with "
                         f"k <= {ctx.spec.two_adicity}, B <= {MAX_BATCH}, got {tuple(x.shape)}")
    fk._check(ctx, f"{name} tw", tw, (n // 2, ctx.num_words))
    return batch, _log_n(x)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def ntt_phase1(ctx: FieldCtx, x, tw, log_tile: int):
    """Stages 1..log_tile of the transform of the (2^log_n, W) table ``x`` taken
    in bit-reversed order, with the twiddle table ``tw`` of ``stage_twiddles``;
    of each table of a (B, 2^log_n, W) batch ``x``, in one launch."""
    batch, log_n = _check(ctx, "ntt_phase1", x, tw)
    if not 0 <= log_tile <= min(LOG_TILE, log_n):
        raise ValueError(f"ntt_phase1: log_tile must lie in [0, min({LOG_TILE}, log_n)]")
    if x.device.type == "cpu":
        return ntt_phase1_plain(ctx, x, tw, log_tile)
    lib = library()
    ctw = tile_twiddles(tw, log_n)
    out = torch.empty_like(x)
    with torch.cuda.device(ctx.device):
        err = lib.zk_ntt_phase1(
            x.data_ptr(), ctw.data_ptr(), out.data_ptr(), batch, log_n, log_tile,
            ctx.p_words_c, ctx.n0_prime32, fk._stream(ctx),
        )
    fk._raise_on(err, "ntt_phase1")
    launches["ntt_phase1"] += 1
    lanes["ntt_phase1"] += batch << log_n
    return out


def ntt_stage(ctx: FieldCtx, x, tw, stage: int):
    """Stage ``stage`` (span 2^stage) of the transform over the whole (2^log_n, W)
    table ``x``: u + w v and u - w v written to the rows of u and v of a new
    table; over each table of a (B, 2^log_n, W) batch ``x``, in one launch."""
    batch, log_n = _check(ctx, "ntt_stage", x, tw)
    if not 1 <= stage <= log_n:
        raise ValueError("ntt_stage: stage must lie in [1, log_n]")
    if x.device.type == "cpu":
        return ntt_stage_plain(ctx, x, tw, stage)
    lib = library()
    out = torch.empty_like(x)
    with torch.cuda.device(ctx.device):
        err = lib.zk_ntt_stage(
            x.data_ptr(), tw.data_ptr(), out.data_ptr(), batch, log_n, stage,
            ctx.p_words_c, ctx.n0_prime32, fk._stream(ctx),
        )
    fk._raise_on(err, "ntt_stage")
    launches["ntt_stage"] += 1
    lanes["ntt_stage"] += batch << log_n
    return out
