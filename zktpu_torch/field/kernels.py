"""The sumcheck / multilinear hot loops: CUDA kernel wrappers and plain versions.

The counterpart of ``zktpu/field/pallas_kernels.py``. Four functions, each with
a hand-written CUDA kernel (``csrc/sumcheck_kernels.cu``) and, beside it, a plain
PyTorch version built on ``torch_backend`` that computes the same words:

  * ``mont_mul``        -- elementwise Montgomery product (table x table, or
                           table x one element: to_mont of a whole table)
  * ``fold``            -- partial_evaluate(0, r): out = a + r*(b - a)
  * ``halves_sums``     -- [sum(first half), sum(second half)] as lazy rows
  * ``fold_and_halves`` -- fold at r AND the folded table's half-sums in the same
                           pass (what a sumcheck round actually needs)

Dispatch is by where the tensor lies and by nothing else: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel or the call raises. There is
no fallback and no switch. The kernels take every power-of-two size from 2 up.

Lazy rows: the two summing kernels leave the modular reduction to the caller.
They return exact *integer* sums of the Montgomery words as ``W + EXTRA_WORDS``
clean 32-bit words per row (the same integers as the reference's ``N + 2`` digit
rows); ``lazy_rows_to_ints`` or ``sumcheck.fused._canonicalize_rows`` reduce them.

``launches`` counts, per kernel, the wrapper calls that launched it. Nothing else
touches the counts, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import torch_backend as fb
from .torch_backend import FieldCtx

#: extra high words on lazy sum rows (headroom for tables below 2^31 entries)
EXTRA_WORDS = 1
#: cap on the per-half block count of the summing kernels (and the rows of their
#: per-block partials): enough blocks to fill the card several times over
MAX_SUM_BLOCKS = 1024

KERNEL_NAMES = ("mont_mul", "fold", "halves_sums", "fold_and_halves")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}

_WORD_MASK = 0xFFFFFFFF


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def lazy_rows_to_ints(ctx: FieldCtx, rows, from_mont: bool = True) -> list[int]:
    """(k, W+1) lazy word rows -> canonical ints mod p.

    Rows are exact integer sums of Montgomery-domain table entries; reducing
    mod p and stripping the Montgomery factor on the host costs O(k) bigint ops.
    """
    spec = ctx.spec
    p = spec.modulus
    r_inv = pow(spec.R, -1, p) if from_mont else 1
    return [spec.from_words(row) * r_inv % p for row in fb.tensor_to_words(rows)]


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def mont_mul_plain(ctx: FieldCtx, a, b):
    return fb.mont_mul(ctx, a, b)


def fold_plain(ctx: FieldCtx, table, r):
    *lead, size, w = table.shape
    shaped = table.reshape(*lead, 2, size // 2, w)
    return fb.lerp(ctx, shaped[..., 0, :, :], shaped[..., 1, :, :], r)


def _lazy_sum(x):
    """(k, W) words -> (W + 1,) words of their exact integer sum (k < 2^31)."""
    cols = (x.to(torch.int64) & _WORD_MASK).sum(dim=0)
    out = []
    c = torch.zeros((), dtype=torch.int64, device=x.device)
    for j in range(x.shape[1]):
        v = cols[j] + c
        out.append(v & _WORD_MASK)
        c = v >> 32
    out.append(c)
    w = torch.stack(out)
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def halves_sums_plain(ctx: FieldCtx, table):
    half = table.shape[0] // 2
    return torch.stack([_lazy_sum(table[:half]), _lazy_sum(table[half:])])


def fold_and_halves_plain(ctx: FieldCtx, table, r):
    folded = fold_plain(ctx, table, r)
    return folded, halves_sums_plain(ctx, folded)


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "zk_block_threads": [],
    "zk_mont_mul": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P, ctypes.c_uint32, _P],
    "zk_fold": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P, ctypes.c_uint32, _P],
    "zk_halves_sums": [_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P],
    "zk_fold_and_halves": [
        _P, _P, _P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P,
    ],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("sumcheck_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib._zk_typed = True
    return lib


def _check(ctx: FieldCtx, name: str, t, shape=None) -> None:
    """Raise on anything the kernels do not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.device != ctx.device:
        raise ValueError(f"{name}: tensor on {t.device}, context on {ctx.device}")
    if t.dim() < 1 or t.shape[-1] != ctx.num_words:
        raise ValueError(f"{name}: last dimension must be {ctx.num_words} words")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensor must start on a 16-byte boundary")


def _check_size(name: str, size: int) -> None:
    if size < 2 or size & (size - 1) or size >= 1 << 31:
        raise ValueError(f"{name}: table size must be a power of two in [2, 2^31), got {size}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


def _stream(ctx: FieldCtx) -> int:
    return torch.cuda.current_stream(ctx.device).cuda_stream


def _sum_blocks(lib, per_half: int) -> int:
    threads = lib.zk_block_threads()
    return max(1, min(-(-per_half // threads), MAX_SUM_BLOCKS))


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def mont_mul(ctx: FieldCtx, a, b):
    """Elementwise a*b*R^{-1} mod p over a (size, W) table ``a`` and ``b``,
    which is a table of the same shape or one (W,) element for every row."""
    _check(ctx, "mont_mul a", a)
    if a.dim() != 2:
        raise ValueError("mont_mul: expected a (size, W) table")
    _check(ctx, "mont_mul b", b, a.shape if b.dim() != 1 else (ctx.num_words,))
    if a.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    lib = library()
    out = torch.empty_like(a)
    with torch.cuda.device(ctx.device):
        err = lib.zk_mont_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
            ctx.num_words if b.dim() == 2 else 0, ctx.num_words, ctx.p_words_c, ctx.n0_prime32, _stream(ctx),
        )
    _raise_on(err, "mont_mul")
    launches["mont_mul"] += 1
    return out


def to_mont(ctx: FieldCtx, a):
    """(..., W) words -> Montgomery domain, through ``mont_mul`` by R^2: one
    launch on the card, whatever the batch. Takes unreduced words (< R)."""
    flat = a.reshape(-1, ctx.num_words)
    return mont_mul(ctx, flat, ctx.r2).reshape(a.shape)


def from_mont(ctx: FieldCtx, a):
    """(..., W) Montgomery words -> canonical words, through ``mont_mul`` by 1."""
    flat = a.reshape(-1, ctx.num_words)
    return mont_mul(ctx, flat, ctx.one_plain).reshape(a.shape)


def fold(ctx: FieldCtx, table, r):
    """Fold variable 0 of (..., size, W) tables at ``r`` (W words, Montgomery,
    on the table's device): out = a + r*(b - a) over the two halves."""
    _check(ctx, "fold table", table)
    _check(ctx, "fold r", r, (ctx.num_words,))
    if table.dim() < 2:
        raise ValueError("fold: expected (..., size, W) tables")
    *lead, size, w = table.shape
    _check_size("fold", size)
    if table.device.type == "cpu":
        return fold_plain(ctx, table, r)
    lib = library()
    lead_n = 1
    for d in lead:
        lead_n *= d
    out = torch.empty((*lead, size // 2, w), dtype=torch.int32, device=table.device)
    with torch.cuda.device(ctx.device):
        err = lib.zk_fold(
            table.data_ptr(), r.data_ptr(), out.data_ptr(), lead_n, size, w,
            ctx.p_words_c, ctx.n0_prime32, _stream(ctx),
        )
    _raise_on(err, "fold")
    launches["fold"] += 1
    return out


def halves_sums(ctx: FieldCtx, table):
    """Lazy rows [sum(first half), sum(second half)] of a (size, W) table, as
    (2, W+1) words; reduce with ``lazy_rows_to_ints``."""
    _check(ctx, "halves_sums table", table)
    if table.dim() != 2:
        raise ValueError("halves_sums: expected a (size, W) table")
    size, w = table.shape
    _check_size("halves_sums", size)
    if table.device.type == "cpu":
        return halves_sums_plain(ctx, table)
    lib = library()
    nb = _sum_blocks(lib, size // 2)
    partials = torch.empty((2, nb, w), dtype=torch.int64, device=table.device)
    rows = torch.empty((2, w + EXTRA_WORDS), dtype=torch.int32, device=table.device)
    with torch.cuda.device(ctx.device):
        err = lib.zk_halves_sums(
            table.data_ptr(), partials.data_ptr(), rows.data_ptr(), size, nb, w, _stream(ctx)
        )
    _raise_on(err, "halves_sums")
    launches["halves_sums"] += 1
    return rows


def fold_and_halves(ctx: FieldCtx, table, r):
    """Fold a (size, W) table at ``r`` and return (folded, lazy half-sum rows of
    folded): one sumcheck round's work in a single pass over the table."""
    _check(ctx, "fold_and_halves table", table)
    _check(ctx, "fold_and_halves r", r, (ctx.num_words,))
    if table.dim() != 2:
        raise ValueError("fold_and_halves: expected a (size, W) table")
    size, w = table.shape
    _check_size("fold_and_halves", size)
    if table.device.type == "cpu":
        return fold_and_halves_plain(ctx, table, r)
    lib = library()
    nb = _sum_blocks(lib, max(1, size // 4))
    out = torch.empty((size // 2, w), dtype=torch.int32, device=table.device)
    partials = torch.empty((2, nb, w), dtype=torch.int64, device=table.device)
    rows = torch.empty((2, w + EXTRA_WORDS), dtype=torch.int32, device=table.device)
    with torch.cuda.device(ctx.device):
        err = lib.zk_fold_and_halves(
            table.data_ptr(), r.data_ptr(), out.data_ptr(), partials.data_ptr(),
            rows.data_ptr(), size, nb, w, ctx.p_words_c, ctx.n0_prime32, _stream(ctx),
        )
    _raise_on(err, "fold_and_halves")
    launches["fold_and_halves"] += 1
    return out, rows
