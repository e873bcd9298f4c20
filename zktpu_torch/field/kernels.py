"""The sumcheck / multilinear hot loops: CUDA kernel wrappers and plain versions.

The counterpart of ``zktpu/field/pallas_kernels.py``. Five functions, each with
a hand-written CUDA kernel (``csrc/sumcheck_kernels.cu``) and, beside it, a plain
PyTorch version built on ``torch_backend`` that computes the same words:

  * ``mont_mul``        -- elementwise Montgomery product (table x table, or
                           table x one element: to_mont of a whole table)
  * ``fold``            -- partial_evaluate(0, r): out = a + r*(b - a)
  * ``halves_sums``     -- [sum(first half), sum(second half)] as lazy rows
  * ``fold_and_halves`` -- fold at r AND the folded table's half-sums in the same
                           pass (what a sumcheck round actually needs)
  * ``gkr_round``       -- the three round-polynomial evaluations of the GKR
                           f(b,c) sum of two 2-factor products, as lazy rows

Dispatch is by where the tensor lies and by nothing else: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel or the call raises. There is
no fallback and no switch. The kernels take every power-of-two size from 2 up.

Lazy rows: the three summing kernels leave the modular reduction to the caller.
They return exact *integer* sums of the Montgomery words as ``W + EXTRA_WORDS``
clean 32-bit words per row (the same integers as the reference's ``N + 2`` digit
rows); ``lazy_rows_to_ints`` or ``hash.kernels.canonical_rows_plain`` reduce them
(on the card the fused provers' ``round_step`` kernel does).

``launches`` counts, per kernel, the wrapper calls that launched it, and
``lanes`` the entries those launches covered (table rows; for ``fold`` all rows
of the stack, for ``gkr_round`` the entries of one table). Nothing else touches
the counts, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import torch_backend as fb
from .torch_backend import FieldCtx

#: extra high words on lazy sum rows (headroom for tables below 2^31 entries)
EXTRA_WORDS = 1
#: cap on the block count of gkr_round (and the rows of its per-block
#: partials): enough blocks to fill the card several times over
MAX_SUM_BLOCKS = 1024
#: the summing kernels, by the index their C functions take; the first two
#: finish their rows in one launch
_SUMMING = {"halves_sums": 0, "fold_and_halves": 1, "gkr_round": 2}
_ONE_LAUNCH = ("halves_sums", "fold_and_halves")
#: tables of at most this many entries go to one block of a one-launch summing
#: kernel, which finishes both rows itself: no ticket, no fence. Up to there a
#: block's extra steps cost less than the ticket's fences and atomics (a step
#: of halves_sums is four loads a thread, of fold_and_halves a carry chain).
ONE_BLOCK_MAX = {"halves_sums": 1 << 11, "fold_and_halves": 1 << 10}

KERNEL_NAMES = ("mont_mul", "fold", "halves_sums", "fold_and_halves", "gkr_round")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: kernel name -> entries of those launches
lanes: dict[str, int] = {name: 0 for name in KERNEL_NAMES}

_WORD_MASK = 0xFFFFFFFF


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        lanes[name] = 0


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


def gkr_round_plain(ctx: FieldCtx, tables):
    """(2, 2, size, W) product stack -> (3, W+1) lazy rows of
    y_t = sum_{i < size/2} sum_p prod_f (a + t*(b - a)) for t = 0, 1, 2, with
    a, b the two halves of each table; t = 2 is b + (b - a), no product by t."""
    half = tables.shape[2] // 2
    a, b = tables[:, :, :half], tables[:, :, half:]
    v2 = fb.add(ctx, b, fb.sub(ctx, b, a))
    rows = []
    for vals in (a, b, v2):
        prod = fb.mont_mul(ctx, vals[:, 0], vals[:, 1])
        rows.append(_lazy_sum(fb.add(ctx, prod[0], prod[1])))
    return torch.stack(rows)


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "zk_block_threads": [],
    "zk_sum_threads": [ctypes.c_int, ctypes.c_int],
    "zk_resident_blocks": [ctypes.c_int, ctypes.c_int],
    "zk_sum_scratch_words": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "zk_mont_mul": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P, ctypes.c_uint32, _P],
    "zk_fold": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P, ctypes.c_uint32, _P],
    "zk_halves_sums": [_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P],
    "zk_fold_and_halves": [
        _P, _P, _P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P,
    ],
    "zk_gkr_round": [_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P, ctypes.c_uint32, _P],
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


def _sum_blocks(lib, per_row: int) -> int:
    threads = lib.zk_block_threads()
    return max(1, min(-(-per_row // threads), MAX_SUM_BLOCKS))


@functools.lru_cache(maxsize=None)
def _resident_blocks(lib, device, name: str, w: int) -> int:
    """Blocks of a summing kernel that the card holds at once (by its
    registers and shared memory)."""
    with torch.cuda.device(device):
        n = lib.zk_resident_blocks(_SUMMING[name], w)
    if n <= 0:
        raise RuntimeError(f"occupancy query of {name} failed ({n})")
    return n


def _gkr_round_blocks(lib, device, w: int, half: int) -> int:
    """A thread an (index, t) pair where all 3 half pairs fit in one wave of
    resident threads (two blocks an SM at W = 8), that is, on small tables,
    where a launch's latency is its time; else a thread an index. The kernel
    tells the two apart by the grid's size."""
    threads = lib.zk_block_threads()
    pairs = 3 * half
    if pairs <= _resident_blocks(lib, device, "gkr_round", w) * threads:
        return -(-pairs // threads)
    return _sum_blocks(lib, half)


@functools.lru_cache(maxsize=None)
def _one_launch_blocks(lib, device, name: str, w: int, size: int) -> int:
    """Blocks a row of ``halves_sums`` or ``fold_and_halves`` on a (size, W)
    table: 0 (one block takes both rows) up to ``ONE_BLOCK_MAX`` entries, else
    four 16-byte vectors a thread (halves_sums) or an output a thread, at most
    one wave of resident blocks for the two rows."""
    if size <= ONE_BLOCK_MAX[name]:
        return 0
    threads = lib.zk_sum_threads(_SUMMING[name], w)
    if name == "halves_sums":
        entries, per_block = size // 2, threads * 4 * 4 // w
    else:
        entries, per_block = size // 4, threads
    cap = _resident_blocks(lib, device, name, w) // 2
    return max(1, min(-(-entries // per_block), cap))


#: (device, stream) -> the uint64 scratch of the one-launch summing kernels on
#: that stream: the two tickets that elect each row's last block, zeroed here
#: once (the last block resets its row's, so no call pays a launch for it), then
#: room for the partials of one wave of blocks of either kernel at either width
_scratch: dict[tuple, torch.Tensor] = {}


def _sum_scratch(lib, device, stream: int) -> torch.Tensor:
    buf = _scratch.get((device, stream))
    if buf is None:
        words = max(lib.zk_sum_scratch_words(_SUMMING[name], w,
                                             _resident_blocks(lib, device, name, w) // 2)
                    for name in _ONE_LAUNCH for w in (8, 12))
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _scratch[(device, stream)] = buf
    return buf


def _one_launch_args(lib, ctx: FieldCtx, name: str, size: int, blocks):
    """(stream, scratch, blocks a row) of one launch of a one-launch summing
    kernel, inside ``torch.cuda.device(ctx.device)``; ``blocks`` None is the
    default grid, anything else (0: one block) is checked against the scratch."""
    w = ctx.num_words
    stream = _stream(ctx)
    scratch = _sum_scratch(lib, ctx.device, stream)
    if blocks is None:
        return stream, scratch, _one_launch_blocks(lib, ctx.device, name, w, size)
    if blocks < 0 or lib.zk_sum_scratch_words(_SUMMING[name], w, blocks) > scratch.numel():
        raise ValueError(f"{name}: {blocks} blocks a row do not fit the scratch")
    return stream, scratch, blocks


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def mont_mul(ctx: FieldCtx, a, b):
    """Elementwise a*b*R^{-1} mod p over (..., W) tables ``a`` and ``b``; ``b``
    has ``a``'s shape or is one (W,) element that multiplies every row."""
    _check(ctx, "mont_mul a", a)
    one_element = b.dim() == 1 and a.dim() != 1
    _check(ctx, "mont_mul b", b, (ctx.num_words,) if one_element else a.shape)
    if a.device.type == "cpu":
        return mont_mul_plain(ctx, a, b)
    lib = library()
    out = torch.empty_like(a)
    with torch.cuda.device(ctx.device):
        err = lib.zk_mont_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // ctx.num_words,
            0 if one_element else ctx.num_words, ctx.num_words, ctx.p_words_c, ctx.n0_prime32,
            _stream(ctx),
        )
    _raise_on(err, "mont_mul")
    launches["mont_mul"] += 1
    lanes["mont_mul"] += a.numel() // ctx.num_words
    return out


def to_mont(ctx: FieldCtx, a):
    """(..., W) words -> Montgomery domain, through ``mont_mul`` by R^2: one
    launch on the card, whatever the batch. Takes unreduced words (< R)."""
    return mont_mul(ctx, a.reshape(-1, ctx.num_words), ctx.r2).reshape(a.shape)


def from_mont(ctx: FieldCtx, a):
    """(..., W) Montgomery words -> canonical words, through ``mont_mul`` by 1."""
    return mont_mul(ctx, a.reshape(-1, ctx.num_words), ctx.one_plain).reshape(a.shape)


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
    lanes["fold"] += lead_n * size
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
    return _launch_halves_sums(ctx, table)


def _launch_halves_sums(ctx: FieldCtx, table, blocks: int | None = None):
    """One launch of the kernel, ``blocks`` blocks a row, 0 for one block that
    takes both rows (default: by the table's size and the card's residency)."""
    lib = library()
    size, w = table.shape
    rows = torch.empty((2, w + EXTRA_WORDS), dtype=torch.int32, device=table.device)
    with torch.cuda.device(ctx.device):
        stream, scratch, blocks = _one_launch_args(lib, ctx, "halves_sums", size, blocks)
        err = lib.zk_halves_sums(
            table.data_ptr(), scratch.data_ptr(), rows.data_ptr(), size, blocks, w, stream
        )
    _raise_on(err, "halves_sums")
    launches["halves_sums"] += 1
    lanes["halves_sums"] += size
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
    return _launch_fold_and_halves(ctx, table, r)


def _launch_fold_and_halves(ctx: FieldCtx, table, r, blocks: int | None = None):
    """One launch of the kernel, ``blocks`` blocks a row, 0 for one block that
    takes both rows (default: by the table's size and the card's residency)."""
    lib = library()
    size, w = table.shape
    out = torch.empty((size // 2, w), dtype=torch.int32, device=table.device)
    rows = torch.empty((2, w + EXTRA_WORDS), dtype=torch.int32, device=table.device)
    with torch.cuda.device(ctx.device):
        stream, scratch, blocks = _one_launch_args(lib, ctx, "fold_and_halves", size, blocks)
        err = lib.zk_fold_and_halves(
            table.data_ptr(), r.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            rows.data_ptr(), size, blocks, w, ctx.p_words_c, ctx.n0_prime32, stream,
        )
    _raise_on(err, "fold_and_halves")
    launches["fold_and_halves"] += 1
    lanes["fold_and_halves"] += size
    return out, rows


def gkr_round(ctx: FieldCtx, tables):
    """Lazy rows (3, W+1) of the degree-2 GKR round evaluations y_0, y_1, y_2 of
    a (2, 2, size, W) stack (product, factor, entry, word); reduce with
    ``lazy_rows_to_ints`` or ``hash.kernels.canonical_rows_plain``."""
    _check(ctx, "gkr_round tables", tables)
    if tables.dim() != 4 or tuple(tables.shape[:2]) != (2, 2):
        raise ValueError("gkr_round: expected a (2, 2, size, W) stack")
    size, w = tables.shape[2:]
    _check_size("gkr_round", size)
    if tables.device.type == "cpu":
        return gkr_round_plain(ctx, tables)
    lib = library()
    nb = _gkr_round_blocks(lib, tables.device, w, size // 2)
    # per-block column sums of the three rows' W + 1 words
    partials = torch.empty((3, nb, w + EXTRA_WORDS), dtype=torch.int64, device=tables.device)
    rows = torch.empty((3, w + EXTRA_WORDS), dtype=torch.int32, device=tables.device)
    with torch.cuda.device(ctx.device):
        err = lib.zk_gkr_round(
            tables.data_ptr(), partials.data_ptr(), rows.data_ptr(), size, nb, w,
            ctx.p_words_c, ctx.n0_prime32, _stream(ctx),
        )
    _raise_on(err, "gkr_round")
    launches["gkr_round"] += 1
    lanes["gkr_round"] += size
    return rows
