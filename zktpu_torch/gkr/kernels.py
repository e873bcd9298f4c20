"""The fused GKR phase program: CUDA kernel wrappers and their plain versions.

zktpu runs each sumcheck phase of a lazy GKR layer on the chip as a few
compiled XLA programs (``zktpu/gkr/fused_lazy.py``): one ``_big_round`` (:216)
for each round whose table is above its ``SCAN_SIZE``, then one
``_scan_phase_fixed`` (:155) for all the remaining rounds of the phase. Here
they are two hand-written CUDA kernels (``csrc/gkr_phase_kernels.cu``, on
``csrc/gkr_phase.cuh``, ``csrc/transcript.cuh``, ``csrc/sums.cuh`` and
``csrc/mont.cuh``), each with a plain PyTorch version beside it that computes
the same words:

  * ``gkr_big_round``  -- one round in one launch: fold the (2, 2, size, W)
                          stack at the last round's challenge (none in a
                          phase's first round), the folded stack's lazy rows
                          y_0, y_1, y_2 in the same pass, and in the last block
                          to finish the round's transcript step
                          (``round_step``'s work: the canonical coefficients,
                          the trimmed absorb, the state, the next challenge);
  * ``gkr_phase_tail`` -- every remaining round of a phase in one launch, down
                          to the table of two entries, and the last fold,
                          whose one entry of the [0, 0] table is w(r_b) after
                          phase 1. A round that sums at most ``BLOCK_MAX``
                          entries a table runs on one block, the stack in its
                          shared memory; a wider one on its busy blocks of a
                          cooperative grid, which meet block 0 at a counter
                          and a flag.

The plain versions are the port's earlier per-round chain: ``fold_plain``, then
``gkr_round_plain``, then ``round_step_plain`` (``field.kernels``,
``hash.kernels``), a loop of those for the tail.

A round's kind follows from its challenge: with ``r`` None it is a phase's
first round, which continues the host's sponge ``state`` after its pending
``tail`` (at most 16 lanes) and folds nothing; with ``r`` it folds at ``r``
first and absorbs ``state``'s digest (its first four lanes) into a fresh
sponge. Both take a 32-byte field.

Dispatch is by where the tensor lies and by nothing else: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel or the call raises.
``launches`` counts, per kernel, the wrapper calls that launched it, ``lanes``
the rounds they took, and ``calls`` splits the launches by what their cost
depends on: (kernel, entries of a table of the stack given, whether its first
round folds).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..field import kernels as fk
from ..field.torch_backend import FieldCtx
from ..hash import kernels as tk

#: rows of a GKR round (y_0, y_1, y_2) and the words of its field
ROWS, WORDS = tk.GKR_ROWS, tk.WORDS
STATE_LANES = tk.STATE_LANES
#: cap on the blocks of a gkr_big_round launch: enough to fill the card several
#: times over (an index a thread at 2^20 entries)
MAX_BIG_BLOCKS = 1024
#: the rounds of a ``gkr_phase_tail`` that sum at most this many entries a
#: table run on one block, in its shared memory, with no grid-wide wait (a
#: power of two, 1 to 2^10, the most the block's shared memory holds; 1: no
#: such round). On an H100 the walk's 40 tails took least device time at 2^7
#: of 2^5 to 2^10 (``scripts/time_kernels.py``'s ``tail`` part): a larger
#: round on one block is a longer chain of products on each thread than the
#: grid's wait costs. A module attribute, read at call time (tests force it
#: down).
BLOCK_MAX = 1 << 7

KERNEL_NAMES = ("gkr_big_round", "gkr_phase_tail")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: kernel name -> rounds those launches took
lanes: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: (kernel, entries a table of the stack given, first round folds) -> launches
calls: dict[tuple[str, int, bool], int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        lanes[name] = 0
    calls.clear()


def tail_rounds(size: int, fold: bool) -> int:
    """Rounds of a phase tail on a stack of ``size`` entries a table: until the
    summed table has two entries (a fold first halves it)."""
    log = size.bit_length() - 1
    return log - 1 if fold else log


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def gkr_big_round_plain(ctx: FieldCtx, tables, r, state, tail=None, out=None):
    """One round in plain PyTorch; the arguments and results of
    ``gkr_big_round``: ``fold_plain`` (when ``r`` is given), ``gkr_round_plain``,
    ``round_step_plain``."""
    _check_round(ctx, "gkr_big_round", tables, r, state, tail, 4 if r is not None else 2)
    if r is not None:
        tables = fk.fold_plain(ctx, tables, r)
    rows = fk.gkr_round_plain(ctx, tables)
    coeffs, state, challenge = tk.round_step_plain(ctx, rows, state, tail, out)
    return tables, coeffs, state, challenge


def gkr_phase_tail_plain(ctx: FieldCtx, tables, r, state, tail=None, out=None):
    """The rest of a phase in plain PyTorch, a loop of ``gkr_big_round_plain``;
    the arguments and results of ``gkr_phase_tail``."""
    _check_round(ctx, "gkr_phase_tail", tables, r, state, tail, 4 if r is not None else 2)
    rounds = tail_rounds(tables.shape[2], r is not None)
    out = _rows_out(ctx, out, rounds)
    for k in range(rounds):
        tables, _, state, r = gkr_big_round_plain(ctx, tables, r, state,
                                                  tail if k == 0 else None, out[k])
    return out, fk.fold_plain(ctx, tables[0, 0], r)[0], state


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "zk_gkr_phase_threads": [],
    "zk_gkr_phase_resident": [_I],
    "zk_gkr_phase_scratch_words": [_I],
    "zk_gkr_big_round": [_P, _LL, _P, _P, _P, _P, _I, _P, _U32, _P, _P, _P, _P, _P, _P, _I, _P],
    "zk_gkr_phase_tail": [_P, _LL, _P, _P, _P, _P, _I, _P, _U32, _P, _P, _P, _P, _P, _P, _P, _I,
                          _LL, _P],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("gkr_phase_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib._zk_typed = True
    return lib


def _check_round(ctx: FieldCtx, name: str, tables, r, state, tail, least: int) -> None:
    """Raise on anything the kernels do not take."""
    if ctx.num_words != WORDS:
        raise ValueError(f"{name}: the transcript takes a 32-byte field, not {ctx.spec.name}")
    fk._check(ctx, f"{name} tables", tables)
    if tables.dim() != 4 or tuple(tables.shape[:2]) != (2, 2):
        raise ValueError(f"{name}: expected a (2, 2, size, W) stack, got {tuple(tables.shape)}")
    size = tables.shape[2]
    fk._check_size(name, size)
    if size < least:
        raise ValueError(f"{name}: a stack of {size} entries a table; this round takes "
                         f"{least} at the least")
    if (r is None) == (tail is None):
        raise ValueError(f"{name}: a phase's first round takes the host's pending tail and no "
                         "challenge, every other round a challenge and no tail")
    if r is not None:
        fk._check(ctx, f"{name} r", r, (WORDS,))
    tk._check_tensor(f"{name} state", state, torch.int64, (STATE_LANES,), ctx.device)
    if tail is not None:
        tk._check_tensor(f"{name} tail", tail, torch.int64, None, ctx.device)
        if tail.dim() != 1 or tail.shape[0] > tk.RATE_LANES - 1:
            raise ValueError(f"{name}: a pending tail is under {tk.RATE_LANES} lanes, "
                             f"got {tuple(tail.shape)}")


def _rows_out(ctx: FieldCtx, out, rounds: int):
    """The (rounds, 3, W) coefficient rows' destination, checked, or a new one."""
    shape = (rounds, ROWS, WORDS)
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=ctx.device)
    tk._check_tensor("gkr_phase_tail out", out, torch.int32, shape, ctx.device)
    return out


@functools.lru_cache(maxsize=None)
def _resident(lib, device) -> int:
    """Blocks of gkr_phase_tail that the card holds at once, with its largest
    shared memory: the most a cooperative launch may take."""
    with torch.cuda.device(device):
        n = lib.zk_gkr_phase_resident(1)
    if n <= 0:
        raise RuntimeError(f"occupancy query of gkr_phase_tail failed ({n})")
    return n


#: (device, stream) -> the uint64 scratch of both kernels on that stream: the
#: big round's ticket and the tail's counter and flag, zeroed here once (the
#: kernels reset them), then room for the partials of the larger of the two
#: grids
_scratch: dict[tuple, torch.Tensor] = {}


def _phase_scratch(lib, device, stream: int) -> torch.Tensor:
    buf = _scratch.get((device, stream))
    if buf is None:
        blocks = max(MAX_BIG_BLOCKS, _resident(lib, device))
        buf = torch.zeros(lib.zk_gkr_phase_scratch_words(blocks), dtype=torch.int64, device=device)
        _scratch[(device, stream)] = buf
    return buf


def _blocks(lib, indices: int, cap: int) -> int:
    threads = lib.zk_gkr_phase_threads()
    return max(1, min(-(-indices // threads), cap))


def _count(name: str, size: int, fold: bool, rounds: int) -> None:
    launches[name] += 1
    lanes[name] += rounds
    key = (name, size, fold)
    calls[key] = calls.get(key, 0) + 1


def _prefix(state, tail):
    """(the prefix a round absorbs first, its lanes): the host's pending tail
    in a phase's first round, else the last state's digest."""
    return (state, WORDS // 2) if tail is None else (tail, tail.shape[0])


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def gkr_big_round(ctx: FieldCtx, tables, r, state, tail=None, out=None):
    """One round of a GKR phase in one launch on the card.

    ``tables``: the (2, 2, size, W) stack of the last round, folded here at its
    challenge ``r`` (W Montgomery words on the device; None in a phase's first
    round, which folds nothing). ``state``: (25,) lanes: the host's sponge in a
    phase's first round (``tail`` its pending lanes), else the last round's
    state, whose digest is absorbed. ``out``: where the (3, W) canonical
    coefficients go (a slot of the phase's rows), or None for a new tensor.

    Returns (the stack this round summed, its canonical coefficient rows, the
    new (25,) state, the (W,) next challenge in Montgomery form)."""
    _check_round(ctx, "gkr_big_round", tables, r, state, tail, 4 if r is not None else 2)
    if out is not None:
        tk._check_tensor("gkr_big_round out", out, torch.int32, (ROWS, WORDS), ctx.device)
    if tables.device.type == "cpu":
        return gkr_big_round_plain(ctx, tables, r, state, tail, out)
    lib = library()
    size = tables.shape[2]
    fold = r is not None
    dev = ctx.device
    folded = torch.empty((2, 2, size // 2, WORDS), dtype=torch.int32, device=dev) if fold else tables
    if out is None:
        out = torch.empty((ROWS, WORDS), dtype=torch.int32, device=dev)
    new_state = torch.empty(STATE_LANES, dtype=torch.int64, device=dev)
    challenge = torch.empty(WORDS, dtype=torch.int32, device=dev)
    prefix, prefix_lanes = _prefix(state, tail)
    r2, inv2 = tk._host_words(ctx.spec)[0]
    with torch.cuda.device(dev):
        stream = tk._stream(dev)
        scratch = _phase_scratch(lib, dev, stream)
        nbr = _blocks(lib, size // 4 if fold else size // 2, MAX_BIG_BLOCKS)
        err = lib.zk_gkr_big_round(
            tables.data_ptr(), size, r.data_ptr() if fold else None,
            folded.data_ptr() if fold else None, state.data_ptr(), prefix.data_ptr(),
            prefix_lanes, ctx.p_words_c, ctx.n0_prime32, r2, inv2, out.data_ptr(),
            new_state.data_ptr(), challenge.data_ptr(), scratch.data_ptr(), nbr, stream,
        )
    fk._raise_on(err, "gkr_big_round")
    _count("gkr_big_round", size, fold, 1)
    return folded, out, new_state, challenge


def gkr_phase_tail(ctx: FieldCtx, tables, r, state, tail=None, out=None):
    """Every remaining round of a GKR phase, and its last fold, in one launch
    on the card: its rounds above ``BLOCK_MAX`` entries on a cooperative grid,
    the rest on one block.

    ``tables``, ``r``, ``state``, ``tail``: as for ``gkr_big_round``; the tail
    runs rounds until the summed table has two entries (``tail_rounds``), each
    folding at the last one's challenge, then folds the [0, 0] table at the
    last challenge. ``out``: where the (rounds, 3, W) coefficient rows go (the
    phase's last slots), or None. ``tables`` is not written: the folds go to a
    work buffer of half its size.

    Returns (the coefficient rows, the (W,) one entry of the [0, 0] table
    folded to the end -- w(r_b) after phase 1 --, the last (25,) state)."""
    _check_round(ctx, "gkr_phase_tail", tables, r, state, tail, 4 if r is not None else 2)
    size = tables.shape[2]
    fold = r is not None
    rounds = tail_rounds(size, fold)
    out = _rows_out(ctx, out, rounds)
    if tables.device.type == "cpu":
        return gkr_phase_tail_plain(ctx, tables, r, state, tail, out)
    lib = library()
    dev = ctx.device
    # the work buffer, then each round's challenge, then w(r_b): 16-byte starts
    words = torch.empty(4 * (size // 2) * WORDS + (rounds + 1) * WORDS, dtype=torch.int32,
                        device=dev)
    work = words[: 4 * (size // 2) * WORDS]
    challenges = words[work.numel():-WORDS]
    wb = words[-WORDS:]
    states = torch.empty((rounds, STATE_LANES), dtype=torch.int64, device=dev)
    prefix, prefix_lanes = _prefix(state, tail)
    r2, inv2 = tk._host_words(ctx.spec)[0]
    with torch.cuda.device(dev):
        stream = tk._stream(dev)
        scratch = _phase_scratch(lib, dev, stream)
        err = lib.zk_gkr_phase_tail(
            tables.data_ptr(), size, work.data_ptr(), r.data_ptr() if fold else None,
            state.data_ptr(), prefix.data_ptr(), prefix_lanes, ctx.p_words_c, ctx.n0_prime32,
            r2, inv2, out.data_ptr(), states.data_ptr(), challenges.data_ptr(), wb.data_ptr(),
            scratch.data_ptr(), _resident(lib, dev), BLOCK_MAX, stream,
        )
    fk._raise_on(err, "gkr_phase_tail")
    _count("gkr_phase_tail", size, fold, rounds)
    return out, wb, states[-1]
