"""The device transcript: CUDA kernel wrappers and their plain versions.

zktpu runs the Fiat-Shamir transcript of its fused provers on the chip inside
one compiled program: the whole sumcheck prover
(``zktpu/sumcheck/fused.py:_device_prove``) and each big GKR round
(``zktpu/gkr/fused_lazy.py:_big_round``), with the Keccak permutation of
``zktpu/hash/keccak_device.py:keccak_f``. These are plain XLA, not Pallas. Here
they are two hand-written CUDA kernels (``csrc/transcript_kernels.cu``, on
``csrc/keccak.cuh``, ``csrc/transcript.cuh``, ``csrc/mont.cuh`` and
``csrc/warp.cuh``), each with a plain PyTorch version beside it that computes
the same bits:

  * ``keccak_f``   -- Keccak-f[1600] on a batch of (..., 25) int64 lane states,
                      one thread a state;
  * ``round_step`` -- one transcript round of a fused prover on one warp,
                      from the summing kernel's lazy rows to the next
                      challenge: canonical values,
                      for GKR (k = 3 rows) the interpolation to coefficients and
                      the trimmed length, the padded absorb (the first round of a
                      proof or phase continues the host's sponge and its pending
                      tail), the new state and the challenge in Montgomery form.

A lane is one 64-bit Keccak lane in a ``torch.int64`` (the same bits; PyTorch's
right shift on int64 is arithmetic, so a plain rotation masks what it shifts
down). A state is 25 lanes, flat index j = 5 y + x, the byte offset 8 j of the
sponge. Field elements are 8 little-endian 32-bit words, so two words are a lane.

Dispatch is by where the tensor lies and by nothing else: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel or the call raises.
``launches`` counts, per kernel, the wrapper calls that launched it, and
``lanes`` the states (``keccak_f``) or rounds (``round_step``) they covered;
``rounds`` splits ``round_step``'s launches by what a round's cost depends on.
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

_I64 = torch.int64

RATE = 136  # Keccak-256 rate in bytes (17 lanes)
RATE_LANES = RATE // 8
STATE_LANES = 25
#: field words of the transcript's elements and digests: 32 bytes
WORDS = 8
#: lazy rows of a plain sumcheck round (the two half-sums) and of a GKR round
#: (y_0, y_1, y_2, interpolated and trimmed)
SUMCHECK_ROWS, GKR_ROWS = 2, 3
_TOP_BIT = -(1 << 63)  # the int64 whose only set bit is bit 63

KERNEL_NAMES = ("keccak_f", "round_step")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: kernel name -> states permuted (keccak_f) or rounds taken (round_step)
lanes: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: (rows k, prefix lanes, first round of a proof or phase) -> round_step launches
rounds: dict[tuple[int, int, bool], int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        lanes[name] = 0
    rounds.clear()


_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets indexed [x][y] (same table as the host implementation)
_ROT_XY = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

# flat-lane (j = 5y + x) constant tables for rho+pi:
#   B[5*y2 + x2] = rotl(S[5*y + x], ROT[x][y])  with x2 = y, y2 = (2x+3y) % 5
_ROTS = np.zeros(25, np.int64)
_PI_SRC = np.zeros(25, np.int64)
for _x in range(5):
    for _y in range(5):
        _dst = 5 * ((2 * _x + 3 * _y) % 5) + _y
        _ROTS[_dst] = _ROT_XY[_x][_y] % 64
        _PI_SRC[_dst] = 5 * _y + _x


def _as_i64(values) -> np.ndarray:
    """Python ints in [0, 2^64) -> the int64 with the same bits."""
    return np.asarray(values, dtype=np.uint64).view(np.int64)


class _PlainConsts:
    """Per-device constant vectors of the plain permutation, lane-major: a
    batch of states is held as (25, B), so each index and shift below acts on
    whole rows of lanes."""

    def __init__(self, device: torch.device):
        def dev(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

        # rotl(x, r) = (x << r) | ((x >> (64 - r)) & (2^r - 1)); r = 0 -> x
        self.rho_l = dev(_ROTS[:, None])
        self.rho_r = dev((64 - _ROTS[:, None]) % 64)
        self.rho_mask = dev(_as_i64([[(1 << int(r)) - 1] for r in _ROTS]))
        self.pi_src = dev(_PI_SRC)
        x = np.arange(5)
        self.col_prev = dev((x - 1) % 5)  # c[x-1]
        self.col_next = dev((x + 1) % 5)  # c[x+1]
        j = np.arange(25)
        row, col = j // 5, j % 5
        self.chi1 = dev(5 * row + (col + 1) % 5)
        self.chi2 = dev(5 * row + (col + 2) % 5)
        rc = np.zeros((24, 25, 1), np.int64)
        rc[:, 0, 0] = _as_i64(_RC)
        self.rc = dev(rc)  # iota as a full-state xor: only lane 0 is non-zero


@functools.lru_cache(maxsize=None)
def _plain_consts(device: torch.device) -> _PlainConsts:
    return _PlainConsts(device)


# ----------------------------------------------------------------------
# word <-> lane packing (field words are little-endian, so 2 words ARE one
# 64-bit lane -- no byte materialization on the device)
# ----------------------------------------------------------------------

def limbs_to_lanes(words):
    """(..., 2k) int32 words -> (..., k) int64 lanes."""
    shaped = words.reshape(words.shape[:-1] + (words.shape[-1] // 2, 2)).to(_I64)
    return (shaped[..., 0] & 0xFFFFFFFF) | (shaped[..., 1] << 32)


def lanes_to_limbs(lanes):
    """(..., k) int64 lanes -> (..., 2k) int32 words."""
    lo = ((lanes & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    hi = lanes >> 32  # arithmetic shift: already the int32 with the same bits
    out = torch.stack([lo, hi], dim=-1).to(torch.int32)
    return out.reshape(lanes.shape[:-1] + (-1,))


def absorb_pad(used_lanes: int) -> np.ndarray:
    """Padding lanes of an absorb of ``used_lanes`` lanes of content (host
    array): 0x01 after the content, 0x80 at the end of the last block, over the
    ``used_lanes // 17 + 1`` blocks the content needs."""
    blocks = used_lanes // RATE_LANES + 1
    pad = np.zeros(RATE_LANES * blocks, np.int64)
    pad[used_lanes] ^= 0x01
    pad[-1] ^= _TOP_BIT
    return pad


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def keccak_f_plain(state):
    """Keccak-f[1600] on each (..., 25) int64 lane state."""
    k = _plain_consts(state.device)
    s = state.reshape(-1, 25).T  # (25, B)
    for rnd in range(24):
        # theta
        grid = s.reshape(5, 5, -1)  # [y, x, state]
        c = grid[0] ^ grid[1] ^ grid[2] ^ grid[3] ^ grid[4]  # (5, B) over x
        cn = c[k.col_next]
        d = c[k.col_prev] ^ ((cn << 1) | ((cn >> 63) & 1))
        s = (grid ^ d).reshape(25, -1)
        # rho + pi
        b = s[k.pi_src]
        b = (b << k.rho_l) | ((b >> k.rho_r) & k.rho_mask)
        # chi, iota
        s = b ^ (~b[k.chi1] & b[k.chi2]) ^ k.rc[rnd]
    return s.T.reshape(state.shape)


@functools.lru_cache(maxsize=None)
def _host_words(spec) -> tuple:
    """R^2 mod p and to_mont(1/2) of a 32-byte field, as ctypes words (what
    ``round_step`` passes by value) and as numpy words."""
    p = spec.modulus
    values = (spec.R2, pow(2, -1, p) * (spec.R % p) % p)
    arrays = [np.array([(v >> (32 * j)) & 0xFFFFFFFF for j in range(WORDS)], dtype=np.uint32)
              for v in values]
    return tuple((ctypes.c_uint32 * WORDS)(*a.tolist()) for a in arrays), tuple(arrays)


@functools.lru_cache(maxsize=None)
def _inv2(ctx: FieldCtx):
    """to_mont(1/2) as a word tensor on the context's device: mont_mul(x, this)
    == x / 2 for canonical x."""
    return fb.words_to_tensor(_host_words(ctx.spec)[1][1], ctx.device)


def canonical_rows_plain(ctx: FieldCtx, rows):
    """(k, W+1) exact word sums of Montgomery entries -> (k, W) canonical words
    of the underlying field values: S / R = lo / R + hi for S = lo + hi 2^(32 W),
    a product by 1 (exact for any lo < R) and a modular add (hi < 2^32 < p)."""
    w = ctx.num_words
    hi = torch.nn.functional.pad(rows[:, w:], (0, w - 1))
    return fb.add(ctx, fb.mont_mul(ctx, rows[:, :w].contiguous(), ctx.one_plain), hi)


def digest_to_mont_plain(ctx: FieldCtx, digest_lanes):
    """(4,) digest lanes -> Montgomery words of from_le_bytes_mod_order: the
    digest's 256 bits (possibly at or above p) times R^2 (the plain product
    takes a left operand below R)."""
    return fb.mont_mul(ctx, lanes_to_limbs(digest_lanes), ctx.r2)


def interp3_plain(ctx: FieldCtx, ys):
    """Canonical (3, W) y-values at t = 0, 1, 2 -> canonical (3, W) coefficients
    [c0, c1, c2] of the unique degree-<=2 interpolant."""
    y0, y1, y2 = ys[0], ys[1], ys[2]
    c2 = fb.mont_mul(ctx, fb.sub(ctx, fb.sub(ctx, fb.add(ctx, y0, y2), y1), y1), _inv2(ctx))
    c1 = fb.sub(ctx, fb.sub(ctx, y1, y0), c2)
    return torch.stack([y0, c1, c2])


def trim_len(coeffs) -> int:
    """Trimmed length (0..3) of canonical (3, W) coefficient rows: the highest
    index with a non-zero row, plus one."""
    nonzero = (coeffs != 0).any(dim=1).tolist()
    return max((i + 1 for i, nz in enumerate(nonzero) if nz), default=0)


def round_step_plain(ctx: FieldCtx, rows, state, tail=None, out=None):
    """One transcript round in plain PyTorch; the arguments and results of
    ``round_step``. The trimmed length is read back to the host (this version
    is the tests' and the on-card checks', not the provers')."""
    _check_round(ctx, rows, state, tail, out)
    canon = canonical_rows_plain(ctx, rows)
    m = SUMCHECK_ROWS
    if rows.shape[0] == GKR_ROWS:
        canon = interp3_plain(ctx, canon)
        m = trim_len(canon)
    if tail is None:  # a steady round: digest || elements into a fresh sponge
        prefix, s = state[:4], torch.zeros(STATE_LANES, dtype=_I64, device=ctx.device)
    else:  # the first round: the host's sponge and its pending tail
        prefix, s = tail, state
    content = torch.cat([prefix, limbs_to_lanes(canon[:m]).reshape(-1)])
    pad = torch.from_numpy(absorb_pad(content.shape[0])).to(ctx.device)
    content = torch.cat([content, pad.new_zeros(pad.shape[0] - content.shape[0])]) ^ pad
    for b in range(pad.shape[0] // RATE_LANES):
        block = content[RATE_LANES * b : RATE_LANES * (b + 1)]
        s = keccak_f_plain(torch.cat([s[:RATE_LANES] ^ block, s[RATE_LANES:]]))
    challenge = digest_to_mont_plain(ctx, s[:4])
    if out is not None:
        out.copy_(canon)
        canon = out
    return canon, s, challenge


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_SIGNATURES = {
    "zk_keccak_f": [_P, _P, ctypes.c_longlong, _P],
    "zk_round_step": [_P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_uint32,
                      _P, _P, _P, _P, _P, _P],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("transcript_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib._zk_typed = True
    return lib


def _check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise on anything the kernels do not take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _check_round(ctx: FieldCtx, rows, state, tail, out) -> None:
    if ctx.num_words != WORDS:
        raise ValueError(f"round_step: the transcript takes a 32-byte field, not {ctx.spec.name}")
    _check_tensor("round_step rows", rows, torch.int32, None, ctx.device)
    if rows.dim() != 2 or rows.shape[0] not in (SUMCHECK_ROWS, GKR_ROWS) \
            or rows.shape[1] != WORDS + 1:
        raise ValueError(f"round_step: expected (2 or 3, {WORDS + 1}) lazy rows, "
                         f"got {tuple(rows.shape)}")
    _check_tensor("round_step state", state, _I64, (STATE_LANES,), ctx.device)
    if tail is not None:
        _check_tensor("round_step tail", tail, _I64, None, ctx.device)
        if tail.dim() != 1 or tail.shape[0] > RATE_LANES - 1:
            raise ValueError(f"round_step: a pending tail is under {RATE_LANES} lanes, "
                             f"got {tuple(tail.shape)}")
    if out is not None:
        _check_tensor("round_step out", out, torch.int32, (rows.shape[0], WORDS), ctx.device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def keccak_f(state):
    """Keccak-f[1600] on each (..., 25) int64 lane state; one thread a state
    on the card."""
    _check_tensor("keccak_f state", state, _I64, None, None)
    if state.dim() < 1 or state.shape[-1] != STATE_LANES or state.numel() == 0:
        raise ValueError(f"keccak_f: expected (..., {STATE_LANES}) lanes, got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return keccak_f_plain(state)
    n = state.numel() // STATE_LANES
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        err = library().zk_keccak_f(state.data_ptr(), out.data_ptr(), n, _stream(state.device))
    fk._raise_on(err, "keccak_f")
    launches["keccak_f"] += 1
    lanes["keccak_f"] += n
    return out


def round_step(ctx: FieldCtx, rows, state, tail=None, out=None):
    """One round of a fused prover's transcript, in one launch on the card.

    ``rows``: (k, W+1) lazy rows of the round's summing kernel, k = 2 (plain
    sumcheck: both half-sums are absorbed) or 3 (GKR: y_0, y_1, y_2, absorbed as
    the trimmed coefficients of their interpolant). ``state``: (25,) lanes;
    with ``tail`` None a steady round, which absorbs digest (``state``'s first
    four lanes) || elements into a fresh sponge; else the first round of a proof
    or phase, which continues the host's sponge ``state`` after its pending
    ``tail`` (at most 16 lanes). ``out``: where the (k, W) canonical rows go
    (say a slot of the proof's rows), or None for a new tensor.

    Returns (canonical rows, new (25,) state, (W,) next challenge in Montgomery
    form: the digest's 256 bits mod p)."""
    _check_round(ctx, rows, state, tail, out)
    if rows.device.type == "cpu":
        return round_step_plain(ctx, rows, state, tail, out)
    lib = library()
    k = rows.shape[0]
    if out is None:
        out = torch.empty((k, WORDS), dtype=torch.int32, device=ctx.device)
    new_state = torch.empty(STATE_LANES, dtype=_I64, device=ctx.device)
    challenge = torch.empty(WORDS, dtype=torch.int32, device=ctx.device)
    prefix, prefix_lanes = (state, 4) if tail is None else (tail, tail.shape[0])
    r2, inv2 = _host_words(ctx.spec)[0]
    with torch.cuda.device(ctx.device):
        err = lib.zk_round_step(
            rows.data_ptr(), k, state.data_ptr(), int(tail is None), prefix.data_ptr(),
            prefix_lanes, ctx.p_words_c, ctx.n0_prime32, r2, inv2, out.data_ptr(),
            new_state.data_ptr(), challenge.data_ptr(), _stream(ctx.device),
        )
    fk._raise_on(err, "round_step")
    launches["round_step"] += 1
    lanes["round_step"] += 1
    kind = (k, prefix_lanes, tail is not None)
    rounds[kind] = rounds.get(kind, 0) + 1
    return out, new_state, challenge
