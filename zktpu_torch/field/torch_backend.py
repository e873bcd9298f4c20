"""Plain PyTorch field arithmetic over packed 32-bit-word tensors.

The counterpart of ``zktpu/field/jnp_backend.py``: every function here runs on
any device and is the reference that the CUDA kernels are held against, but
``mont_sqr``, ``pow_static`` and ``inverse``, whose products go through
``kernels.mont_mul`` (the kernel on a card tensor).

Representation
--------------
A batch of field elements is a ``torch.int32`` tensor of shape ``(..., W)`` with
``W = spec.num_words``: little-endian 32-bit words, stored as the bit pattern of
uint32. That is the same integer as the JAX package's ``2W`` 16-bit digits, and
the Montgomery radix ``R = 2^(32 W)`` is the same number, so Montgomery-domain
values agree with the JAX package bit for bit (``convert.py`` maps the layouts).

Arithmetic
----------
PyTorch has no unsigned 32-bit arithmetic and no 32x32->64 product, so the plain
versions widen on entry: each word is split into two 16-bit digits held in int64
lanes, the arithmetic is schoolbook on digits (a digit product is below 2^32 and
int64 lanes have room for every delayed carry), and the result is narrowed back
to words on exit. Carries are propagated by one signed ripple over the digit
axis (an arithmetic right shift is a floor division, so the same pass serves
additions and subtractions).

Operands need not be reduced: ``mont_mul(a, b)`` is exact for any ``a < R`` with
``b < p`` (the CIOS sum stays below ``2p``, one conditional subtraction
finishes), which the fused prover uses for raw digests and lazy sums.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sysconfig

import numpy as np
import torch

from .. import _build
from ..utils import tracker
from .spec import LIMB_BITS, LIMB_MASK, FieldSpec

_I64 = torch.int64


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor (same bits) on ``device``."""
    arr = np.ascontiguousarray(words, dtype="<u4").view(np.int32)
    return torch.from_numpy(arr).to(device)


_PACK_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_pack.c")
_PACK_FLAGS = ["-O2", "-I", sysconfig.get_paths()["include"]]


@functools.lru_cache(maxsize=None)
def _pack_small():
    """The C packer ``_pack.c:pack_small``, built at first use; None where it
    cannot be built or loaded. Loaded with ``PyDLL``: it reads Python objects,
    so it keeps the interpreter lock."""
    try:
        lib = ctypes.PyDLL(_build.host_library_path("zkpack", _PACK_SOURCE, _PACK_FLAGS))
    except (_build.CompileError, OSError):
        return None
    fn = lib.pack_small
    fn.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_ssize_t]
    fn.restype = ctypes.c_ssize_t
    return fn


def tensor_to_words(t) -> np.ndarray:
    """int32 tensor (or array) -> numpy uint32 words (same bits) on the host.
    A tensor is read back here (``tracker.fetch``): on a card a copy that
    waits for the queue to drain, on the CPU the same point of the path."""
    if isinstance(t, torch.Tensor):
        if tracker.recording:
            tracker.fetch("tensor_to_words", t.numel() * t.element_size())
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t).astype(np.int32, copy=False).view(np.uint32)


class FieldCtx:
    """Per-(field, device) constants and host packing helpers.

    Constants are int32 word tensors on ``device`` (``p``, ``r2``, ``one_plain``,
    ``one_mont``, ``zero``); ``p_digits`` is the int64 digit form used by the
    plain arithmetic. ``p_words_c`` (a ctypes array of the modulus words) and
    ``n0_prime32`` are what the kernel launchers pass by value.
    """

    def __init__(self, spec: FieldSpec, device: torch.device):
        self.spec = spec
        self.device = device
        self.num_limbs = spec.num_limbs
        self.num_words = spec.num_words
        p = spec.modulus
        # raw split -- spec.to_words reduces mod p (would give 0)
        self.p_words_host = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(self.num_words)]
        self.p_words_c = (ctypes.c_uint32 * self.num_words)(*self.p_words_host)
        self.n0_prime32 = spec.n0_prime32
        self.p = self._const(self.p_words_host)
        self.r2 = self._const(spec.to_words(spec.R2))
        self.one_plain = self._const(spec.to_words(1))
        self.one_mont = self._const(spec.to_words(spec.R))
        self.zero = self._const([0] * self.num_words)
        self.p_digits = _to_digits(self.p)
        # every int in [0, 2^64) is then canonical, as ``pack_small`` needs
        self._small_is_canonical = p > 1 << 64

    def _const(self, words) -> torch.Tensor:
        return words_to_tensor(np.asarray(words, dtype=np.uint32), self.device)

    # -- host packing helpers ------------------------------------------------

    def pack(self, values) -> np.ndarray:
        """Python ints (nested lists ok) -> canonical uint32 word array on the
        host, values reduced mod p.

        A flat list or tuple of ints in [0, 2^64) goes through the C packer in
        one pass (``field.pack_fast``). Anything else, and any such list the
        packer declines an item of, takes the exact route from the start
        (``field.pack_exact``): if every value fits in uint64 the split is
        numpy; otherwise each value is reduced and serialized to bytes."""
        w = self.num_words
        if self._small_is_canonical and isinstance(values, (list, tuple)):
            fn = _pack_small()
            if fn is not None:
                n = len(values)
                arr = np.empty((n, w), dtype=np.uint32)
                if fn(values, arr.ctypes.data, n, w) < 0:
                    tracker.count("field.pack_fast", n)
                    return arr
        shape = np.shape(values) + (w,)
        flat = np.asarray(values, dtype=object).reshape(-1)
        tracker.count("field.pack_exact", flat.size)
        try:
            small = flat.astype(np.uint64)
            if flat.size and (small.astype(object) != flat).any():
                raise OverflowError
            arr = np.zeros((flat.size, w), dtype=np.uint32)
            arr[:, 0] = (small & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            arr[:, 1] = (small >> np.uint64(32)).astype(np.uint32)
            return arr.reshape(shape)
        except (OverflowError, TypeError, ValueError):
            pass
        p = self.spec.modulus
        blob = b"".join((int(v) % p).to_bytes(4 * w, "little") for v in flat)
        return np.frombuffer(blob, dtype="<u4").astype(np.uint32).reshape(shape)

    def unpack(self, words) -> np.ndarray:
        """Word array or tensor (..., W) -> object array of Python ints."""
        arr = tensor_to_words(words)
        flat = arr.reshape(-1, self.num_words).astype("<u4")
        blob = flat.tobytes()
        nbytes = 4 * self.num_words
        out = np.empty(flat.shape[0], dtype=object)
        for k in range(flat.shape[0]):
            out[k] = int.from_bytes(blob[k * nbytes : (k + 1) * nbytes], "little")
        return out.reshape(arr.shape[:-1])

    def to_device(self, words: np.ndarray) -> torch.Tensor:
        """Host uint32 words -> int32 tensor on this context's device."""
        return words_to_tensor(words, self.device)

    def canonical_to_bytes(self, words) -> bytes:
        """Canonical word array (..., W) -> concatenated arkworks
        ``to_bytes_le`` serialization (4 bytes per word, element-major)."""
        arr = tensor_to_words(words)
        if arr.shape[-1] != self.num_words or 4 * self.num_words != self.spec.byte_len:
            raise ValueError("table width does not match the field's byte length")
        return arr.astype("<u4").tobytes()

    def bytes_to_canonical(self, data: bytes) -> np.ndarray:
        arr = np.frombuffer(data, dtype="<u4").astype(np.uint32)
        return arr.reshape(-1, self.num_words)


@functools.lru_cache(maxsize=None)
def _cached_ctx(spec: FieldSpec, device: torch.device) -> FieldCtx:
    return FieldCtx(spec, device)


def get_ctx(spec: FieldSpec, device=None) -> FieldCtx:
    """The context of ``spec`` on ``device`` (cached per pair).

    ``device=None`` means the current CUDA device. Where there is no card this
    raises; it never carries on on the CPU. Pass ``device="cpu"`` to ask for the
    CPU, as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "zktpu_torch runs on a CUDA device and none is available; "
                'pass device="cpu" to run the plain PyTorch path on the CPU'
            )
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _cached_ctx(spec, device)


# ----------------------------------------------------------------------
# words <-> digits, carry machinery (int64 lanes, digits along the last axis)
# ----------------------------------------------------------------------

def _to_digits(words: torch.Tensor) -> torch.Tensor:
    """int32 words (..., W) -> int64 16-bit digits (..., 2W)."""
    w = words.to(_I64)
    lo = w & LIMB_MASK
    hi = (w >> LIMB_BITS) & LIMB_MASK
    return torch.stack([lo, hi], dim=-1).reshape(words.shape[:-1] + (-1,))


def _to_words(digits: torch.Tensor) -> torch.Tensor:
    """Clean int64 digits (..., 2W) -> int32 words (..., W)."""
    pairs = digits.reshape(digits.shape[:-1] + (-1, 2))
    w = pairs[..., 0] | (pairs[..., 1] << LIMB_BITS)
    # [0, 2^32) -> the int32 with the same bits
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def _carry(x: torch.Tensor):
    """Propagate signed carries along the digit axis.

    Returns ``(digits, carry_out)``: clean digits in [0, 2^16) and the signed
    carry out of the top lane (negative: the value was negative, i.e. a borrow).
    """
    out = []
    c = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        v = x[..., k] + c
        out.append(v & LIMB_MASK)
        c = v >> LIMB_BITS
    return torch.stack(out, dim=-1), c


def _cond_sub_p(ctx: FieldCtx, t: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """Reduce clean digits ``t`` (< 2p; ``extra`` = the overflow bit 2^(16N))
    to [0, p)."""
    diff, borrow = _carry(t - ctx.p_digits)
    take_diff = extra | (borrow == 0)
    return torch.where(take_diff[..., None], diff, t)


def _add_digits(ctx: FieldCtx, a, b):
    s, c = _carry(a + b)
    return _cond_sub_p(ctx, s, c > 0)


def _sub_digits(ctx: FieldCtx, a, b):
    diff, borrow = _carry(a - b)
    fixed, _ = _carry(diff + ctx.p_digits)  # mod 2^(16N): the wraparounds cancel
    return torch.where((borrow < 0)[..., None], fixed, diff)


def _mont_mul_digits(ctx: FieldCtx, a, b):
    """Delayed-carry CIOS on int64 digit lanes (a, b broadcastable).

    Each of the N iterations adds two digit products (< 2^32 each) to a lane, so
    lanes stay below N * 2^33 + carries: far inside int64.
    """
    n = ctx.num_limbs
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(shape + (n,))
    b = b.expand(shape + (n,))
    n0p = ctx.spec.n0_prime
    p_digits = ctx.p_digits
    zero_lane = torch.zeros(shape + (1,), dtype=_I64, device=a.device)
    t = torch.zeros(shape + (n + 1,), dtype=_I64, device=a.device)
    for i in range(n):
        low = t[..., :n] + a[..., i : i + 1] * b
        m = ((low[..., 0] & LIMB_MASK) * n0p) & LIMB_MASK
        low = low + m[..., None] * p_digits
        # divide by 2^16: lane 0 is now 0 mod 2^16; push its carry into lane 1
        carry0 = low[..., 0:1] >> LIMB_BITS
        t = torch.cat([low[..., 1:2] + carry0, low[..., 2:], t[..., n:], zero_lane], dim=-1)
    t, _ = _carry(t)
    return _cond_sub_p(ctx, t[..., :n], t[..., n] > 0)


# ----------------------------------------------------------------------
# public ops (int32 (..., W) tensors; Montgomery domain unless noted)
# ----------------------------------------------------------------------

def add(ctx: FieldCtx, a, b):
    """Modular addition (domain-agnostic)."""
    return _to_words(_add_digits(ctx, _to_digits(a), _to_digits(b)))


def sub(ctx: FieldCtx, a, b):
    return _to_words(_sub_digits(ctx, _to_digits(a), _to_digits(b)))


def neg(ctx: FieldCtx, a):
    ad = _to_digits(a)
    diff, _ = _carry(ctx.p_digits - ad)
    is_zero_mask = (ad == 0).all(dim=-1)
    return _to_words(torch.where(is_zero_mask[..., None], ad, diff))


def mont_mul(ctx: FieldCtx, a, b):
    """CIOS Montgomery multiplication: a*b*R^{-1} mod p."""
    return _to_words(_mont_mul_digits(ctx, _to_digits(a), _to_digits(b)))


def to_mont(ctx: FieldCtx, a):
    return mont_mul(ctx, a, ctx.r2)


def from_mont(ctx: FieldCtx, a):
    return mont_mul(ctx, a, ctx.one_plain)


def mont_sqr(ctx: FieldCtx, a):
    """a*a*R^{-1} mod p, through ``kernels.mont_mul`` (the kernel on a card
    tensor)."""
    # kernels imports this module, so it is imported here, at the call
    from . import kernels

    return kernels.mont_mul(ctx, a, a)


def pow_static(ctx: FieldCtx, a, exponent: int):
    """a^exponent (Montgomery in and out) for an exponent known on the host,
    over (..., W) tensors of any leading shape.

    A left-to-right binary ladder: a square every bit below the top one, a
    product by ``a`` at each 1-bit, each a ``kernels.mont_mul`` call (one
    launch on the card): (bits - 1) + (ones - 1) launches. The values are the
    JAX package's ``where`` ladder's; ``exponent == 0`` gives one, 0^e gives 0.
    """
    if exponent < 0:
        raise ValueError("pow_static: the exponent must not be negative")
    if exponent == 0:
        return ctx.one_mont.expand(a.shape).clone()
    from . import kernels  # see mont_sqr

    a = a.contiguous()
    if exponent == 1:
        return a.clone()
    acc = a
    for bit in bin(exponent)[3:]:
        acc = kernels.mont_mul(ctx, acc, acc)
        if bit == "1":
            acc = kernels.mont_mul(ctx, acc, a)
    return acc


def inverse(ctx: FieldCtx, a):
    """Fermat inverse a^(p-2) (Montgomery in and out); inverse(0) is 0, as in
    the JAX package."""
    return pow_static(ctx, a, ctx.spec.modulus - 2)


def lerp(ctx: FieldCtx, a, b, r):
    """``a + r * (b - a)``: the fold of one variable, on word tensors."""
    ad, bd = _to_digits(a), _to_digits(b)
    prod = _mont_mul_digits(ctx, _to_digits(r), _sub_digits(ctx, bd, ad))
    return _to_words(_add_digits(ctx, ad, prod))


def field_sum(ctx: FieldCtx, x, axis: int = 0):
    """Modular sum along ``axis`` via a log-depth pairwise modular tree."""
    d = torch.movedim(_to_digits(x), axis, 0)
    n = d.shape[0]
    while n > 1:
        half = n // 2
        red = _add_digits(ctx, d[:half], d[half : 2 * half])
        if n % 2:
            red = torch.cat([red, d[2 * half :]], dim=0)
        d = red
        n = d.shape[0]
    return _to_words(d[0])


def is_zero(ctx: FieldCtx, a):
    return (a == 0).all(dim=-1)


def eq(ctx: FieldCtx, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return (a == b).all(dim=-1)
