"""A host C++ field oracle, independent of every Montgomery kernel it checks.

This package's own copy of the JAX package's ``oracle``: plain-bigint C++
(``_oracle.cpp``: schoolbook products, shift-subtract reduction) that shares no
code with the CUDA kernels of ``csrc/`` or their plain PyTorch versions, so two
implementations that agree on random inputs check each other.

``_build.py`` compiles it with ``g++`` into ``zktpu_torch/_build/`` at first use,
under a name that carries a hash of the source. A failed build raises
``_build.CompileError``; nothing falls back to Python integers.

All values are canonical Python ints; a field is given by its modulus. The C
calls release the interpreter lock, so threads may call them side by side.
"""

from __future__ import annotations

import ctypes
import os
import threading

from .. import _build

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_oracle.cpp")
_FLAGS = ["-O2"]
_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.host_library_path("zkoracle", _SOURCE, _FLAGS, "g++"))
            u64p = ctypes.POINTER(ctypes.c_uint64)
            cint = ctypes.c_int
            for name in ("f_add", "f_sub", "f_mul", "f_pow"):
                getattr(lib, name).argtypes = [u64p, u64p, u64p, cint, u64p]
            lib.f_sum.argtypes = [u64p, ctypes.c_size_t, u64p, cint, u64p]
            lib.f_fold.argtypes = [u64p, ctypes.c_size_t, u64p, u64p, cint, u64p]
            for name in ("f_add", "f_sub", "f_mul", "f_pow", "f_sum", "f_fold"):
                getattr(lib, name).restype = None
            _lib = lib
        return _lib


def _words(p: int) -> int:
    return (p.bit_length() + 63) // 64


def _enc(value: int, w: int):
    return (ctypes.c_uint64 * w)(*[(value >> (64 * i)) & ((1 << 64) - 1) for i in range(w)])


def _enc_vec(values, w: int):
    n = len(values)
    arr = (ctypes.c_uint64 * (w * n))()
    for k, v in enumerate(values):
        for i in range(w):
            arr[w * k + i] = (v >> (64 * i)) & ((1 << 64) - 1)
    return arr


def _dec(arr, w: int) -> int:
    return sum(int(arr[i]) << (64 * i) for i in range(w))


def _binop(name: str, a: int, b: int, p: int) -> int:
    w = _words(p)
    out = (ctypes.c_uint64 * w)()
    getattr(_load(), name)(_enc(a % p, w), _enc(b % p, w), _enc(p, w), w, out)
    return _dec(out, w)


def add(a: int, b: int, p: int) -> int:
    return _binop("f_add", a, b, p)


def sub(a: int, b: int, p: int) -> int:
    return _binop("f_sub", a, b, p)


def mul(a: int, b: int, p: int) -> int:
    return _binop("f_mul", a, b, p)


def pow_(a: int, e: int, p: int) -> int:
    """a^e mod p for 0 <= e < 2^(64 w), w the modulus's 64-bit words."""
    w = _words(p)
    if not 0 <= e < 1 << (64 * w):
        raise ValueError(f"exponent out of range for a {w}-word modulus")
    out = (ctypes.c_uint64 * w)()
    _load().f_pow(_enc(a % p, w), _enc(e, w), _enc(p, w), w, out)
    return _dec(out, w)


def inverse(a: int, p: int) -> int:
    """a^(p-2) mod p: 0 for a = 0."""
    return pow_(a, p - 2, p)


def vec_sum(values, p: int) -> int:
    w = _words(p)
    out = (ctypes.c_uint64 * w)()
    vec = _enc_vec([v % p for v in values], w)
    _load().f_sum(vec, len(values), _enc(p, w), w, out)
    return _dec(out, w)


def sumcheck_fold(values, r: int, p: int) -> list[int]:
    """The fold a + r*(b - a) over the table's halves (partial_evaluate)."""
    w = _words(p)
    n = len(values)
    vec = _enc_vec([v % p for v in values], w)
    out = (ctypes.c_uint64 * (w * (n // 2)))()
    _load().f_fold(vec, n, _enc(r % p, w), _enc(p, w), w, out)
    return [sum(int(out[w * k + i]) << (64 * i) for i in range(w)) for k in range(n // 2)]
