"""BLS12-381 G1 Jacobian point addition and doubling: CUDA kernel wrappers and
plain versions.

The counterpart of ``zktpu/curve/pallas_point.py``. Two functions, each with a
hand-written CUDA kernel (``csrc/point_kernels.cu``) and, beside it, a plain
PyTorch version built on ``torch_backend`` that computes the same words:

  * ``point_add``    -- complete Jacobian addition (add-2007-bl; infinity,
                        P == Q and P == -Q handled), replaces ``_add_impl``
  * ``point_double`` -- Jacobian doubling (dbl-2009-l), replaces ``_double_impl``;
                        ``times=c`` doubles each lane c times in one launch

A batch of points is a triple ``(X, Y, Z)`` of contiguous ``(..., 12)``
``torch.int32`` tensors of Montgomery words over Fq, all of one shape; the point
at infinity is ``Z == 0``. Any batch of one lane or more is taken as it is: the
TPU kernels' limb-major ``(24, B)`` layout, 512-lane tile and padding with
infinities answer that chip's registers and compiler and have no counterpart.

Both are bound by operations on this card (11 Montgomery products and 5
squarings of 12 words a lane, and 2 and 5, against 432 and 288 bytes); the notes in the CUDA sources
(``point_kernels.cu`` and its arithmetic core ``fq381.cuh``) say what the
kernels do about it.

Dispatch is by where the tensors lie and by nothing else: CPU tensors go to the
plain version, CUDA tensors go to the kernel or the call raises. Kernel and plain
version compute the same field values by the same formulas (the kernel keeps
them in [0, 2p) between operations, the plain version reduced) and both store
the canonical representative, so their words are equal, lanes of no meaning
included (P == -Q leaves arbitrary X3, Y3 beside Z3 == 0).

``launches`` counts, per kernel, the wrapper calls that launched it, ``lanes``
the lanes those launches covered (the sum of the batch widths), and
``doublings`` the lane doublings of ``point_double``'s launches (width x times).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..field import torch_backend as fb
from ..field.spec import BLS12_381_FQ
from ..field.torch_backend import FieldCtx

KERNEL_NAMES = ("point_add", "point_double")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: kernel name -> lanes of those launches
lanes: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: lane doublings of point_double's launches
doublings = 0


def reset_launches() -> None:
    global doublings
    for name in launches:
        launches[name] = 0
        lanes[name] = 0
    doublings = 0


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def _check_times(name: str, times: int) -> None:
    if not isinstance(times, int) or times < 1:
        raise ValueError(f"{name}: times must be an int >= 1, got {times!r}")


def point_double_plain(ctx: FieldCtx, pt, times: int = 1):
    """dbl-2009-l, ``times`` times over; infinity maps to infinity (Z3 = 2YZ)."""
    _check_times("point_double_plain", times)
    for _ in range(times):
        pt = _double_once(ctx, pt)
    return pt


def _double_once(ctx: FieldCtx, pt):
    X, Y, Z = pt
    mul = lambda a, b: fb.mont_mul(ctx, a, b)  # noqa: E731
    add = lambda a, b: fb.add(ctx, a, b)  # noqa: E731
    sub = lambda a, b: fb.sub(ctx, a, b)  # noqa: E731
    dbl = lambda a: fb.add(ctx, a, a)  # noqa: E731

    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    xb = add(X, B)
    D = dbl(sub(sub(mul(xb, xb), A), C))
    E = add(dbl(A), A)
    X3 = sub(mul(E, E), dbl(D))
    Y3 = sub(mul(E, sub(D, X3)), dbl(dbl(dbl(C))))
    Z3 = dbl(mul(Y, Z))
    return (X3, Y3, Z3)


def point_add_plain(ctx: FieldCtx, p1, p2):
    """add-2007-bl with the edges handled by selects: the doubling where P == Q,
    then ``p2`` where ``p1`` is infinite, then ``p1`` where ``p2`` is."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    mul = lambda a, b: fb.mont_mul(ctx, a, b)  # noqa: E731
    add = lambda a, b: fb.add(ctx, a, b)  # noqa: E731
    sub = lambda a, b: fb.sub(ctx, a, b)  # noqa: E731
    dbl = lambda a: fb.add(ctx, a, a)  # noqa: E731

    Z1Z1 = mul(Z1, Z1)
    Z2Z2 = mul(Z2, Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(Y1, mul(Z2, Z2Z2))
    S2 = mul(Y2, mul(Z1, Z1Z1))
    H = sub(U2, U1)
    rr = dbl(sub(S2, S1))
    H2 = dbl(H)
    I = mul(H2, H2)  # noqa: E741
    J = mul(H, I)
    V = mul(U1, I)
    X3 = sub(sub(mul(rr, rr), J), dbl(V))
    Y3 = sub(mul(rr, sub(V, X3)), dbl(mul(S1, J)))
    z12 = add(Z1, Z2)
    Z3 = mul(sub(sub(mul(z12, z12), Z1Z1), Z2Z2), H)

    p1_inf = fb.is_zero(ctx, Z1)
    p2_inf = fb.is_zero(ctx, Z2)
    is_double = ~p1_inf & ~p2_inf & fb.is_zero(ctx, H) & fb.is_zero(ctx, rr)
    # P == -Q (H == 0, rr != 0) already gives Z3 == 0, the infinity encoding

    def sel(mask, a, b):
        return torch.where(mask[..., None], a, b)

    out = (X3, Y3, Z3)
    # the doubling costs 7 products more a lane: the plain version (the CPU's
    # path) pays them only when some lane really doubles; the words are the same
    if bool(is_double.any()):
        out = tuple(sel(is_double, d, a) for d, a in zip(point_double_plain(ctx, p1), out))
    out = tuple(sel(p1_inf, q, o) for q, o in zip(p2, out))
    return tuple(sel(p2_inf, p, o) for p, o in zip(p1, out))


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_SIGNATURES = {
    "zk_point_add": [_P] * 9 + [ctypes.c_longlong, _P, ctypes.c_uint32, _P],
    "zk_point_double": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_uint32, _P],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("point_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib._zk_typed = True
    return lib


def _check_point(ctx: FieldCtx, name: str, pt, shape=None):
    """Raise on anything the kernels do not take; returns the coordinates' shape."""
    if ctx.spec is not BLS12_381_FQ:
        raise ValueError(f"{name}: points live over BLS12-381 Fq, got {ctx.spec.name}")
    if not isinstance(pt, (tuple, list)) or len(pt) != 3:
        raise TypeError(f"{name}: expected an (X, Y, Z) triple")
    for label, t in zip("XYZ", pt):
        what = f"{name} {label}"
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
        if t.device != ctx.device:
            raise ValueError(f"{what}: tensor on {t.device}, context on {ctx.device}")
        if t.dim() < 1 or t.shape[-1] != ctx.num_words:
            raise ValueError(f"{what}: last dimension must be {ctx.num_words} words")
        if shape is None:
            shape = tuple(t.shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
        if t.numel() == 0 or t.numel() // ctx.num_words >= 1 << 31:
            raise ValueError(f"{what}: a batch holds between 1 and 2^31 - 1 points")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor must start on a 16-byte boundary")
    return shape


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def point_add(ctx: FieldCtx, p1, p2):
    """Complete Jacobian addition of two batches of one shape, lane by lane."""
    shape = _check_point(ctx, "point_add p1", p1)
    _check_point(ctx, "point_add p2", p2, shape)
    if p1[0].device.type == "cpu":
        return point_add_plain(ctx, p1, p2)
    lib = library()
    out = tuple(torch.empty_like(t) for t in p1)
    n = p1[0].numel() // ctx.num_words
    with torch.cuda.device(ctx.device):
        err = lib.zk_point_add(
            *(t.data_ptr() for t in p1), *(t.data_ptr() for t in p2),
            *(t.data_ptr() for t in out), n,
            ctx.p_words_c, ctx.n0_prime32, torch.cuda.current_stream(ctx.device).cuda_stream,
        )
    _raise_on(err, "point_add")
    launches["point_add"] += 1
    lanes["point_add"] += n
    return out


def point_double(ctx: FieldCtx, pt, times: int = 1):
    """Jacobian doubling of a batch, lane by lane, ``times`` >= 1 times over:
    one launch whatever ``times`` is."""
    global doublings
    _check_point(ctx, "point_double", pt)
    _check_times("point_double", times)
    if pt[0].device.type == "cpu":
        return point_double_plain(ctx, pt, times)
    lib = library()
    out = tuple(torch.empty_like(t) for t in pt)
    n = pt[0].numel() // ctx.num_words
    with torch.cuda.device(ctx.device):
        err = lib.zk_point_double(
            *(t.data_ptr() for t in pt), *(t.data_ptr() for t in out), n, times,
            ctx.p_words_c, ctx.n0_prime32, torch.cuda.current_stream(ctx.device).cuda_stream,
        )
    _raise_on(err, "point_double")
    launches["point_double"] += 1
    lanes["point_double"] += n
    doublings += n * times
    return out
