"""The tables of a lazy GKR layer: CUDA kernel wrappers and their plain versions.

Before its first sumcheck phase a lazy GKR layer (``gkr/lazy.py``) binds the
gate index to the verifier's challenges, which leaves one wiring coefficient a
gate, and builds the phase-1 stack from them; between its phases it builds the
phase-2 stack from phase 1's challenges. Three hand-written CUDA kernels
(``csrc/gkr_tables_kernels.cu`` on ``csrc/gkr_tables.cuh`` and
``csrc/mont.cuh``) write each of them once, in its final layout, each with a
plain PyTorch version beside it that computes the same words:

  * ``wiring_coefs``  -- coef_g = sum_t s_t eq(r_t, g) over one term (the
                         output layer: no scale) or two (alpha eq(r_b, g) +
                         beta eq(r_c, g)), split by the gate's type into
                         (coef_a, coef_m), the other one zero;
  * ``phase1_stack``  -- the (2, 2, 2n, W) stack [[w, G], [H, 1]],
                         G[2g] = coefA_g + coefM_g w[2g+1],
                         H[2g] = coefA_g w[2g+1], the odd entries zero;
  * ``phase2_stack``  -- [[A2, wb + w], [M2 wb, w]],
                         A2[2g+1] = coefA_g eq(r, 2g), M2 likewise, the even
                         entries zero, r phase 1's challenges.

The plain versions are the port's earlier eager chains: ``eq_tensor`` (two
``mont_mul`` launches and an interleave a challenge), products by 0/1 gate
masks, modular additions, interleaves and stacks.

Dispatch is by where the tensor lies and by nothing else: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel or the call raises. The
kernels take 8-word fields. ``launches`` counts, per kernel, the wrapper calls
that launched it. With ``utils.tracker`` recording, each launch records its
least work (``roofline.GKR_TABLES_COSTS``) as ``gkr_tables``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..utils import roofline, tracker

#: the words of the fields the kernels take
WORDS = 8

KERNEL_NAMES = ("gkr_wiring", "gkr_phase1_stack", "gkr_phase2_stack")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def _interleave(first, second):
    """(n, W), (n, W) -> (2n, W): first at the even rows, second at the odd."""
    return torch.stack([first, second], dim=1).reshape(2 * first.shape[0], first.shape[1])


def eq_tensor(ctx: FieldCtx, values_mont):
    """eq(r, x) table over all 2^k MSB-first hypercube vertices x.

    Chain of kron products of (1 - r_i, r_i); challenge 0 lands on the most
    significant index bit, matching the reference's bit packing
    (gkr_circuit.rs:67-104) and ``generate_bhc`` enumeration (kzg.rs:171-181).
    ``values_mont``: a list of (W,) or a (k, W) tensor of Montgomery words. Each
    doubling is two ``mont_mul`` launches (table x one element) and an
    interleave.
    """
    table = ctx.one_mont[None]
    if len(values_mont) == 0:
        return table
    rs = values_mont if isinstance(values_mont, torch.Tensor) else torch.stack(list(values_mont))
    one_minus = fb.sub(ctx, ctx.one_mont, rs)
    for k in range(rs.shape[0]):
        table = _interleave(
            fk.mont_mul(ctx, table, one_minus[k]), fk.mont_mul(ctx, table, rs[k])
        )
    return table  # (2^k, W) Montgomery


def gate_masks_plain(ctx: FieldCtx, is_add):
    """Montgomery-domain 0/1 masks (n, W) of the add and the mul gates."""
    add_mask = torch.where(is_add[:, None], ctx.one_mont, ctx.zero)
    mul_mask = torch.where(is_add[:, None], ctx.zero, ctx.one_mont)
    return add_mask, mul_mask


def wiring_coefs_plain(ctx: FieldCtx, challenges, scales, is_add, n: int):
    """The arguments and results of ``wiring_coefs``: each term's eq table cut
    to n entries, times its scale, the terms added, then products by the gate
    masks."""
    coef = None
    for t in range(challenges.shape[0]):
        term = eq_tensor(ctx, challenges[t])[:n].contiguous()
        if scales is not None:
            term = fk.mont_mul(ctx, term, scales[t])
        coef = term if coef is None else fb.add(ctx, coef, term)
    add_mask, mul_mask = gate_masks_plain(ctx, is_add)
    return fk.mont_mul(ctx, coef, add_mask), fk.mont_mul(ctx, coef, mul_mask)


def phase1_tables_plain(ctx: FieldCtx, coef_a, coef_m, w_table):
    """Interleaved G/H tables over b from per-gate coefficients: (2, 2n, W)
    [G, H] with G[2g] = coefA_g + coefM_g * w[2g+1], H[2g] = coefA_g * w[2g+1],
    odd entries zero."""
    n = coef_a.shape[0]
    w_odd = w_table.reshape(n, 2, ctx.num_words)[:, 1].contiguous()
    h_even = fk.mont_mul(ctx, coef_a, w_odd)
    g_even = fb.add(ctx, coef_a, fk.mont_mul(ctx, coef_m, w_odd))
    zeros = torch.zeros_like(g_even)
    return torch.stack([_interleave(g_even, zeros), _interleave(h_even, zeros)])


def phase1_stack_plain(ctx: FieldCtx, coef_a, coef_m, w_table):
    """The arguments and results of ``phase1_stack``."""
    gh = phase1_tables_plain(ctx, coef_a, coef_m, w_table)
    ones = ctx.one_mont.expand(w_table.shape)
    return torch.stack([torch.stack([w_table, gh[0]]), torch.stack([gh[1], ones])])


def phase2_tables_plain(ctx: FieldCtx, coef_a, coef_m, w_table, eqb, wb):
    """Phase-2 SumPoly tables over c once b is bound to r_b, from the whole
    eq(r_b, .) table ``eqb``: a contiguous (2, 2, 2n, W) stack in ``gkr_round``
    layout, [[A2, wb + w], [M2 * wb, w]] with A2[2g+1] = coefA_g * eq(r_b, 2g)."""
    n = coef_a.shape[0]
    eqb_even = eqb.reshape(n, 2, ctx.num_words)[:, 0].contiguous()
    a2_odd = fk.mont_mul(ctx, coef_a, eqb_even)
    m2_odd = fk.mont_mul(ctx, fk.mont_mul(ctx, coef_m, eqb_even), wb)
    zeros = torch.zeros_like(a2_odd)
    a2 = _interleave(zeros, a2_odd)
    m2 = _interleave(zeros, m2_odd)
    wb_plus_w = fb.add(ctx, w_table, wb)
    return torch.stack([torch.stack([a2, wb_plus_w]), torch.stack([m2, w_table])])


def phase2_stack_plain(ctx: FieldCtx, coef_a, coef_m, w_table, challenges, wb):
    """The arguments and results of ``phase2_stack``."""
    return phase2_tables_plain(ctx, coef_a, coef_m, w_table, eq_tensor(ctx, challenges), wb)


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "zk_gkr_wiring": [_P, _P, _I, _I, _P, _LL, _P, _P, _P, _U32, _P, _P],
    "zk_gkr_phase1_stack": [_P, _P, _P, _LL, _P, _P, _U32, _P, _P],
    "zk_gkr_phase2_stack": [_P, _P, _P, _P, _P, _LL, _P, _P, _U32, _P, _P],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("gkr_tables_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib._zk_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _one_words(spec):
    """R mod p, 1 in Montgomery form, as ctypes words (passed by value)."""
    return (ctypes.c_uint32 * spec.num_words)(*spec.to_words(spec.R))


def _launch(ctx: FieldCtx, name: str, fn, *args) -> None:
    """Launch ``fn`` on the context's current stream with the field's words."""
    with torch.cuda.device(ctx.device):
        err = fn(*args, ctx.p_words_c, ctx.n0_prime32, _one_words(ctx.spec), fk._stream(ctx))
    fk._raise_on(err, name)


def _count(name: str, *cost_args) -> None:
    launches[name] += 1
    if tracker.recording:
        nbytes, ops = roofline.GKR_TABLES_COSTS[name](*cost_args)
        tracker.work("gkr_tables", nbytes, ops, 0)


def _check_width(ctx: FieldCtx, name: str) -> None:
    if ctx.num_words != WORDS:
        raise ValueError(f"{name}: the kernel takes an 8-word field, not {ctx.spec.name}")


def _check_gates(ctx: FieldCtx, name: str, coef_a, coef_m, w_table) -> int:
    """The gate count n of (n, W) coefficients and a (2n, W) w table, checked."""
    fk._check(ctx, f"{name} coef_a", coef_a)
    n = coef_a.shape[0]
    fk._check(ctx, f"{name} coef_m", coef_m, (n, ctx.num_words))
    fk._check(ctx, f"{name} w_table", w_table, (2 * n, ctx.num_words))
    return n


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def wiring_coefs(ctx: FieldCtx, challenges, scales, is_add, n: int):
    """One layer's wiring coefficients in one launch on the card.

    ``challenges``: (terms, k, W) Montgomery words, one or two terms of k
    challenges each, challenge 0 on the gate index's top bit; ``scales``:
    (terms, W) each term's factor, or None (one); ``is_add``: (n,) bool, the
    gates' types (``Layer.add_mask``); 1 <= n <= 2^k gates.

    Returns (coef_a, coef_m), each (n, W): coef_g = sum_t s_t eq(r_t, g) where
    gate g adds (coef_a) or multiplies (coef_m), zero in the other."""
    fk._check(ctx, "wiring_coefs challenges", challenges)
    if challenges.dim() != 3 or challenges.shape[0] not in (1, 2) or challenges.shape[1] < 1:
        raise ValueError("wiring_coefs: expected (1 or 2 terms, k >= 1, W) challenges, got "
                         f"{tuple(challenges.shape)}")
    terms, k = challenges.shape[:2]
    if scales is not None:
        fk._check(ctx, "wiring_coefs scales", scales, (terms, ctx.num_words))
    if not 1 <= n <= 1 << k:
        raise ValueError(f"wiring_coefs: {n} gates do not fit {k} index bits")
    if is_add.dtype != torch.bool or tuple(is_add.shape) != (n,) or not is_add.is_contiguous():
        raise ValueError(f"wiring_coefs: expected a contiguous ({n},) bool gate mask")
    if is_add.device != ctx.device:
        raise ValueError(f"wiring_coefs: gate mask on {is_add.device}, context on {ctx.device}")
    if challenges.device.type == "cpu":
        return wiring_coefs_plain(ctx, challenges, scales, is_add, n)
    _check_width(ctx, "wiring_coefs")
    lib = library()
    out = torch.empty((2, n, ctx.num_words), dtype=torch.int32, device=ctx.device)
    _launch(ctx, "gkr_wiring", lib.zk_gkr_wiring, challenges.data_ptr(),
            None if scales is None else scales.data_ptr(), terms, k, is_add.data_ptr(), n,
            out[0].data_ptr(), out[1].data_ptr())
    _count("gkr_wiring", n, terms)
    return out[0], out[1]


def phase1_stack(ctx: FieldCtx, coef_a, coef_m, w_table):
    """A layer's phase-1 stack [[w, G], [H, 1]] in one launch on the card.

    ``coef_a``, ``coef_m``: (n, W) wiring coefficients; ``w_table``: (2n, W).
    Returns the contiguous (2, 2, 2n, W) stack, G and H as
    ``phase1_tables_plain``, the [1, 1] table all ones."""
    n = _check_gates(ctx, "phase1_stack", coef_a, coef_m, w_table)
    if coef_a.device.type == "cpu":
        return phase1_stack_plain(ctx, coef_a, coef_m, w_table)
    _check_width(ctx, "phase1_stack")
    lib = library()
    out = torch.empty((2, 2, 2 * n, ctx.num_words), dtype=torch.int32, device=ctx.device)
    _launch(ctx, "gkr_phase1_stack", lib.zk_gkr_phase1_stack, coef_a.data_ptr(),
            coef_m.data_ptr(), w_table.data_ptr(), n, out.data_ptr())
    _count("gkr_phase1_stack", n)
    return out


def phase2_stack(ctx: FieldCtx, coef_a, coef_m, w_table, challenges, wb):
    """A layer's phase-2 stack [[A2, wb + w], [M2 wb, w]] in one launch on the
    card, eq(r, 2g) formed only at the even indices it reads.

    ``coef_a``, ``coef_m``: (n, W), n a power of two; ``w_table``: (2n, W);
    ``challenges``: (log2(2n), W) phase 1's challenges r_b, Montgomery;
    ``wb``: (W,) w(r_b). Returns the contiguous (2, 2, 2n, W) stack of
    ``phase2_tables_plain``."""
    n = _check_gates(ctx, "phase2_stack", coef_a, coef_m, w_table)
    if n & (n - 1):
        raise ValueError(f"phase2_stack: {n} gates is not a power of two")
    fk._check(ctx, "phase2_stack challenges", challenges,
              ((2 * n).bit_length() - 1, ctx.num_words))
    fk._check(ctx, "phase2_stack wb", wb, (ctx.num_words,))
    if coef_a.device.type == "cpu":
        return phase2_stack_plain(ctx, coef_a, coef_m, w_table, challenges, wb)
    _check_width(ctx, "phase2_stack")
    lib = library()
    out = torch.empty((2, 2, 2 * n, ctx.num_words), dtype=torch.int32, device=ctx.device)
    _launch(ctx, "gkr_phase2_stack", lib.zk_gkr_phase2_stack, challenges.data_ptr(),
            coef_a.data_ptr(), coef_m.data_ptr(), w_table.data_ptr(), wb.data_ptr(), n,
            out.data_ptr())
    _count("gkr_phase2_stack", n)
    return out
