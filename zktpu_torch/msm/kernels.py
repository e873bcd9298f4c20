"""Pippenger's compaction round and window combine: CUDA kernel wrappers and
their plain versions.

zktpu compiles two steps of its Pippenger MSM (``zktpu/msm/pippenger.py``) into
one XLA program each, around its Pallas point kernels: the compaction round
``_compact_round`` (:154, jitted at :289, with ``_max_run`` at :295) and the
window combine ``_horner_multi`` (:448, jitted at :466). Here they are three
hand-written CUDA kernels (``csrc/msm_kernels.cu``, on ``csrc/compact.cuh``,
``csrc/fq381.cuh`` and ``csrc/coop381.cuh``), each with a plain PyTorch version
beside it that computes the same words:

  * ``run_scan``    -- over sorted int32 keys: each key's rank in its run of
                       equal keys, the positions of the survivors of a round
                       (survivor j is the (j + 1)-th rank-even key), their count
                       and the longest run;
  * ``compact_add`` -- the round itself: each survivor's point plus its right
                       neighbour's where the keys match, read where they lie,
                       under ``l_next`` slots padded with infinity and
                       ``MAXKEY``; a block sorts a tile of slots into copies,
                       pads and additions and runs each kind densely;
  * ``horner``      -- acc = ((R_{W-1} 2^c + R_{W-2}) 2^c + ...) over each
                       segment's per-window sums; ``horner_groups`` takes
                       several tables, each with its own c, in one launch (a
                       proof's quotient commitments), a chain a block of 8
                       cooperating lanes.

``fq_mul_coop`` is the cooperative lanes' Montgomery product on its own, a
check of their arithmetic on the card (no path runs it).

``run_scan`` and ``compact_add`` leave the survivor count on the device: a
round needs no read-back. ``run_scan`` is one pass over the keys with a
decoupled look-back, its tiles' state kept in a scratch buffer for each
device and stream that every launch leaves zero. The plain versions are the port's earlier eager code:
a ``cummax``, a ``cumsum`` and a ``searchsorted`` for the scan; gathers, a point
addition at full width and two selects for the round; a doubling of c and an
addition a window for the combine, all in plain PyTorch (``point_add_plain``,
``point_double_plain``).

Keys are contiguous int32 vectors; points are ``(X, Y, Z)`` triples of
contiguous int32 ``(..., 12)`` Montgomery word tensors over BLS12-381 Fq,
infinity ``Z == 0``. Dispatch is by where the tensors lie and by nothing else:
CPU tensors go to the plain version, CUDA tensors go to the kernel or the call
raises.

``launches`` counts, per kernel, the wrapper calls that launched it, and
``lanes`` the keys (``run_scan``), slots (``compact_add``) or segments
(``horner``: chains) they covered; ``scan_slots`` sums ``run_scan``'s
``l_next``, and ``chains`` splits ``horner``'s segments by (windows, c), what a
chain's cost depends on. With ``utils.tracker`` recording, each wrapper call,
on the CPU too, records its least work (``utils.roofline``): ``run_scan`` its
keys and slots, ``compact_add`` its slots each a survivor with no addition
priced (which slots add is known only on the card), ``horner`` its chains with
the longest one's one-thread time as a floor.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..curve import device as dc
from ..curve import point_kernels as pk
from ..field import torch_backend as fb
from ..utils import roofline, tracker

#: the key of a padding slot: above every (window, bucket) key of a group
MAXKEY = 2**30

KERNEL_NAMES = ("run_scan", "compact_add", "horner")
#: kernel name -> launches made by its wrapper since the last reset
launches: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: kernel name -> keys, slots or segments of those launches
lanes: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
#: the survivor slots (l_next) of run_scan's launches
scan_slots = 0
#: (windows, c) -> segments of horner's launches
chains: dict[tuple[int, int], int] = {}


def reset_launches() -> None:
    global scan_slots
    for name in launches:
        launches[name] = 0
        lanes[name] = 0
    scan_slots = 0
    chains.clear()


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------

def _check_vector(name: str, t, device=None, length=None) -> int:
    """A contiguous int32 vector of 1 to 2^31 - 1 entries; returns its length."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a vector, got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if not 1 <= t.shape[0] < 1 << 31:
        raise ValueError(f"{name}: a vector holds between 1 and 2^31 - 1 entries")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name}: expected {length} entries, got {t.shape[0]}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    return t.shape[0]


def _check_l_next(l_next) -> None:
    if not isinstance(l_next, int) or not 1 <= l_next < 1 << 31:
        raise ValueError(f"run_scan: l_next must be an int in [1, 2^31), got {l_next!r}")


def _check_round(key, pt, srcpos, count):
    n = _check_vector("compact_add key", key)
    fq = dc.fq_ctx(key.device)
    pk._check_point(fq, "compact_add pt", pt, (n, fq.num_words))
    l_next = _check_vector("compact_add srcpos", srcpos, key.device)
    _check_vector("compact_add count", count, key.device, 1)
    return fq, n, l_next


def _check_windows(per_window, c, device=None):
    if (not isinstance(per_window, (tuple, list)) or len(per_window) != 3
            or not isinstance(per_window[0], torch.Tensor)):
        raise TypeError("horner: expected an (X, Y, Z) triple of tensors")
    if device is not None and per_window[0].device != device:
        raise ValueError(f"horner: tables on {per_window[0].device} and {device}")
    fq = dc.fq_ctx(per_window[0].device)
    shape = pk._check_point(fq, "horner per_window", per_window)
    if len(shape) != 3:
        raise ValueError(f"horner: expected (segments, windows, 12) tables, got {shape}")
    if not isinstance(c, int) or isinstance(c, bool) or c < 1:
        raise ValueError(f"horner: c must be an int >= 1, got {c!r}")
    return fq, shape[0], shape[1]


def _check_groups(groups):
    """A non-empty list of (per_window, c) on one device; returns their shapes
    as (segments, windows, c)."""
    if not isinstance(groups, (tuple, list)) or not groups:
        raise TypeError("horner_groups: expected a non-empty list of (per_window, c)")
    shapes, device = [], None
    for group in groups:
        if not isinstance(group, (tuple, list)) or len(group) != 2:
            raise TypeError("horner_groups: each group is a (per_window, c) pair")
        _, segments, windows = _check_windows(group[0], group[1], device)
        device = group[0][0].device
        shapes.append((segments, windows, group[1]))
    return shapes


# ----------------------------------------------------------------------
# plain PyTorch versions (any device; the CPU tests and the on-card checks)
# ----------------------------------------------------------------------

def _run_rank(key):
    """Position of every element inside its run of equal keys (sorted keys)."""
    L = key.shape[0]
    pos = torch.arange(L, dtype=torch.int64, device=key.device)
    head = torch.ones(L, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    run_start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), dim=0).values
    return pos - run_start


def run_scan_plain(key, l_next: int):
    """Sorted (L,) int32 keys -> (srcpos, count, longest): srcpos (l_next,)
    int32, survivor j's position (the (j + 1)-th rank-even key) and L - 1 past
    the survivors; count (1,) int32, the rank-even keys; longest (1,) int32,
    the longest run of equal keys."""
    n = _check_vector("run_scan key", key)
    _check_l_next(l_next)
    rank = _run_rank(key)
    is_left = (rank & 1) == 0
    # survivor j (0-based) lives at the position of the (j+1)-th is_left
    csum = torch.cumsum(is_left, dim=0)
    wanted = torch.arange(1, l_next + 1, dtype=torch.int64, device=key.device)
    srcpos = torch.searchsorted(csum, wanted).clamp_(max=n - 1)
    return (srcpos.to(torch.int32), csum[-1:].to(torch.int32),
            (rank.max() + 1).reshape(1).to(torch.int32))


def compact_add_plain(key, pt, srcpos, count):
    """One compaction round from ``run_scan``'s survivors: slot j < count holds
    the point at srcpos[j] plus its right neighbour's where their keys match,
    else the point, under its key; the other slots infinity under MAXKEY.
    Returns (new key (l_next,), Jacobian (l_next, 12) triple)."""
    fq, n, l_next = _check_round(key, pt, srcpos, count)
    srcpos = srcpos.to(torch.int64)
    next_same = torch.zeros(n, dtype=torch.bool, device=key.device)
    next_same[:-1] = key[1:] == key[:-1]
    valid = torch.arange(l_next, device=key.device) < count.to(torch.int64)

    left = dc.gather_pt(pt, srcpos)
    right = dc.gather_pt(pt, (srcpos + 1).clamp_(max=n - 1))
    merged = pk.point_add_plain(fq, left, right)
    out = dc.where_pt(next_same[srcpos] & valid, merged, left)
    out = dc.where_pt(valid, out, dc.infinity_like((l_next,), key.device))
    new_key = torch.where(valid, key[srcpos], torch.full_like(key[:1], MAXKEY))
    return new_key, out


def horner_plain(per_window, c: int):
    """Window combine over (S, W, 12) per-segment tables -> (S, 12):
    acc = ((R_{W-1} * 2^c + R_{W-2}) * 2^c + ...), c doublings and an addition
    a window."""
    fq, _, num_windows = _check_windows(per_window, c)
    acc = tuple(v[:, num_windows - 1].contiguous() for v in per_window)
    for w in range(num_windows - 2, -1, -1):
        acc = pk.point_double_plain(fq, acc, times=c)
        acc = pk.point_add_plain(fq, acc, tuple(v[:, w].contiguous() for v in per_window))
    return acc


def horner_groups_plain(groups):
    """``horner_plain`` of each (per_window, c) group: a list of (S_g, 12)
    triples. Groups of one shape (windows and c) share one chain, their
    segments side by side (a chain of eager calls costs the same at any
    width)."""
    shapes = _check_groups(groups)
    kinds: dict[tuple[int, int], list[int]] = {}
    for g, (_, windows, c) in enumerate(shapes):
        kinds.setdefault((windows, c), []).append(g)
    out = [None] * len(groups)
    for (_, c), members in kinds.items():
        acc = horner_plain(tuple(torch.cat([groups[g][0][i] for g in members])
                                 for i in range(3)), c)
        parts = [torch.split(v, [shapes[g][0] for g in members]) for v in acc]
        for k, g in enumerate(members):
            out[g] = tuple(p[k] for p in parts)
    return out


def chain_table(groups):
    """The groups' window sums as one (rows, 12) table triple, and the chains
    of the ``horner`` kernel: an int32 (chains, 3) table of each segment's first
    row, windows and c, group after group."""
    shapes = _check_groups(groups)
    table = tuple(torch.cat([g[0][i].reshape(-1, g[0][i].shape[-1]) for g in groups])
                  .contiguous() for i in range(3))
    if table[0].shape[0] >= 1 << 31:
        raise ValueError("horner_groups: 2^31 window rows or more")
    chains, row = [], 0
    for segments, windows, c in shapes:
        chains += [(row + s * windows, windows, c) for s in range(segments)]
        row += segments * windows
    return table, torch.tensor(chains, dtype=torch.int32)


def _check_factors(a, b):
    fq = dc.fq_ctx(a.device)
    shape = pk._check_point(fq, "fq_mul_coop", (a, b, b))
    if len(shape) != 2:
        raise ValueError(f"fq_mul_coop: expected (n, 12) tables, got {shape}")
    return fq, shape[0]


def fq_mul_coop_plain(a, b):
    """Canonical a b / R over BLS12-381 Fq, (n, 12) Montgomery word tables."""
    fq, _ = _check_factors(a, b)
    return fb.mont_mul(fq, a, b)


# ----------------------------------------------------------------------
# the kernel library
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "zk_run_scan": [_P, _LL, _P, _P, _LL, _P, _P, _P],
    "zk_compact_add": [_P, _P, _P, _P, _LL, _P, _P, _LL, ctypes.c_int, _P, _P, _P, _P, _P,
                       ctypes.c_uint32, _P],
    "zk_horner": [_P, _P, _P, _LL, _P, _LL, _P, _P, _P, _P, ctypes.c_uint32, _P],
    "zk_fq_mul_coop": [_P, _P, _P, _LL, _P, ctypes.c_uint32, _P],
}


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels; a failed build raises."""
    lib = _build.cuda_library("msm_kernels")
    if getattr(lib, "_zk_typed", False):
        return lib
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.zk_run_scan_scratch_words.argtypes = [_LL]
    lib.zk_run_scan_scratch_words.restype = _LL
    lib._zk_typed = True
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

#: (device, stream) -> run_scan's scratch: its tiles' state, zero between
#: launches (each launch leaves it zero), grown as larger key sets come
_scan_scratch: dict[tuple[torch.device, int], torch.Tensor] = {}


def _scan_state(lib, n: int, device) -> torch.Tensor:
    """The zeroed scratch of a run_scan over n keys on the current stream."""
    key = (device, _stream(device))
    words = lib.zk_run_scan_scratch_words(n)
    scratch = _scan_scratch.get(key)
    if scratch is None or scratch.shape[0] < words:
        scratch = torch.zeros(words, dtype=torch.int32, device=device)
        _scan_scratch[key] = scratch
    return scratch


def run_scan(key, l_next: int):
    """``run_scan_plain``'s results for sorted int32 keys; on the card the count
    and the longest run stay there (one pass over the keys with a look-back
    and a fill of the slots past the count: two device kernels, no
    read-back)."""
    global scan_slots
    n = _check_vector("run_scan key", key)
    _check_l_next(l_next)
    if tracker.recording:
        tracker.work("run_scan", *roofline.run_scan_cost(n, l_next))
    if key.device.type == "cpu":
        return run_scan_plain(key, l_next)
    lib = library()
    srcpos = torch.empty(l_next, dtype=torch.int32, device=key.device)
    count = torch.empty(1, dtype=torch.int32, device=key.device)
    longest = torch.empty(1, dtype=torch.int32, device=key.device)
    with torch.cuda.device(key.device):
        scratch = _scan_state(lib, n, key.device)
        err = lib.zk_run_scan(key.data_ptr(), n, scratch.data_ptr(), srcpos.data_ptr(), l_next,
                              count.data_ptr(), longest.data_ptr(), _stream(key.device))
    _raise_on(err, "run_scan")
    launches["run_scan"] += 1
    lanes["run_scan"] += n
    scan_slots += l_next
    return srcpos, count, longest


def compact_add(key, pt, srcpos, count):
    """``compact_add_plain``'s round; on the card one launch, a block a tile of
    slots, the count read there."""
    fq, n, l_next = _check_round(key, pt, srcpos, count)
    if tracker.recording:
        tracker.work("compact_add", *roofline.compact_add_cost(l_next, l_next, 0))
    if key.device.type == "cpu":
        return compact_add_plain(key, pt, srcpos, count)
    lib = library()
    new_key = torch.empty(l_next, dtype=torch.int32, device=key.device)
    out = tuple(torch.empty((l_next, fq.num_words), dtype=torch.int32, device=key.device)
                for _ in range(3))
    with torch.cuda.device(key.device):
        err = lib.zk_compact_add(
            key.data_ptr(), *(t.data_ptr() for t in pt), n, srcpos.data_ptr(), count.data_ptr(),
            l_next, MAXKEY, new_key.data_ptr(), *(t.data_ptr() for t in out),
            fq.p_words_c, fq.n0_prime32, _stream(key.device),
        )
    _raise_on(err, "compact_add")
    launches["compact_add"] += 1
    lanes["compact_add"] += l_next
    return new_key, out


def _record_horner(shapes) -> None:
    """One launch's work: every chain's (``roofline.horner_cost``), and the
    longest chain's one-thread time as its floor (the chains run side by
    side, each on its own lanes)."""
    costs = [roofline.horner_cost(*shape) for shape in shapes]
    floor_ms = max(roofline.one_thread_ms(roofline.horner_chain_ops(windows, c))
                   for _, windows, c in shapes)
    tracker.work("horner", sum(b for b, _ in costs), sum(o for _, o in costs), floor_ms * 1e6)


def horner(per_window, c: int):
    """``horner_plain``'s combine; on the card one launch, a chain a segment."""
    _check_windows(per_window, c)
    return horner_groups([(per_window, c)])[0]


def horner_groups(groups):
    """``horner_groups_plain``: the window combine of several (per_window, c)
    groups, each (S_g, W_g, 12) with its own c; on the card all their chains in
    one launch, a block of 8 cooperating lanes a chain."""
    shapes = _check_groups(groups)
    device = groups[0][0][0].device
    if tracker.recording:
        _record_horner(shapes)
    if device.type == "cpu":
        return horner_groups_plain(groups)
    lib = library()
    fq = dc.fq_ctx(device)
    table, rows = chain_table(groups)
    rows = rows.to(device)
    n = rows.shape[0]
    out = tuple(torch.empty((n, fq.num_words), dtype=torch.int32, device=device)
                for _ in range(3))
    with torch.cuda.device(device):
        err = lib.zk_horner(*(t.data_ptr() for t in table), table[0].shape[0], rows.data_ptr(),
                            n, *(t.data_ptr() for t in out), fq.p_words_c, fq.n0_prime32,
                            _stream(device))
    _raise_on(err, "horner")
    launches["horner"] += 1
    lanes["horner"] += n
    for segments, windows, c in shapes:
        chains[windows, c] = chains.get((windows, c), 0) + segments
    parts = [torch.split(v, [segments for segments, _, _ in shapes]) for v in out]
    return [tuple(p[g] for p in parts) for g in range(len(groups))]


def fq_mul_coop(a, b):
    """``fq_mul_coop_plain``; on the card a group of 8 lanes a product,
    coop381.cuh's arithmetic as ``horner`` runs it. Launch counts: none (a
    check)."""
    fq, n = _check_factors(a, b)
    if a.device.type == "cpu":
        return fq_mul_coop_plain(a, b)
    lib = library()
    out = torch.empty((n, fq.num_words), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.zk_fq_mul_coop(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, fq.p_words_c,
                                 fq.n0_prime32, _stream(a.device))
    _raise_on(err, "fq_mul_coop")
    return out
