"""Pippenger MSM: sort-by-digit bucket accumulation + suffix-scan bucket
reduction, with every group operation running as a point kernel.

The counterpart of ``zktpu/msm/pippenger.py``, stage for stage:

1. **Digits**: c-bit windows (c | 32) sliced out of the 32-bit scalar words.
   Signed recoding (digit in [-2^(c-1), 2^(c-1)]) halves the bucket count; a
   negative digit takes the negated point.
2. **Sort**: one stable sort of ``window * NBUCK + |digit|`` keys groups equal
   buckets into contiguous runs -- data movement, no group math.
3. **Compaction tree**: each round pairs rank-even run elements with their right
   neighbour (one Jacobian add at the *compacted* width) and compacts the
   survivors: ``run_scan`` finds them, ``compact_add`` adds each survivor to its
   neighbour where they lie (``msm/kernels.py``; the survivor count stays on the
   device). Every run halves every round and the array physically shrinks, so
   total add work is a small constant times the input size. The round count
   follows the data: ceil(log2(longest run)), read back once a window group
   from the first round's scan.
4. **Densify**: merge the per-key survivors with one dummy infinity per bucket,
   sort, one more pair round -> a dense (W, NBUCK) bucket table.
5. **Bucket reduction**: suffix sums T_j = sum_{k>=j} B_k by Kogge-Stone shifts,
   then sum_j T_j = sum_k k*B_k by a pairwise tree.
6. **Window combine**: a Horner chain of c doublings and one addition a window,
   the whole chain of every segment in one ``horner`` launch; the chains of
   several MSMs (``msm_pippenger_multi_batches``: a proof's quotient steps) in
   one launch too.

Eager PyTorch is staged by nature, one launch a stage at whatever width the
stage has, so what the JAX package adds to keep its compiler's bill down has no
counterpart: the monolithic one-program variants, the device-side ``while_loop``
of fixed-width rounds, the rolled ``fori_loop`` reductions, the quantised
widths and the switch to a bit-split ladder for small batched MSMs.

The sorts are stable, so a run gives the same Jacobian words on the card and on
the CPU, not only the same group element. Points are lanes-first ``(L, 12)``
word triples throughout; infinity is Z == 0, so masked-out lanes are free.
"""

from __future__ import annotations

import math

import torch

from ..curve import device as dc
from ..field import torch_backend as fb
from ..utils import tracker
from . import kernels as mk

#: bytes the sort and the first compaction round of one window group may hold.
#: An entry is a 144-byte point; the sort gathers the sorted copy (X, Y, Z and
#: the masked Z), the first round writes half a copy beside it, and the keys
#: and the sort's indices live too: under 4 copies in all. 24 GB of the card's
#: 80 leaves room for the bases, the tables of the proof and PyTorch's cached
#: blocks.
SORT_BUDGET_BYTES = int(24e9)
_LIVE_COPIES = 4
POINT_BYTES = 3 * 48
#: cap on the dense (S*W, NBUCK) bucket table of a batched MSM; a Kogge-Stone
#: step holds about four copies of it
BUCKET_TABLE_BYTES = int(8e9)


def _model_cost(c: int, lanes: int, segments: int) -> float:
    """Group additions of the pipeline: accumulation ~2.2*W*n (compaction tree),
    densify 2*W*K, Kogge-Stone suffix sums W*K*log2(K), pairwise tree 2*W*K."""
    w = 256 // c
    k = 1 << (c - 1)
    return (2.2 * w * lanes + 2 * segments * w * k
            + segments * w * k * max(1, math.ceil(math.log2(k))) + 2 * segments * w * k)


def pick_window_bits(n: int) -> int:
    """Window width minimizing total group adds for an n-point MSM."""
    return min((4, 8, 16), key=lambda c: _model_cost(c, n, 1))


def pick_window_bits_multi(S: int, m: int) -> int:
    """Window width for an S-segment batched MSM of m points each. The reduction
    terms and the dense bucket table scale with S*W: windows whose table exceeds
    ``BUCKET_TABLE_BYTES`` are excluded outright."""
    fits = [c for c in (4, 8, 16)
            if S * (256 // c) * ((1 << (c - 1)) + 1) * POINT_BYTES <= BUCKET_TABLE_BYTES]
    return min(fits or [4], key=lambda c: _model_cost(c, S * m, S))


def _recode_signed(scalars, c: int):
    """Canonical (n, 8) Fr words -> (W, n) |digit| int32 + (W, n) sign bool.

    scalar = sum_w d_w * 2^(cw) with d_w in [-2^(c-1), 2^(c-1)]; a digit
    > 2^(c-1) borrows: use d - 2^c and carry 1 into the next window. W*c =
    256 > 255 scalar bits, so the top window never overflows.
    """
    W = 256 // c
    per_word = 32 // c
    half, full, mask = 1 << (c - 1), 1 << c, (1 << c) - 1
    carry = torch.zeros(scalars.shape[0], dtype=torch.int32, device=scalars.device)
    abs_digits, signs = [], []
    for w in range(W):
        # `>>` on int32 is arithmetic: the mask drops the sign's copies
        u = (scalars[:, w // per_word] >> ((w % per_word) * c)) & mask
        d = u + carry
        neg = d > half
        abs_digits.append(torch.where(neg, full - d, d))
        signs.append(neg)
        carry = neg.to(torch.int32)
    return torch.stack(abs_digits), torch.stack(signs)


def _compact_round(key, pt, l_next: int):
    """One compaction-tree round: pair rank-even elements with their right
    neighbour when keys match, then compact survivors to ``l_next`` slots.

    ``key``: (L,) int32 sorted; ``pt``: Jacobian (L, 12) triple. Padding slots
    get key MAXKEY / value infinity.
    """
    srcpos, count, _ = mk.run_scan(key, l_next)
    return mk.compact_add(key, pt, srcpos, count)


def _compaction_schedule(l0: int, max_segments: int) -> list[int]:
    """The shrinking sizes of the first rounds: survivors <= (L + #runs) / 2.
    Once the size stops shrinking meaningfully (<= 2 * max_segments) the rounds
    that remain run at that last size."""
    rounds = max(1, math.ceil(math.log2(max(2, l0))))
    sizes, L = [], l0
    while L > 2 * max_segments and len(sizes) < rounds:
        L = min(L, (L + max_segments + 1) // 2 + 1)
        sizes.append(L)
    return sizes


def _presort(points, neg_y, abs_d, signs, nbuck: int):
    """Sort a window group by (window, |digit|) key; take the negated point on
    negative digits, mask digit-0 lanes to infinity. Returns (sorted key, pt).

    ``neg_y`` is 0 - Y of the n base points, taken once a call: the sorted
    lanes gather their Y from [Y, -Y] by sign, which keeps the 12-word
    subtraction at the width of the base and off the Wg*n sorted lanes."""
    Xp, Yp, Zp = points
    Wg, n = abs_d.shape
    offsets = torch.arange(Wg, dtype=torch.int32, device=abs_d.device)[:, None] * nbuck
    key = (abs_d + offsets).reshape(-1)
    skey, order = torch.sort(key, stable=True)
    src = order % n
    sgn = signs.reshape(-1)[order]

    X = Xp[src]
    Y = torch.cat([Yp, neg_y])[src + sgn * n]
    Z = Zp[src]
    # digit 0 contributes nothing: mask those lanes to infinity
    Z = torch.where((skey % nbuck == 0)[:, None], torch.zeros_like(Z), Z)
    return skey, (X, Y, Z)


def _densify(skey, pt, Wg: int, nbuck: int):
    """One dummy infinity per (window, bucket) key, sort, one more pair round ->
    a dense (Wg, nbuck, 12) bucket table in key order."""
    n_keys = Wg * nbuck
    dummy_key = torch.arange(n_keys, dtype=skey.dtype, device=skey.device)
    skey2, order2 = torch.sort(torch.cat([skey, dummy_key]), stable=True)
    inf = dc.infinity_like((n_keys,), skey.device)
    pt2 = tuple(torch.cat([a, b])[order2] for a, b in zip(pt, inf))
    _, dense = _compact_round(skey2, pt2, n_keys)
    return tuple(v.reshape(Wg, nbuck, -1) for v in dense)


def _bucket_pipeline_staged(points, abs_g, sgn_g, nbuck: int):
    """(G, Wg, n) digit groups -> (G*Wg, nbuck, 12) bucket table (bucket 0 holds
    what the reduction drops).

    Data-adaptive round count: every compaction round halves every run, so
    ceil(log2(longest run)) rounds suffice -- for random scalars the longest
    bucket run is ~n/NBUCK + O(sqrt), a few rounds instead of the worst-case
    log2(Wg*n) (which only degenerate inputs -- all scalars equal -- need). One
    integer a group is fetched to the host for it: a synchronising call."""
    G, Wg, n = abs_g.shape
    fq = dc.fq_ctx(points[0].device)
    neg_y = fb.sub(fq, torch.zeros_like(points[1]), points[1])
    parts = []
    for g in range(G):
        skey, pt = _presort(points, neg_y, abs_g[g], sgn_g[g], nbuck)
        sizes = _compaction_schedule(Wg * n, Wg * nbuck + 1)
        # a group takes at least one round, whose width does not depend on the
        # data: its scan gives the longest run as well
        srcpos, count, longest = mk.run_scan(skey, sizes[0] if sizes else skey.shape[0])
        if tracker.recording:
            tracker.fetch("pippenger.longest", longest.element_size())
        rounds_needed = math.ceil(math.log2(max(2, int(longest.item()))))
        sizes = sizes[:rounds_needed]
        sizes += [sizes[-1] if sizes else skey.shape[0]] * (rounds_needed - len(sizes))
        skey, pt = mk.compact_add(skey, pt, srcpos, count)
        for l_next in sizes[1:]:
            skey, pt = _compact_round(skey, pt, l_next)
        parts.append(_densify(skey, pt, Wg, nbuck))
    if G == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def _flat_add(a, b):
    shape = a[0].shape
    out = dc.point_add(tuple(v.contiguous() for v in a), tuple(v.contiguous() for v in b))
    return tuple(v.reshape(shape) for v in out)


def _ks_step(vals, d: int):
    """One Kogge-Stone suffix-sum step at shift ``d`` over (W, K, 12) tables."""
    W = vals[0].shape[0]
    inf = dc.infinity_like((W, d), vals[0].device)
    shifted = tuple(torch.cat([v[:, d:], pad], dim=1) for v, pad in zip(vals, inf))
    return _flat_add(vals, shifted)


def _pair_step(vals):
    """One halving level of the pairwise bucket-sum tree."""
    k = vals[0].shape[1]
    half = k // 2
    red = _flat_add(tuple(v[:, :half] for v in vals), tuple(v[:, half: 2 * half] for v in vals))
    if k % 2:
        red = tuple(torch.cat([r, v[:, 2 * half:]], dim=1) for r, v in zip(red, vals))
    return red


def _weighted_reduce_staged(buckets):
    """(W, NBUCK, 12) bucket table -> (W, 12) per-window sums sum_k k*B_k:
    Kogge-Stone suffix sums T_j = sum_{k>=j} B_k, then sum_{j>=1} T_j by a
    halving tree; bucket 0 is dropped."""
    vals = tuple(v[:, 1:] for v in buckets)
    K = vals[0].shape[1]
    d = 1
    while d < K:
        vals = _ks_step(vals, d)
        d *= 2
    while vals[0].shape[1] > 1:
        vals = _pair_step(vals)
    return tuple(v[:, 0] for v in vals)


def _horner_multi(per_window, c: int):
    """Window combine over (S, W, 12) per-segment tables -> (S, 12):
    acc = ((R_{W-1} * 2^c + R_{W-2}) * 2^c + ...), every segment's chain in one
    ``horner`` launch."""
    return mk.horner(tuple(v.contiguous() for v in per_window), c)


def _horner_single(per_window, c: int):
    """Window combine of one MSM: (W, 12) tables -> (12,) coordinates."""
    return tuple(v[0] for v in _horner_multi(tuple(v[None] for v in per_window), c))


def _pick_window_group(n: int, num_windows: int) -> int:
    """Windows per sort pass (a power-of-two fraction of ``num_windows``),
    capping what the sort and the first compaction round hold at
    ``SORT_BUDGET_BYTES``."""
    cap = max(1, SORT_BUDGET_BYTES // (max(1, n) * POINT_BYTES * _LIVE_COPIES))
    wg = num_windows
    while wg > cap and wg % 2 == 0:
        wg //= 2
    return max(1, wg)


def msm_pippenger_multi(points, scalars_batch, c: int | None = None):
    """S same-size MSMs against one shared base. ``points``: Jacobian (m, 12)
    triple; ``scalars_batch``: canonical (S, m, 8) Fr words. Returns the
    Jacobian (S, 12) triple of the S results.

    The S segments ride the windowed pipeline as S*W independent windows over
    the same point set."""
    if c is None:
        c = pick_window_bits_multi(*scalars_batch.shape[:2])
    return _horner_multi(_window_sums(points, scalars_batch, c), c)


def msm_pippenger_multi_batches(jobs):
    """Several ``msm_pippenger_multi`` calls, each ``(points, scalars_batch)``
    at its own window width, whose window combines run together: one
    ``horner`` launch for all their chains. Returns each call's Jacobian
    (S, 12) triple, in order, the words ``msm_pippenger_multi`` gives."""
    groups = []
    for points, scalars_batch in jobs:
        c = pick_window_bits_multi(*scalars_batch.shape[:2])
        groups.append((tuple(v.contiguous() for v in _window_sums(points, scalars_batch, c)), c))
    return mk.horner_groups(groups)


def _window_sums(points, scalars_batch, c: int):
    """The per-window sums sum_k k * B_k of S same-size MSMs against one base:
    Jacobian (S, 256/c, 12) tables, the window combine's input."""
    S, m = scalars_batch.shape[:2]
    num_windows = 256 // c
    SW = S * num_windows
    nbuck = (1 << (c - 1)) + 1
    wg = _pick_window_group(m, SW)
    abs_d, signs = _recode_signed(scalars_batch.reshape(S * m, -1), c)  # (W, S*m)
    # (W, S, m) -> (S*W, m): segment-major window slots
    abs_d = abs_d.reshape(num_windows, S, m).transpose(0, 1).reshape(SW // wg, wg, m)
    signs = signs.reshape(num_windows, S, m).transpose(0, 1).reshape(SW // wg, wg, m)
    buckets = _bucket_pipeline_staged(points, abs_d, signs, nbuck)
    per_window = _weighted_reduce_staged(buckets)  # (S*W, 12)
    return tuple(v.reshape(S, num_windows, -1) for v in per_window)


def msm_pippenger(points, scalars, c: int | None = None):
    """MSM over a Jacobian (n, 12) triple (the ``pack_points`` layout) and
    canonical (n, 8) Fr scalars; returns a single Jacobian point as a triple of
    (12,) coordinates.

    ``c``: window bit-width (4, 8 or 16); picked by input size when None.
    """
    if c is None:
        c = pick_window_bits(scalars.shape[0])
    return tuple(v[0] for v in msm_pippenger_multi(points, scalars[None], c))


def msm_pippenger_host(affine_points, scalar_ints, c: int | None = None, device=None):
    """Host points/ints in, host affine point out (test convenience)."""
    pts = dc.pack_points(affine_points, device)
    out = msm_pippenger(pts, dc.pack_scalars(scalar_ints, device), c)
    return dc.unpack_points(tuple(t[None] for t in out))[0]
