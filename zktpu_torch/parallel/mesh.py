"""Multi-device sharding for evaluation tables, sumcheck, MSM and NTT.

The counterpart of ``zktpu/parallel/mesh.py``. zktpu annotates its tables with
``jax.sharding`` and lets GSPMD insert the collectives; here one process drives
every slot of a ``Mesh`` and the collectives are written out: copies of shards
to their slots' devices, copies of partial results back to the device the input
came from (its "home"), and reductions of the D partials there. A mesh is a
tuple of ``torch.device``s, one a slot, and may list one device more than once
(the counterpart of ``--xla_force_host_platform_device_count``): the tests run
8 slots on the CPU, ``chip_smoke.py`` 4 slots on one card. On several cards
each slot is its own card and the copies go peer to peer. Every kernel
launches on its device's current stream (``field/kernels.py``), and a copy
between devices orders against the current streams of both, so no side stream
is needed.

Layout contract for sharded MLEs
--------------------------------
A 2^n-entry table is viewed as ``(rows, D, W)``: flat hypercube index = row * D
+ lane, and slot j holds lane j's rows, contiguous, on its device. Sumcheck
always folds variable 0 (the MSB), so every fold is a local ``fold`` kernel on
each shard; only the per-round sums cross devices. The ``halves_sums`` and
``gkr_round`` kernels give each shard's sums as lazy rows (exact integers of
W + 1 words); each shard's rows are reduced mod p on the host before the D of
them are added, so no sum of D rows can overflow a word. Once a shard has one
row, the last log2(D) rounds run on the table gathered back home.

MSM sharding: points and scalars split on the batch axis into D contiguous
blocks; each slot runs the whole Pippenger pipeline on its block, and only the
D Jacobian partials cross devices, summed by a point tree at home. The batched
MSM of the KZG quotients splits its segments instead and replicates the base.

NTT sharding: the four-step decomposition n = n1 * n2. Each slot transforms its
n1 / D rows of n2 (one batched ``ntt_phase1`` and one ``ntt_stage`` a later
stage for all of them) and multiplies by its rows of the twiddle matrix; the
transpose is an all-to-all of (n1 / D, n2 / D) slices; each slot then
transforms n2 / D rows of n1. Only the transpose communicates.

zktpu's ``AXIS``, ``table_sharding`` and ``replicated`` name GSPMD's annotations
and have no counterpart: a shard here is a tensor on its slot's device.
"""

from __future__ import annotations

import torch

from ..curve import device as dc
from ..field import kernels as fk
from ..field import torch_backend as fb
from ..field.torch_backend import FieldCtx
from ..gkr import lazy as lazy_mod
from ..msm import pippenger as pp
from ..ntt import ntt as tn
from ..ntt import ntt_kernels as nk
from ..poly.multilinear import MultilinearPoly
from ..poly.univariate import UnivariatePoly
from ..sumcheck import protocol as sc
from ..transcript import Transcript


class Mesh:
    """An ordered tuple of devices, one a slot; a device may fill many slots."""

    __slots__ = ("devices",)

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``devices`` (which may repeat a device), or, with ``devices``
    None, of the first ``n_devices`` CUDA cards (all of them when None). It
    raises where there is no card or too few; it never falls back to the CPU.
    ``n_devices`` with ``devices`` takes the first ``n_devices`` of them."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices=['cpu'] * k "
                "for a mesh of CPU slots"
            )
        count = torch.cuda.device_count()
        if n_devices is None:
            n_devices = count
        if not 1 <= n_devices <= count:
            raise RuntimeError(f"make_mesh: {n_devices} cards asked for, {count} present")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices)


def _ctxs(spec, mesh: Mesh) -> list[FieldCtx]:
    return [fb.get_ctx(spec, dev) for dev in mesh.devices]


def _split_lanes(table, ctxs: list[FieldCtx]) -> list:
    """(..., size, W) -> D shards (..., size / D, W): shard j the rows of lane j
    of the (..., size / D, D, W) view, contiguous on slot j's device."""
    *lead, size, w = table.shape
    d = len(ctxs)
    lanes = table.reshape(*lead, size // d, d, w)
    return [lanes[..., j, :].contiguous().to(c.device) for j, c in enumerate(ctxs)]


def _join_lanes(shards: list, device):
    """The inverse of ``_split_lanes``, on ``device``."""
    stacked = torch.stack([s.to(device) for s in shards], dim=-2)
    *lead, rows, d, w = stacked.shape
    return stacked.reshape(*lead, rows * d, w)


def _sum_lazy_rows(ctx: FieldCtx, parts: list) -> list[int]:
    """D shards' (k, W + 1) lazy rows (Montgomery sums) -> the k canonical ints
    of their sums: one copy home and one host transfer, each shard's rows
    reduced mod p before the D are added."""
    k = parts[0].shape[0]
    ints = fk.lazy_rows_to_ints(ctx, torch.cat([p.to(ctx.device) for p in parts]))
    p = ctx.spec.modulus
    return [sum(ints[i::k]) % p for i in range(k)]


# ----------------------------------------------------------------------
# sharded MLE
# ----------------------------------------------------------------------

class ShardedMLE:
    """A 2^n-entry Montgomery table sharded on its minor index bits: ``shards``
    [j] is the (rows, W) table of lane j on ``ctxs[j]``'s device; ``home`` the
    context of the table it came from."""

    def __init__(self, home: FieldCtx, ctxs: list[FieldCtx], shards: list, mesh: Mesh):
        self.home = home
        self.ctxs = ctxs
        self.shards = shards
        self.mesh = mesh

    @classmethod
    def shard(cls, poly: MultilinearPoly, mesh: Mesh) -> "ShardedMLE":
        size = poly.table.shape[0]
        if size % mesh.size:
            raise ValueError("table smaller than mesh")
        ctxs = _ctxs(poly.ctx.spec, mesh)
        return cls(poly.ctx, ctxs, _split_lanes(poly.table, ctxs), mesh)

    @property
    def rows(self) -> int:
        return self.shards[0].shape[0]

    @property
    def num_entries(self) -> int:
        return self.rows * self.mesh.size

    def fold(self, value_mont) -> "ShardedMLE":
        """Fold variable 0: the ``fold`` kernel on every shard."""
        folded = [fk.fold(c, s, value_mont.to(c.device)) for c, s in zip(self.ctxs, self.shards)]
        return ShardedMLE(self.home, self.ctxs, folded, self.mesh)

    def halves_sums(self) -> list[int]:
        """[sum of the first half, sum of the second half] of the flat table, as
        canonical ints: the ``halves_sums`` kernel on every shard (the flat
        halves are the rows' halves), D partials added mod p."""
        return _sum_lazy_rows(self.home, [fk.halves_sums(c, s)
                                          for c, s in zip(self.ctxs, self.shards)])

    def total_sum(self) -> int:
        """The sum of every entry, a canonical int: both lazy rows of each
        shard's ``halves_sums`` (a one-row shard is its own lazy row)."""
        parts = []
        for c, s in zip(self.ctxs, self.shards):
            if s.shape[0] > 1:
                parts.append(fk.halves_sums(c, s))
            else:
                parts.append(torch.nn.functional.pad(s, (0, fk.EXTRA_WORDS)))
        p = self.home.spec.modulus
        return sum(_sum_lazy_rows(self.home, parts)) % p

    def gather(self) -> MultilinearPoly:
        """Restack the shards in the flat (2^k, W) layout on the home device."""
        return MultilinearPoly(self.home, _join_lanes(self.shards, self.home.device))


# ----------------------------------------------------------------------
# sharded sumcheck prover (byte-identical to the dense prover)
# ----------------------------------------------------------------------

def sumcheck_prove_sharded(poly: MultilinearPoly, mesh: Mesh) -> sc.Proof:
    """Multi-device plain-sumcheck prover; its proof is
    ``sumcheck.protocol.prove``'s. A round on shards of two or more rows is a
    ``halves_sums`` and a ``fold`` on each; the last log2(D) rounds run on the
    gathered table through the same two kernels."""
    ctx = poly.ctx
    transcript = Transcript(ctx.spec, seed=poly.transcript_sponge())
    current: ShardedMLE | None = ShardedMLE.shard(poly, mesh)
    claimed_sum = current.total_sum()
    transcript.append_field_elements([claimed_sum])

    proof_polynomials = []
    dense = None
    for _ in range(poly.num_vars):
        if current is not None and current.rows > 1:
            halves = current.halves_sums()
        else:
            if dense is None:
                dense = current.gather().table
                current = None
            halves = fk.lazy_rows_to_ints(ctx, fk.halves_sums(ctx, dense))
        transcript.append_field_elements(halves)
        proof_polynomials.append(halves)

        r_mont = sc._encode(ctx, transcript.get_random_challenge())
        if current is not None:
            current = current.fold(r_mont)
        else:
            dense = fk.fold(ctx, dense, r_mont)
    return sc.Proof(proof_polynomials, claimed_sum)


# ----------------------------------------------------------------------
# sharded GKR-variant (lazy fbc) sumcheck
# ----------------------------------------------------------------------

def gkr_sumcheck_lazy_sharded(claimed_sum: int, fbc: lazy_mod.LazyFbc, transcript: Transcript,
                              mesh: Mesh) -> sc.GkrSumcheckProof:
    """Multi-device lazy-fbc sumcheck (``gkr/lazy.py``): the phase tables are
    sharded on their minor bits, each round is the ``gkr_round`` kernel on every
    shard's (2, 2, rows, W) stack (the D partial lazy rows reduced mod p at
    home) and the ``fold`` kernel on every shard; transcript bytes are
    ``gkr_prove_lazy``'s.

    Both phases run as 2-product / 2-factor stacks ([[F, G], [H, 1]] in phase 1
    -- a product by the table of ones changes no field value); a phase shards
    only when its table has more entries than the mesh has slots, and its last
    log2(D) rounds run on the gathered stack."""
    ctx = fbc.ctx
    spec = ctx.spec
    d = mesh.size
    ctxs = _ctxs(spec, mesh)
    proof_polynomials = []
    random_challenges = []

    def run_phase(tables):
        """(2, 2, size, W) on the home device -> the stack after its rounds."""
        size = tables.shape[2]
        shards = _split_lanes(tables, ctxs) if size > d else None
        dense = None if shards is not None else tables
        for _ in range(size.bit_length() - 1):
            if shards is not None and shards[0].shape[2] > 1:
                ys = _sum_lazy_rows(ctx, [fk.gkr_round(c, s) for c, s in zip(ctxs, shards)])
            else:
                if dense is None:
                    dense = _join_lanes(shards, ctx.device)
                    shards = None
                ys = fk.lazy_rows_to_ints(ctx, fk.gkr_round(ctx, dense))
            round_poly = UnivariatePoly.interpolate(spec, list(enumerate(ys)))
            transcript.append_field_elements(round_poly.coefficients)
            proof_polynomials.append(round_poly)
            r = transcript.get_random_challenge()
            random_challenges.append(r)
            r_mont = sc._encode(ctx, r)
            if shards is not None:
                shards = [fk.fold(c, s, r_mont.to(c.device)) for c, s in zip(ctxs, shards)]
            else:
                dense = fk.fold(ctx, dense, r_mont)
        return dense if dense is not None else _join_lanes(shards, ctx.device)

    # phase 1: bind b, tables [[F, G], [H, 1]]
    nb = fbc.num_rounds // 2
    gh = lazy_mod._phase1_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table)
    ones = ctx.one_mont.expand(fbc.w_table.shape)
    tables1 = torch.stack([torch.stack([fbc.w_table, gh[0]]), torch.stack([gh[1], ones])])
    wb = run_phase(tables1)[0, 0, 0]  # the folded F: w(r_b)

    # phase 2: bind c
    eqb = lazy_mod.eq_tensor(ctx, sc._encode(ctx, random_challenges[:nb]))
    run_phase(lazy_mod._phase2_tables_kernel(ctx, fbc.coef_a, fbc.coef_m, fbc.w_table, eqb, wb))
    return sc.GkrSumcheckProof(proof_polynomials, claimed_sum, random_challenges)


# ----------------------------------------------------------------------
# sharded MSM
# ----------------------------------------------------------------------

def _split_batch(t, j: int, d: int, device):
    """Block j of D contiguous blocks of ``t``'s axis 0, on ``device``."""
    n = t.shape[0] // d
    return t[j * n: (j + 1) * n].contiguous().to(device)


def _point_shards(mesh: Mesh, points, scalars=None):
    """(slot device, its block of the points, its block of the scalars)."""
    d = mesh.size
    n = points[0].shape[0]
    if n % d:
        raise ValueError("point count must divide the mesh")
    for j, dev in enumerate(mesh.devices):
        pts = tuple(_split_batch(v, j, d, dev) for v in points)
        yield pts, None if scalars is None else _split_batch(scalars, j, d, dev)


def _sum_partials(parts: list, device):
    """D Jacobian points (triples of (12,) coordinates) -> their sum on
    ``device``: the partials copied there, then ``dc.tree_sum_points``."""
    return dc.tree_sum_points(tuple(torch.stack([p[i].to(device) for p in parts])
                                    for i in range(3)))


def msm_sharded(mesh: Mesh, points, scalars):
    """Ladder MSM (``dc.msm``) on each slot's block of the points and scalars,
    then a point tree of the D partials on the points' device."""
    parts = [dc.msm(pts, s) for pts, s in _point_shards(mesh, points, scalars)]
    return _sum_partials(parts, points[0].device)


def msm_pippenger_sharded(mesh: Mesh, points, scalars, c: int | None = None):
    """Multi-device Pippenger: the MSM is linear in the point set, so each slot
    runs the whole windowed pipeline (``msm_pippenger``) on its block, at the
    window ``pick_window_bits(n / D)`` of a block, and only the D partial points
    cross devices. The same group element as one device's MSM; its Jacobian
    words differ where the window does."""
    n = scalars.shape[0]
    if c is None:
        c = pp.pick_window_bits(n // mesh.size)
    parts = [pp.msm_pippenger(pts, s, c) for pts, s in _point_shards(mesh, points, scalars)]
    return _sum_partials(parts, points[0].device)


def msm_pippenger_multi_sharded(mesh: Mesh, points, scalars_batch):
    """Segment-sharded batched MSM: S same-size MSMs of one shared base, the
    segments split across the slots and the base copied to each. Segments pad
    to a multiple of D with zero scalars (whose MSM is the identity); the pads
    are dropped before return. Returns the Jacobian (S, 12) triple on the
    scalars' device."""
    S, m, w = scalars_batch.shape
    d = mesh.size
    pad = (-S) % d
    if pad:
        zeros = torch.zeros((pad, m, w), dtype=scalars_batch.dtype, device=scalars_batch.device)
        scalars_batch = torch.cat([scalars_batch, zeros])
    s_loc = (S + pad) // d
    c = pp.pick_window_bits_multi(s_loc, m)
    outs = []
    for j, dev in enumerate(mesh.devices):
        base = tuple(v.to(dev) for v in points)
        outs.append(pp.msm_pippenger_multi(base, _split_batch(scalars_batch, j, d, dev), c))
    home = scalars_batch.device
    return tuple(torch.cat([o[i].to(home) for o in outs])[:S] for i in range(3))


def point_tree_sum_sharded(mesh: Mesh, points):
    """Cross-device point reduction alone (the sharded MSM's pattern without its
    pipeline): a point tree on each slot's block, then one of the D partials."""
    parts = [dc.tree_sum_points(pts) for pts, _ in _point_shards(mesh, points)]
    return _sum_partials(parts, points[0].device)


# ----------------------------------------------------------------------
# sharded NTT (four-step)
# ----------------------------------------------------------------------

def twiddle_matrix(ctx: FieldCtx, log_n: int, inverse: bool = False):
    """(n1, n2, W) Montgomery words of w^(m1 k2), n1 = 2^(log_n // 2), n2 =
    n / n1, w the n-th root of unity (or its inverse), built on ``ctx``'s
    device from the cached ``stage_twiddles`` table of w^e, e < n/2, and
    w^(n/2) = -1: w^e = -w^(e - n/2) above. No product; a modular negation of
    the upper half."""
    n = 1 << log_n
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    if n == 1:
        return ctx.one_mont.reshape(1, 1, -1).clone()
    half = n // 2
    e = (torch.arange(n1, device=ctx.device)[:, None]
         * torch.arange(n2, device=ctx.device)[None, :])
    vals = nk.stage_twiddles(ctx, log_n, inverse)[e % half]
    return torch.where((e >= half)[..., None], fb.neg(ctx, vals), vals)


#: (home context, mesh devices, log_n, inverse) -> each slot's rows of the
#: twiddle matrix on its device, held for the life of the process as the
#: twiddle tables of ``ntt_kernels.stage_twiddles`` are
_TWIDDLE_SHARDS: dict = {}


def _twiddle_shards(ctx: FieldCtx, mesh: Mesh, log_n: int, inverse: bool) -> list:
    key = (ctx, mesh.devices, log_n, bool(inverse))
    shards = _TWIDDLE_SHARDS.get(key)
    if shards is None:
        full = twiddle_matrix(ctx, log_n, inverse)
        shards = [_split_batch(full, j, mesh.size, dev) for j, dev in enumerate(mesh.devices)]
        _TWIDDLE_SHARDS[key] = shards
    return shards


def ntt_sharded(ctx: FieldCtx, mesh: Mesh, table, inverse: bool = False):
    """Four-step NTT of a (2^k, W) Montgomery table across the mesh, in natural
    order on the table's device: word for word ``ntt.ntt``'s.

    A[m1, m2] = x[n1 m2 + m1]; slot j transforms its rows of A (length n2, root
    w^n1) and multiplies them by its rows of ``twiddle_matrix``; the transpose
    is an all-to-all of slices; slot k transforms its rows k2 of the transpose
    (length n1, root w^n2): D[k2, k1], and X[n2 k1 + k2] = D[k2, k1]. The row
    transforms do not scale; the inverse scales by n^-1 once, at the end, as
    zktpu does. The slots must divide n1 = 2^(k // 2)."""
    n, w = table.shape
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError("Length must be a power of 2")
    n1 = 1 << (log_n // 2)
    n2 = n // n1
    d = mesh.size
    if n1 % d:
        raise ValueError(f"ntt_sharded: {d} slots do not divide the {n1} rows of a "
                         f"2^{log_n}-entry table")
    r1, r2 = n1 // d, n2 // d
    ctxs = _ctxs(ctx.spec, mesh)
    tws = _twiddle_shards(ctx, mesh, log_n, inverse)

    columns = table.reshape(n2, n1, w)  # columns[m2, m1] = A[m1, m2]
    b = []
    for j, c in enumerate(ctxs):
        rows = columns[:, j * r1: (j + 1) * r1].transpose(0, 1).contiguous().to(c.device)
        b.append(fk.mont_mul(c, tn.transform(c, rows, inverse), tws[j]))
    parts = []
    for k, c in enumerate(ctxs):
        # the all-to-all: slot k takes columns k2 of every slot's rows
        ct = torch.cat([bj[:, k * r2: (k + 1) * r2].contiguous().to(c.device) for bj in b])
        parts.append(tn.transform(c, ct.transpose(0, 1).contiguous(), inverse))
    out = torch.cat([part.to(ctx.device) for part in parts]).transpose(0, 1).reshape(n, w)
    if inverse:
        out = fk.mont_mul(ctx, out, tn._n_inv_mont(ctx, log_n))
    return out
