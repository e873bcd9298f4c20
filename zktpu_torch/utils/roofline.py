"""Per-kernel roofline of the port on one NVIDIA H100: bytes, operations, bounds.

The counterpart of the JAX package's ``utils/roofline.py``, for the card:

  * ``PEAKS`` / ``chip_peaks``: the card's memory rate and 32-bit integer
    multiply-add rate, by ``torch.cuda.get_device_name``;
  * cost models of the nineteen kernels: (bytes moved, 32-bit multiply-adds,
    or for Keccak 32-bit logical instructions and funnel shifts) of one call,
    each input read once and each output written once; ``one_thread_ms``, the
    least time of a one-thread kernel's operations (its warp issues one
    instruction a cycle), which bounds a Horner chain or a transcript round;
  * ``bound``: the least time the card could take for such work, the larger of
    bytes over the memory rate and operations over the integer rate;
  * ``time_events`` / ``measure``: CUDA-event timing, and a ``KernelProfile``
    of achieved rates against the bound.

Operation counts: a 32x32->64 multiply-accumulate counts two (its low and high
halves); a Montgomery product 2(2W^2 + W) (272 at W = 8, 600 at W = 12), a
squaring W(W + 1) + W(2W + 1) (456 at W = 12, each cross product formed once);
modular additions and subtractions are not counted, nor products by w^0 = 1.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from ..field.kernels import EXTRA_WORDS
from ..ntt.ntt_kernels import LOG_TILE

H100 = "NVIDIA H100 80GB HBM3"


@dataclasses.dataclass(frozen=True)
class Peaks:
    bytes_per_s: float
    int32_mad_per_s: float


#: the H100's boost clock (Hz)
H100_CLOCK = 1.98e9
#: peaks by device name. H100 SXM: memory 3.35 TB/s (data sheet); integer 132
#: SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12 32-bit multiply-adds a second.
#: No other card is listed: a bound against a guessed peak would read as a
#: measurement.
PEAKS = {H100: Peaks(bytes_per_s=3.35e12, int32_mad_per_s=132 * 64 * H100_CLOCK)}


def chip_peaks(device=None) -> Peaks:
    """The peaks of the CUDA device ``device`` (``None``: the current one).
    Raises without a card, on a CPU device, and on a card ``PEAKS`` lacks."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_peaks: no CUDA device; the bounds are the card's")
    if device is not None and torch.device(device).type != "cuda":
        raise RuntimeError(f"chip_peaks: {device} is not a CUDA device")
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise RuntimeError(f"chip_peaks: no peaks for {name!r} (PEAKS lists {sorted(PEAKS)})")
    return PEAKS[name]


@dataclasses.dataclass(frozen=True)
class Bound:
    """The least time of some work: its bytes and its operations at the peaks."""

    bytes_ms: float
    ops_ms: float

    @property
    def ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def bound(nbytes: float, ops: float, peaks: Peaks | None = None) -> Bound:
    """The bound of ``nbytes`` moved and ``ops`` 32-bit multiply-adds
    (``peaks`` None: ``chip_peaks()``)."""
    peaks = peaks or chip_peaks()
    return Bound(nbytes / peaks.bytes_per_s * 1e3, ops / peaks.int32_mad_per_s * 1e3)


# ----------------------------------------------------------------------
# cost models: (bytes moved, 32-bit multiply-adds) of one call
# ----------------------------------------------------------------------

def elem_bytes(num_words: int) -> int:
    """Bytes of one element: W packed 32-bit words, no padding."""
    return 4 * num_words


def cios_lane_ops(num_words: int) -> int:
    """32-bit multiply-adds of one Montgomery product: W^2 for the product and
    W^2 + W for the reduction, low and high halves each."""
    return 2 * (2 * num_words * num_words + num_words)


def sqr_lane_ops(num_words: int) -> int:
    """32-bit multiply-adds of one Montgomery squaring."""
    return num_words * (num_words + 1) + num_words * (2 * num_words + 1)


def _rows_bytes(num_words: int) -> int:
    """Bytes of the two lazy sum rows of a summing kernel."""
    return 2 * 4 * (num_words + EXTRA_WORDS)


def mont_mul_cost(size: int, num_words: int):
    """A table times one element (as ``to_mont`` of a table)."""
    elem = elem_bytes(num_words)
    return 2 * size * elem + elem, size * cios_lane_ops(num_words)


def fold_cost(size: int, num_words: int):
    """A fold of one variable: read the table and r, write half a table; one
    product an output."""
    elem = elem_bytes(num_words)
    return size * elem + size // 2 * elem + elem, size // 2 * cios_lane_ops(num_words)


def halves_sums_cost(size: int, num_words: int):
    """Read the table, write two lazy rows; a 64-bit column add is two 32-bit adds."""
    return size * elem_bytes(num_words) + _rows_bytes(num_words), size * 2 * num_words


def fold_and_halves_cost(size: int, num_words: int):
    nbytes, ops = fold_cost(size, num_words)
    return nbytes + _rows_bytes(num_words), ops + size // 2 * 2 * num_words


def gkr_round_cost(size: int, num_words: int):
    """A (2, 2, size, W) stack: six products and three terms an index."""
    return (4 * size * elem_bytes(num_words) + 3 * _rows_bytes(num_words) // 2,
            size // 2 * (6 * cios_lane_ops(num_words) + 3 * 2 * num_words))


#: the five kernels of ``field/kernels.py`` by name: (size, W) -> cost
FIELD_KERNEL_COSTS = {
    "mont_mul": mont_mul_cost,
    "fold": fold_cost,
    "halves_sums": halves_sums_cost,
    "fold_and_halves": fold_and_halves_cost,
    "gkr_round": gkr_round_cost,
}

_FQ381_WORDS = 12


def point_add_cost(lanes: int):
    """Finite, unequal G1 points: read six, write three 48-byte coordinates;
    11 Montgomery products and 5 squarings (add-2007-bl)."""
    w = _FQ381_WORDS
    return 9 * 48 * lanes, (11 * cios_lane_ops(w) + 5 * sqr_lane_ops(w)) * lanes


def point_double_cost(lanes: int):
    """Read three, write three coordinates; 2 products and 5 squarings
    (dbl-2009-l)."""
    w = _FQ381_WORDS
    return 6 * 48 * lanes, (2 * cios_lane_ops(w) + 5 * sqr_lane_ops(w)) * lanes


#: the two kernels of ``curve/point_kernels.py`` by name: lanes -> cost
POINT_KERNEL_COSTS = {"point_add": point_add_cost, "point_double": point_double_cost}

_NTT_ELEM = elem_bytes(8)  # BN254 Fr


def ntt_phase1_cost(log_n: int, batch: int = 1):
    """The first min(LOG_TILE, log_n) stages of a 2^log_n table (of each of a
    batch of tables): the tables read and written once, the tile's T/2
    distinct twiddles read once, a product a butterfly whose twiddle is not 1."""
    n = 1 << log_n
    log_tile = min(LOG_TILE, log_n)
    products = sum(n // 2 - (n >> s) for s in range(1, log_tile + 1))
    return (2 * batch * n * _NTT_ELEM + (1 << log_tile) // 2 * _NTT_ELEM,
            batch * products * cios_lane_ops(8))


def ntt_stage_cost(log_n: int, stage: int, batch: int = 1):
    """The stage of span m = 2^stage (over each of a batch of tables): the
    tables read and written once, the m/2 twiddles read once; n/m of a table's
    butterflies multiply by 1."""
    n = 1 << log_n
    return (2 * batch * n * _NTT_ELEM + (1 << (stage - 1)) * _NTT_ELEM,
            batch * (n // 2 - (n >> stage)) * cios_lane_ops(8))


def ntt_cost(log_n: int) -> list:
    """The cost of each launch of one transform of 2^log_n entries: phase 1,
    then every later stage."""
    first = min(LOG_TILE, log_n)
    return [ntt_phase1_cost(log_n)] + [ntt_stage_cost(log_n, s)
                                       for s in range(first + 1, log_n + 1)]


# ----------------------------------------------------------------------
# the transcript kernels (``hash/kernels.py``): one thread a state, one warp a round
# ----------------------------------------------------------------------

_LANE_BYTES = 8
_STATE_BYTES = 25 * _LANE_BYTES
#: the least 32-bit instructions of one Keccak-f[1600] round. A 64-bit lane is
#: two 32-bit halves, every logical function of up to three inputs is one LOP3
#: a half, a 64-bit rotation two funnel shifts (SHF) and pi only renames
#: registers: theta's five column parities (two LOP3 a half, 20), the parities
#: rotated by one (10 SHF), each lane xored with both neighbouring parities (one
#: LOP3 a half, 50); rho's 24 rotations (none by 0 or 32, 48 SHF); chi's
#: a ^ (~b & c) (one LOP3 a half, 50); iota's 64-bit constant (2). 180 in all.
KECCAK_ROUND_OPS = 20 + 10 + 50 + 48 + 50 + 2
#: ... and of the 24 rounds of the permutation: 4,320
KECCAK_F_OPS = 24 * KECCAK_ROUND_OPS


def keccak_f_cost(states: int):
    """Read and write each 25-lane state once; ``KECCAK_F_OPS`` each."""
    return 2 * _STATE_BYTES * states, KECCAK_F_OPS * states


def round_step_blocks(k: int, prefix_lanes: int, first: bool) -> int:
    """The permutations a round needs at the least: its content (the prefix,
    then the round's elements, 4 lanes each) and its padding over 17-lane
    blocks. A plain sumcheck round absorbs both its sums; a GKR round's trimmed
    length (0-3) is found on the card, so its content is priced at none. A
    steady round's prefix, the 4-lane digest, leaves it one block."""
    elements = k if k == 2 else 0
    return (prefix_lanes + 4 * elements) // 17 + 1 if first else 1


def round_step_cost(k: int, prefix_lanes: int = 4, blocks: int | None = None,
                    first: bool = False):
    """One ``round_step`` over k lazy rows (2: plain sumcheck; 3: GKR): read
    the rows, the prefix (the last digest, or a pending tail) and, in a first
    round, the host's state; write the canonical rows, the state and the
    challenge. Products: k canonical values, the interpolation's division by
    two (k = 3), the challenge's Montgomery form; ``blocks`` permutations
    (None: what ``round_step_blocks`` says the round needs at the least)."""
    w = 8
    if blocks is None:
        blocks = round_step_blocks(k, prefix_lanes, first)
    nbytes = (k * (w + 1) * 4 + prefix_lanes * _LANE_BYTES + (_STATE_BYTES if first else 0)
              + k * elem_bytes(w) + _STATE_BYTES + elem_bytes(w))
    products = k + (1 if k == 3 else 0) + 1
    return nbytes, products * cios_lane_ops(w) + blocks * KECCAK_F_OPS


def gkr_step_cost(size: int, fold: bool):
    """The fused step of a GKR round on a (2, 2, size, W) stack at W = 8: with
    a fold, the stack read and its half written, a product for each of the
    4 size/2 folded entries and six, with three terms' additions, for each of
    the size/4 indices of the folded stack's sums; without, ``gkr_round``'s
    reads and products. Its lazy rows stay on the chip."""
    elem = elem_bytes(8)
    if not fold:
        return 4 * size * elem, size // 2 * (6 * cios_lane_ops(8) + 3 * 2 * 8)
    return (4 * size * elem + 2 * size * elem + elem,
            2 * size * cios_lane_ops(8) + size // 4 * (6 * cios_lane_ops(8) + 3 * 2 * 8))


def gkr_big_round_cost(size: int, fold: bool):
    """One ``gkr_big_round``: its fused step and the round's ``round_step``
    (a phase's first round priced with no pending tail and one block, the
    least it needs)."""
    step = gkr_step_cost(size, fold)
    rnd = round_step_cost(3, 4 if fold else 0, first=not fold)
    return step[0] + rnd[0], step[1] + rnd[1]


def gkr_tail_sizes(size: int, fold: bool) -> list[tuple[int, bool]]:
    """(stack entries, folds) of each round of a ``gkr_phase_tail`` given a
    stack of ``size`` entries: until the summed table has two entries."""
    rounds = []
    while size > (2 if fold else 1) * 2:
        rounds.append((size, fold))
        size = size // 2 if fold else size
        fold = True
    return rounds + [(size, fold)]


def gkr_phase_tail_cost(size: int, fold: bool):
    """One ``gkr_phase_tail``: the stack read once and each round's
    coefficients, state and challenge written once, w(r_b) written (its folds
    stay in a work buffer, which the function need not move); the products
    of every round's fused step and ``round_step`` and of the last fold."""
    steps = gkr_tail_sizes(size, fold)
    elem = elem_bytes(8)
    nbytes = 4 * size * elem + len(steps) * (3 * elem + _STATE_BYTES + elem) + elem
    ops = cios_lane_ops(8)
    for k, (n, f) in enumerate(steps):
        ops += gkr_step_cost(n, f)[1] + round_step_cost(3, 4 if f else 0, first=k == 0
                                                        and not fold)[1]
    return nbytes, ops


def gkr_phase_cost(size: int, ones: bool):
    """The least work of a whole fused GKR phase on a (2, 2, size, W) stack
    at W = 8, however ``TAIL_MAX`` splits it into launches: (bytes, 32-bit
    multiply-adds, floor ms). Bytes: the stack read once, each round's three
    coefficients and sponge state written once. Operations: each round's fused
    step (``gkr_step_cost``) and ``round_step`` (``round_step_cost``; the first
    round priced with no pending tail), less, where the stack's [1, 1] table
    is phase 1's constant ones (``ones``), the products on it: its fold and the
    three of each sum index. Floor: each round's one-warp ``round_step`` chain
    (``one_thread_ms``), since each round waits on the last one's challenge."""
    elem = elem_bytes(8)
    product = cios_lane_ops(8)
    rounds = gkr_tail_sizes(size, False)
    ops = 0
    for k, (n, fold) in enumerate(rounds):
        ops += gkr_step_cost(n, fold)[1] + round_step_cost(3, 4 if fold else 0, first=k == 0)[1]
        if ones:
            ops -= (n // 2 + 3 * (n // 4) if fold else 3 * (n // 2)) * product
    nbytes = 4 * size * elem + len(rounds) * (3 * elem + _STATE_BYTES)
    return nbytes, ops, len(rounds) * one_thread_ms(round_step_cost(3)[1])


#: the two fused GKR phase kernels by name: (stack entries, folds first) -> cost
GKR_PHASE_COSTS = {"gkr_big_round": gkr_big_round_cost, "gkr_phase_tail": gkr_phase_tail_cost}


def gkr_wiring_cost(gates: int, terms: int):
    """A layer's wiring coefficients: the gate mask read, coef_a and coef_m
    written; a product a gate and term (its eq entry's last factor, the scale
    folded into the block's seed)."""
    return gates + 2 * gates * elem_bytes(8), terms * gates * cios_lane_ops(8)


def gkr_phase1_stack_cost(gates: int):
    """A layer's phase-1 stack: w (2n entries) and both coefficients read, the
    four tables of 2n entries written; two products a gate."""
    return (4 * gates + 8 * gates) * elem_bytes(8), 2 * gates * cios_lane_ops(8)


def gkr_phase2_stack_cost(gates: int):
    """A layer's phase-2 stack: as the phase-1 stack's bytes; four products a
    gate (eq(r, 2g)'s last factor, A2, and M2's two)."""
    return (4 * gates + 8 * gates) * elem_bytes(8), 4 * gates * cios_lane_ops(8)


#: the three GKR layer-table kernels (``gkr/tables.py``) by name: gates -> cost
#: (the wiring's also takes its terms)
GKR_TABLES_COSTS = {
    "gkr_wiring": gkr_wiring_cost,
    "gkr_phase1_stack": gkr_phase1_stack_cost,
    "gkr_phase2_stack": gkr_phase2_stack_cost,
}


def gkr_phase_floor_ms(name: str, size: int, fold: bool) -> float:
    """The one-warp floor that a launch adds to its bound: each of its rounds'
    ``round_step`` chain (``one_thread_ms``), which no other block shares."""
    rounds = len(gkr_tail_sizes(size, fold)) if name == "gkr_phase_tail" else 1
    return rounds * one_thread_ms(round_step_cost(3)[1])


def one_thread_ms(ops: float) -> float:
    """The least time of ``ops`` 32-bit operations on ONE thread: its warp
    issues at most one instruction a cycle. This, not ``bound`` (the whole
    card's rate, nanoseconds for a state or a round), is what a one-thread
    kernel's dependent chain costs at the least."""
    return ops / H100_CLOCK * 1e3


# ----------------------------------------------------------------------
# the MSM kernels (``msm/kernels.py``)
# ----------------------------------------------------------------------

_KEY_BYTES = 4
_POINT_BYTES = 3 * 48


def run_scan_cost(keys: int, slots: int):
    """Read the sorted keys once; write the ``slots`` survivor positions, the
    count and the longest run. No multiply-adds: compares and counts."""
    return _KEY_BYTES * (keys + slots + 2), 0


def compact_add_cost(slots: int, survivors: int, adds: int):
    """A round of ``slots`` outputs: read the count, and for each of the
    ``survivors`` its position, its key, its neighbour's key and its point,
    and the neighbour's point where the two add; write a key and a point a
    slot. Products only on the ``adds`` slots that add two finite points
    (add-2007-bl); a slot with an infinite operand copies."""
    nbytes = (_KEY_BYTES + survivors * (3 * _KEY_BYTES + _POINT_BYTES) + adds * _POINT_BYTES
              + slots * (_KEY_BYTES + _POINT_BYTES))
    return nbytes, adds * point_add_cost(1)[1]


def horner_chain_ops(windows: int, c: int) -> int:
    """One segment's chain: (windows - 1) x (c doublings and an addition)."""
    return (windows - 1) * (c * point_double_cost(1)[1] + point_add_cost(1)[1])


def horner_cost(segments: int, windows: int, c: int):
    """Read each segment's ``windows`` points, write one; each segment's chain.
    Its chain is one thread's: ``one_thread_ms(horner_chain_ops(windows, c))``
    is the least time of a launch."""
    return (segments * (windows + 1) * _POINT_BYTES,
            segments * horner_chain_ops(windows, c))


def lanes_bound_ms(name: str, lanes: int, doublings: int, peaks: Peaks | None = None,
                   rounds: dict | None = None, scan_slots: int = 0,
                   chains: dict | None = None, phase_calls: dict | None = None) -> float:
    """The least time of ``lanes`` lanes of a kernel, as in its row's bound:
    the five field kernels at W = 8 (a path's few 12-word ``mont_mul`` lanes
    priced so too), ``point_add`` on finite lanes, ``point_double``'s bytes by
    lanes and products by ``doublings`` (lanes x times), the NTT kernels at
    the 2^10 tile with no twiddle reads, ``keccak_f`` by states, ``round_step``
    by ``rounds`` (``hash.kernels.rounds``: launches by rows, prefix lanes and
    first round), each round at its own cost; ``run_scan`` by keys and
    ``scan_slots``, ``compact_add`` by slots, each a survivor, its additions
    not priced (which slots add is on the card), ``horner`` by ``chains``
    (``msm.kernels.chains``: segments by windows and c), the two fused GKR
    phase kernels by rounds and ``phase_calls`` (``gkr.kernels.calls``:
    launches by kernel, stack entries and first fold), each at its own cost."""
    if lanes == 0:
        return 0.0
    if name == "run_scan":
        nbytes, ops = run_scan_cost(lanes, scan_slots)
    elif name == "compact_add":
        nbytes, ops = compact_add_cost(lanes, lanes, 0)
    elif name == "horner":
        if chains is None or sum(chains.values()) != lanes:
            raise ValueError(f"horner: {lanes} segments, priced by kind {chains}")
        costs = [horner_cost(s, w, c) for (w, c), s in chains.items()]
        nbytes, ops = (sum(c[i] for c in costs) for i in range(2))
    elif name in GKR_PHASE_COSTS:
        mine = {(size, fold): n for (kernel, size, fold), n in (phase_calls or {}).items()
                if kernel == name}
        rounds = sum(n * (len(gkr_tail_sizes(size, fold)) if name == "gkr_phase_tail" else 1)
                     for (size, fold), n in mine.items())
        if rounds != lanes:
            raise ValueError(f"{name}: {lanes} rounds, priced by launch {phase_calls}")
        costs = [[n * v for v in GKR_PHASE_COSTS[name](size, fold)]
                 for (size, fold), n in mine.items()]
        nbytes, ops = (sum(c[i] for c in costs) for i in range(2))
    elif name == "keccak_f":
        nbytes, ops = keccak_f_cost(lanes)
    elif name == "round_step":
        if rounds is None or sum(rounds.values()) != lanes:
            raise ValueError(f"round_step: {lanes} rounds, priced by kind {rounds}")
        costs = [[n * v for v in round_step_cost(k, prefix, first=first)]
                 for (k, prefix, first), n in rounds.items()]
        nbytes, ops = (sum(c[i] for c in costs) for i in range(2))
    elif name == "point_double":
        nbytes, ops = point_double_cost(lanes)[0], point_double_cost(doublings)[1]
    elif name == "point_add":
        nbytes, ops = point_add_cost(lanes)
    elif name == "ntt_phase1":
        nbytes, ops = (v * lanes / (1 << 20) for v in ntt_phase1_cost(20))
    elif name == "ntt_stage":
        nbytes, ops = 2 * _NTT_ELEM * lanes, lanes // 2 * cios_lane_ops(8)
    else:
        nbytes, ops = FIELD_KERNEL_COSTS[name](lanes, 8)
    return bound(nbytes, ops, peaks).ms


# ----------------------------------------------------------------------
# timing on the card
# ----------------------------------------------------------------------

def time_events(fn, runs: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``runs`` calls, by CUDA events, after
    one call to warm up; ``flush`` (a tensor larger than the L2 cache) is
    rewritten before each."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


@dataclasses.dataclass
class KernelProfile:
    name: str
    seconds: float
    bytes_accessed: int
    lane_ops: int
    peaks: Peaks

    @property
    def gbps(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9

    @property
    def bound(self) -> Bound:
        return bound(self.bytes_accessed, self.lane_ops, self.peaks)

    @property
    def bound_share(self) -> float:
        """The bound over the measured time."""
        return self.bound.ms / (self.seconds * 1e3)

    def line(self) -> str:
        b = self.bound
        return (f"{self.name}: {self.seconds * 1e3:.4f} ms | {self.gbps:.0f} GB/s | bound "
                f"{b.ms:.4f} ms by {b.by}, {self.bound_share:.1%} of it")


def measure(name: str, fn, *args, bytes_accessed: int, lane_ops: int, iters: int = 10,
            flush=None, **kwargs) -> KernelProfile:
    """Time ``fn(*args, **kwargs)`` on the card (``time_events``, median of
    ``iters``) against its bound; raises without a card."""
    peaks = chip_peaks()
    ms = time_events(lambda: fn(*args, **kwargs), iters, flush)
    return KernelProfile(name, ms * 1e-3, bytes_accessed, lane_ops, peaks)
