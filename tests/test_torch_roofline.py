"""``zktpu_torch.utils.roofline``: the bounds that PERF.md section 6 states, and
no peak, bound or timing without a card.

The bounds are computed here from the H100 entry of ``PEAKS`` (a measurement
needs the card; a cost model does not), rounded as PERF.md prints them.
"""

import pytest
import torch

import chip_smoke
from zktpu_torch.utils import roofline as rl

H100 = rl.PEAKS[rl.H100]

# (cost, PERF.md section 6's bound in ms, what bounds it)
ROWS = {
    "mont_mul 2^20": (rl.mont_mul_cost(1 << 20, 8), 0.0200, "bytes"),
    "mont_mul 2^24": (rl.mont_mul_cost(1 << 24, 8), 0.3205, "bytes"),
    "mont_mul W=12 2^20": (rl.mont_mul_cost(1 << 20, 12), 0.0376, "operations"),
    "fold 2^20": (rl.fold_cost(1 << 20, 8), 0.0150, "bytes"),
    "fold 2^24": (rl.fold_cost(1 << 24, 8), 0.2404, "bytes"),
    "halves_sums 2^20": (rl.halves_sums_cost(1 << 20, 8), 0.0100, "bytes"),
    "halves_sums 2^24": (rl.halves_sums_cost(1 << 24, 8), 0.1603, "bytes"),
    "fold_and_halves 2^20": (rl.fold_and_halves_cost(1 << 20, 8), 0.0150, "bytes"),
    "fold_and_halves 2^24": (rl.fold_and_halves_cost(1 << 24, 8), 0.2404, "bytes"),
    "gkr_round 2^20": (rl.gkr_round_cost(1 << 20, 8), 0.0527, "operations"),
    "gkr_round 2^24": (rl.gkr_round_cost(1 << 24, 8), 0.8425, "operations"),
    "point_add 2^16": (rl.point_add_cost(1 << 16), 0.0348, "operations"),
    "point_add 2^20": (rl.point_add_cost(1 << 20), 0.5567, "operations"),
    "point_double 2^16": (rl.point_double_cost(1 << 16), 0.0136, "operations"),
    "point_double 2^20": (rl.point_double_cost(1 << 20), 0.2182, "operations"),
    "ntt_phase1 2^20": (rl.ntt_phase1_cost(20), 0.0682, "operations"),
    "ntt_phase1 2^22": (rl.ntt_phase1_cost(22), 0.2729, "operations"),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_bounds_of_perf_md(row):
    cost, ms, by = ROWS[row]
    b = rl.bound(*cost, H100)
    assert round(b.ms, 4) == ms
    assert b.by == by


def test_operations_a_lane():
    assert rl.cios_lane_ops(8) == 272 and rl.cios_lane_ops(12) == 600
    assert rl.sqr_lane_ops(12) == 456
    assert rl.point_add_cost(1) == (432, 8880)
    assert rl.point_double_cost(1) == (288, 3480)
    assert rl.elem_bytes(8) == 32


def test_ntt_bounds():
    """phase 1 bytes at 2^20; the mean over the later stages; the transform's
    kernels together (PERF.md section 5)."""
    assert round(rl.bound(*rl.ntt_phase1_cost(20), H100).bytes_ms, 4) == 0.0200
    for log_n, mean, total in ((20, 0.0210, 0.2786), (22, 0.0835, 1.2745)):
        costs = rl.ntt_cost(log_n)
        assert len(costs) == 1 + log_n - 10 and costs[0] == rl.ntt_phase1_cost(log_n)
        stages = [rl.bound(*c, H100).ms for c in costs[1:]]
        assert round(sum(stages) / len(stages), 4) == mean
        assert round(sum(rl.bound(*c, H100).ms for c in costs), 4) == total


def test_lanes_bound_ms():
    assert rl.lanes_bound_ms("fold", 0, 0, H100) == 0.0
    for name in rl.FIELD_KERNEL_COSTS:
        assert rl.lanes_bound_ms(name, 1 << 20, 0, H100) == rl.bound(
            *rl.FIELD_KERNEL_COSTS[name](1 << 20, 8), H100).ms
    assert rl.lanes_bound_ms("point_add", 1 << 20, 0, H100) == rl.bound(
        *rl.point_add_cost(1 << 20), H100).ms
    # point_double: bytes by lanes, products by doublings
    assert rl.lanes_bound_ms("point_double", 1, 1 << 20, H100) == rl.bound(
        288, rl.point_double_cost(1 << 20)[1], H100).ms


def test_transcript_bounds_in_nanoseconds():
    """keccak_f and round_step at the paths' shapes: the whole card's bound is
    nanoseconds (by operations), the one thread's least time microseconds
    (PERF.md section 6's second table). A Keccak round is 180 instructions
    with every three-input logical function one LOP3 a 32-bit half."""
    assert (rl.KECCAK_ROUND_OPS, rl.KECCAK_F_OPS) == (180, 4320)
    rows = {  # cost, bound ns, one thread's least us
        "keccak_f, one state": (rl.keccak_f_cost(1), 0.2583, 2.1818),
        "round_step, sumcheck": (rl.round_step_cost(2), 0.3070, 2.5939),
        "round_step, GKR": (rl.round_step_cost(3), 0.3396, 2.8687),
        "round_step, GKR first, two blocks": (rl.round_step_cost(3, 16, 2, True), 0.5978, 5.0505),
    }
    for cost, ns, us in rows.values():
        b = rl.bound(*cost, H100)
        assert (round(b.ms * 1e6, 4), b.by) == (ns, "operations")
        assert round(rl.one_thread_ms(cost[1]) * 1e3, 4) == us
    assert rl.round_step_cost(2) == (400, 3 * 272 + 4320)
    assert rl.lanes_bound_ms("keccak_f", 33, 0, H100) == rl.bound(*rl.keccak_f_cost(33), H100).ms


def test_round_step_priced_by_kind():
    """A first round's blocks are what its content needs at the least: a plain
    sumcheck's tail of 8 lanes and two sums fit one block, 9 lanes do not; a
    GKR round's trimmed length is on the card, so its content is priced at
    none. A path's rounds are priced each at its own cost."""
    assert [rl.round_step_blocks(2, t, True) for t in (0, 8, 9, 16)] == [1, 1, 2, 2]
    assert [rl.round_step_blocks(3, t, True) for t in (0, 16)] == [1, 1]
    assert rl.round_step_blocks(2, 4, False) == rl.round_step_blocks(3, 4, False) == 1
    assert rl.round_step_cost(2, 9, first=True) == rl.round_step_cost(2, 9, 2, True)
    rounds = {(2, 9, True): 1, (2, 4, False): 19, (3, 6, True): 2, (3, 4, False): 40}
    nbytes = (rl.round_step_cost(2, 9, first=True)[0] + 19 * rl.round_step_cost(2)[0]
              + 2 * rl.round_step_cost(3, 6, first=True)[0] + 40 * rl.round_step_cost(3)[0])
    ops = (rl.round_step_cost(2, 9, 2)[1] + 19 * rl.round_step_cost(2)[1]
           + 42 * rl.round_step_cost(3)[1])
    assert rl.lanes_bound_ms("round_step", 62, 0, H100, rounds) == rl.bound(nbytes, ops, H100).ms
    with pytest.raises(ValueError):
        rl.lanes_bound_ms("round_step", 61, 0, H100, rounds)
    with pytest.raises(ValueError):
        rl.lanes_bound_ms("round_step", 62, 0, H100)


def test_msm_kernel_costs():
    """run_scan and compact_add at the commitment's first round (2^24 keys ->
    8,650,762 slots) and at a steady one (1,032,211); horner's chain, whose one
    thread sets its least time: 240 doublings and 15 additions at c = 16,
    252 and 63 at c = 4 (PERF.md section 6)."""
    first, steady = 8_650_762, 1_032_211
    assert rl.run_scan_cost(1 << 24, first) == (4 * ((1 << 24) + first + 2), 0)
    assert rl.run_scan_cost(steady, steady) == (4 * (2 * steady + 2), 0)
    b = rl.bound(*rl.run_scan_cost(1 << 24, first), H100)
    assert (round(b.ms, 4), b.by) == (0.0304, "bytes")
    # a slot: srcpos, key and the neighbour's key and a point read; a key and
    # a point written; an addition reads the neighbour's point
    assert rl.compact_add_cost(1, 1, 0) == (4 + 12 + 144 + 148, 0)
    assert rl.compact_add_cost(1, 1, 1) == (4 + 12 + 144 + 144 + 148, 8880)
    assert rl.compact_add_cost(2, 0, 0) == (4 + 2 * 148, 0)
    b = rl.bound(*rl.compact_add_cost(first, first, 0), H100)
    assert (round(b.ms, 4), b.by) == (0.7850, "bytes")
    b = rl.bound(*rl.compact_add_cost(first, first, 1 << 21), H100)
    assert (round(b.ms, 4), b.by) == (1.1133, "operations")
    assert rl.horner_chain_ops(16, 16) == 240 * 3480 + 15 * 8880 == 968_400
    assert rl.horner_chain_ops(64, 4) == 252 * 3480 + 63 * 8880 == 1_436_400
    assert rl.horner_chain_ops(1, 16) == 0
    assert round(rl.one_thread_ms(rl.horner_chain_ops(16, 16)), 4) == 0.4891
    assert round(rl.one_thread_ms(rl.horner_chain_ops(64, 4)), 4) == 0.7255
    assert rl.horner_cost(2, 16, 16) == (2 * 17 * 144, 2 * 968_400)
    b = rl.bound(*rl.horner_cost(1, 16, 16), H100)
    assert (round(b.ms * 1e6, 2), b.by) == (57.89, "operations")


def test_msm_kernels_priced_on_a_path():
    """run_scan by keys and slots, compact_add by slots with no addition
    priced, horner by its chains' kinds."""
    assert rl.lanes_bound_ms("run_scan", 100, 0, H100, scan_slots=60) == rl.bound(
        *rl.run_scan_cost(100, 60), H100).ms
    assert rl.lanes_bound_ms("compact_add", 60, 0, H100) == rl.bound(
        *rl.compact_add_cost(60, 60, 0), H100).ms
    chains = {(16, 16): 1, (64, 4): 2}
    want = rl.bound(rl.horner_cost(1, 16, 16)[0] + rl.horner_cost(2, 64, 4)[0],
                    rl.horner_cost(1, 16, 16)[1] + rl.horner_cost(2, 64, 4)[1], H100).ms
    assert rl.lanes_bound_ms("horner", 3, 0, H100, chains=chains) == want
    with pytest.raises(ValueError):
        rl.lanes_bound_ms("horner", 2, 0, H100, chains=chains)
    with pytest.raises(ValueError):
        rl.lanes_bound_ms("horner", 3, 0, H100)


def test_one_peak_entry_and_none_without_a_card():
    assert list(rl.PEAKS) == ["NVIDIA H100 80GB HBM3"]
    assert H100.bytes_per_s == 3.35e12 and H100.int32_mad_per_s == 132 * 64 * 1.98e9
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        rl.chip_peaks()
    with pytest.raises(RuntimeError):
        rl.chip_peaks("cpu")
    with pytest.raises(RuntimeError):
        rl.bound(1, 1)
    with pytest.raises(RuntimeError):
        rl.measure("fold", lambda: None, bytes_accessed=1, lane_ops=1)
    with pytest.raises(RuntimeError):
        with rl.trace("unused"):
            pass


def test_chip_smoke_keeps_no_rate_of_its_own():
    with open(chip_smoke.__file__, encoding="utf-8") as f:
        source = f.read()
    for constant in ("3.35e12", "1.98e9", "HBM_BYTES_PER_S", "INT32_MAD_PER_S"):
        assert constant not in source
    assert chip_smoke.time_events is rl.time_events
