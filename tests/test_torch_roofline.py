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
