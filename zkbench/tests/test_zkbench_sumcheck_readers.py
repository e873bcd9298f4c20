"""The plain sumcheck's two readers (``sumcheck_host_ms``,
``sumcheck_round_roofline``) on a hand-built reading: a window of 1000 ns
holding two proofs' spans, round work records and device records, with a
warm-up's records before it."""

import pytest

from zkbench.harness import catalog, devtrace, program_spans
from zkbench.harness.peaks import PEAKS
from zktpu_torch.utils import tracker

H100 = "NVIDIA H100 80GB HBM3"
PEAK = PEAKS[H100]
NAMES = ("sumcheck_host_ms", "sumcheck_round_roofline")

EVENTS = [
    ("void (anonymous namespace)::mont_mul_kernel<8>(unsigned int const*)", 1010, 40),
    ("(anonymous namespace)::halves_sums_kernel(unsigned int const*)", 1100, 20),
    ("void (anonymous namespace)::round_step_kernel<2, true>(int const*)", 1130, 10),
    ("(anonymous namespace)::fold_and_halves_kernel(unsigned int const*)", 1150, 10),
    ("void (anonymous namespace)::round_step_kernel<2, false>(int const*)", 1170, 10),
    ("(anonymous namespace)::halves_sums_kernel(unsigned int const*)", 2100, 50),  # after
]
RECORDS = {
    "spans": [
        ("sumcheck.claim", 500, 900, 0),  # the warm-up's
        ("sumcheck.claim", 1000, 1040, 0),
        ("sumcheck.absorb", 1040, 1090, 0),
        ("sumcheck.rounds", 1090, 1100, 0),
        ("sumcheck.fetch", 1100, 1190, 0),
        ("sumcheck.claim", 1200, 1230, 0),
        ("sumcheck.absorb", 1230, 1270, 0),
        ("tensor_to_words", 1205, 1210, 1),
    ],
    "work": [
        (800, "sumcheck_round", 10**9, 10**9, 10**9),  # before the window
        (1092, "sumcheck_round", round(PEAK["bytes_per_s"] * 5e-9), 0, 3),  # 5 + 3 ns
        (1095, "sumcheck_round", 0, round(PEAK["int32_mad_per_s"] * 4e-9), 0),  # 4 ns
        (1096, "gkr_phase", 10**6, 0, 0),  # another path's
    ],
    "fetches": [],
}


def reading(resolved=True, events=EVENTS):
    return devtrace.Reading(units=2, window_ns=(1000, 2000), spans={}, events=list(events),
                            resolved=resolved, launches={}, config={}, mix={}, device_name=H100)


@pytest.fixture
def readers(monkeypatch):
    monkeypatch.setattr(program_spans, "source", lambda: RECORDS)
    return {name: catalog.metric_reader(name) for name in NAMES}


@pytest.fixture(autouse=True)
def recorder_off_after():
    yield
    tracker.record(False)
    tracker.reset()


def test_each_reader_on_the_hand_built_window(readers):
    assert readers["sumcheck_host_ms"].read(reading()) == pytest.approx((40 + 50 + 30 + 40) / 1e6 / 2)
    # 12 ns of least time over the 50 ns of the round kernels in the window
    assert readers["sumcheck_round_roofline"].read(reading()) == pytest.approx(24.0, rel=1e-6)


def test_the_kernel_pattern_names_the_round_kernels_alone(readers):
    pattern = readers["sumcheck_round_roofline"].KERNELS
    assert [bool(pattern.search(e[0])) for e in EVENTS] == [False, True, True, True, True, True]
    assert not pattern.search("(anonymous namespace)::gkr_big_round_kernel(int)")
    assert not pattern.search("(anonymous namespace)::fold_kernel(int)")


def test_an_unresolved_profile_gives_no_roofline(readers):
    assert readers["sumcheck_round_roofline"].read(reading(resolved=False)) is None
    assert readers["sumcheck_host_ms"].read(reading(resolved=False)) is not None


def test_a_program_without_the_records_gives_nothing(monkeypatch, readers):
    monkeypatch.setattr(program_spans, "source", lambda: None)
    assert all(readers[name].read(reading()) is None for name in NAMES)
    monkeypatch.setattr(program_spans, "source",
                        lambda: {"spans": [("gkr.tables", 1100, 1200, 0)], "work": [], "fetches": []})
    assert all(readers[name].read(reading()) is None for name in NAMES)
