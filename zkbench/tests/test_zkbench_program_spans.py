"""The readers of the program's own records (``harness/program_spans.py`` and
the five metrics on it), on a hand-built reading: a window of 1000 ns with
device records, program spans nested and not, and records before the window."""

import re

import pytest

from zkbench.harness import catalog, devtrace, program_spans
from zkbench.harness.peaks import PEAKS
from zktpu_torch.utils import tracker

H100 = "NVIDIA H100 80GB HBM3"
PEAK = PEAKS[H100]
NAMES = ("layer_tables_ms", "host_fetches_per_proof", "device_idle_unstaged_pct",
         "gkr_phase_roofline", "msm_roofline")

EVENTS = [
    ("(anonymous namespace)::gkr_big_round_kernel(unsigned int const*)", 1000, 100),
    ("(anonymous namespace)::compact_add_kernel(int const*)", 1300, 100),
    ("(anonymous namespace)::run_scan_tiles_kernel(int const*)", 1400, 50),
    ("void at::native::vectorized_gather_kernel<16, long>()", 1800, 200),
    ("(anonymous namespace)::gkr_phase_tail_kernel(unsigned int const*)", 2100, 500),  # after
]
# idle: 1100-1300 and 1450-1800
RECORDS = {
    "spans": [
        ("gkr.tables", 500, 900, 0),  # the warm-up's
        ("gkr.tables", 1150, 1200, 1),
        ("gkr.sumcheck", 1050, 1250, 0),
        ("kzg.commit_msm", 1500, 1600, 0),
    ],
    "work": [
        (800, "gkr_phase", 10**9, 10**9, 10**9),  # before the window
        (1060, "gkr_phase", round(PEAK["bytes_per_s"] * 10e-9), 0, 20),  # 10 + 20 ns
        (1310, "run_scan", round(PEAK["bytes_per_s"] * 10e-9), 0, 0),  # 10 ns
        (1320, "compact_add", 0, round(PEAK["int32_mad_per_s"] * 20e-9), 0),  # 20 ns
    ],
    "fetches": [(700, "tensor_to_words", 32), (1240, "tensor_to_words", 96),
                (1245, "tensor_to_words", 96), (1460, "pippenger.longest", 4)],
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


def test_loading_a_reader_turns_the_programs_recording_on():
    tracker.record(False)
    catalog.metric_reader("layer_tables_ms")
    assert tracker.recording


def test_window_leaves_the_warm_up_out_and_sorts_outer_first(readers):
    records = program_spans.window(reading())
    assert [s[0] for s in records["spans"]] == ["gkr.sumcheck", "gkr.tables", "kzg.commit_msm"]
    assert [w[1] for w in records["work"]] == ["gkr_phase", "run_scan", "compact_add"]
    assert len(records["fetches"]) == 3


def test_idle_by_the_innermost_stage(readers):
    assert program_spans.idle_gaps(reading()) == [(1100, 1300), (1450, 1800)]
    assert program_spans.idle_by_stage(reading()) == {
        "gkr.sumcheck": 100, "gkr.tables": 50, "kzg.commit_msm": 100, program_spans.UNSTAGED: 300}


def test_each_reader_on_the_hand_built_window(readers):
    got = {name: readers[name].read(reading()) for name in NAMES}
    assert got["layer_tables_ms"] == pytest.approx(50 / 1e6 / 2)
    assert got["host_fetches_per_proof"] == 1.5
    assert got["device_idle_unstaged_pct"] == pytest.approx(30.0)
    assert got["gkr_phase_roofline"] == pytest.approx(30.0, rel=1e-6)  # 30 ns of 100
    assert got["msm_roofline"] == pytest.approx(20.0, rel=1e-6)  # 30 ns of 150


def test_an_unresolved_profile_gives_no_device_numbers(readers):
    got = {name: readers[name].read(reading(resolved=False)) for name in NAMES}
    assert got["device_idle_unstaged_pct"] is None
    assert got["gkr_phase_roofline"] is None and got["msm_roofline"] is None
    assert got["layer_tables_ms"] is not None and got["host_fetches_per_proof"] == 1.5


def test_a_program_without_the_recorder_gives_nothing(monkeypatch, readers):
    monkeypatch.setattr(program_spans, "source", lambda: None)
    assert all(readers[name].read(reading()) is None for name in NAMES)


def test_kernel_patterns_name_the_port_kernels(readers):
    gkr, msm = readers["gkr_phase_roofline"].KERNELS, readers["msm_roofline"].KERNELS
    assert [bool(gkr.search(e[0])) for e in EVENTS] == [True, False, False, False, True]
    assert [bool(msm.search(e[0])) for e in EVENTS] == [False, True, True, False, False]
    assert msm.search("run_scan_fill_kernel(int)") and msm.search("horner_kernel(x)")
    assert isinstance(gkr, re.Pattern)
