"""The trace's records are moved onto the host clock by the two markers, and a
profile without both markers leaves the device numbers unresolved."""

from zkbench.harness import devtrace

MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_records_move_onto_the_host_clock():
    # the tracer runs 10 us ahead at the open and 20 us ahead at the close
    events = [(MARK, 1_010_000, 5), ("k", 2_015_000, 10), (MARK, 3_020_000, 5)]
    moved, offsets = devtrace.to_host_clock(events, [1_000_000, 3_000_000])
    assert offsets == [10_000, 20_000]
    assert moved == [("k", 2_000_000, 10)]  # 15 us ahead halfway


def test_a_missing_marker_leaves_no_offsets():
    events = [(MARK, 1_010_000, 5), ("k", 2_000_000, 10)]
    moved, offsets = devtrace.to_host_clock(events, [1_000_000])
    assert offsets is None and moved == [("k", 2_000_000, 10)]
