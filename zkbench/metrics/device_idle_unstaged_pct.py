"""The share of the traced window, in percent, in which the card is idle and
no stage of the program is open: the device's idle time that no program span
owns (``program_spans.idle_by_stage``). ``None`` where the profile is
unresolved or the program keeps no spans."""

from zkbench.harness import program_spans

LAYER = "device"
MOVES = "prove_s"

program_spans.enable()


def read(reading):
    if not (reading.resolved and reading.events):
        return None
    idle = program_spans.idle_by_stage(reading)
    if idle is None:
        return None
    window = reading.window_ns[1] - reading.window_ns[0]
    return 100.0 * idle.get(program_spans.UNSTAGED, 0) / window
