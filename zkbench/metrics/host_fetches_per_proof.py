"""Reads from the device to the host a proof: the program's fetch records
(``tensor_to_words`` of a device tensor, Pippenger's longest run). Each waits
for the card's queue to drain."""

from zkbench.harness import program_spans

LAYER = "host-device seams"
MOVES = "prove_s"

program_spans.enable()


def read(reading):
    records = program_spans.window(reading)
    if not (records and records["spans"]):
        return None
    return len(records["fetches"]) / reading.units
