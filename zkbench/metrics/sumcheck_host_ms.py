"""The plain sumcheck's host stages before its rounds: the program's
``sumcheck.claim`` (the table's canonical words fetched and summed on the host)
and ``sumcheck.absorb`` (the table's bytes and the claimed sum into the host
transcript) spans, host milliseconds a proof. The program's spans never
synchronise; under these two the card has only the table's conversion to do."""

from zkbench.harness import program_spans

LAYER = "sumcheck claim and transcript prefix"
MOVES = "prove_s"
NAMES = ("sumcheck.claim", "sumcheck.absorb")

program_spans.enable()


def read(reading):
    records = program_spans.window(reading)
    if not records:
        return None
    spans = [s for s in records["spans"] if s[0] in NAMES]
    if not spans:
        return None
    return sum(end - start for _, start, end, _ in spans) / 1e6 / reading.units
