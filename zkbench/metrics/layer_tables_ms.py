"""The GKR layers' table building: the program's ``gkr.tables`` spans (the
wiring coefficients of ``lazy_fbc`` / ``lazy_folded_fbc``, and inside the fused
prover the phase stacks and the eq table), host milliseconds a proof. The
program's spans never synchronise: this is the host's time queueing that work."""

from zkbench.harness import program_spans

LAYER = "GKR layer tables"
MOVES = "prove_s"

program_spans.enable()


def read(reading):
    records = program_spans.window(reading)
    if not records:
        return None
    spans = [s for s in records["spans"] if s[0] == "gkr.tables"]
    if not spans:
        return None
    return sum(end - start for _, start, end, _ in spans) / 1e6 / reading.units
