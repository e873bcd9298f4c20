"""Host packing of a proof's inputs: the span around ``MultilinearPoly.from_ints``
(Python ints to words, upload, Montgomery form), in milliseconds a proof."""

LAYER = "host packing"
MOVES = "prove_s"
SPANS = {"from_ints": "zktpu_torch.poly.multilinear:MultilinearPoly.from_ints"}


def read(reading):
    if not reading.spans.get("from_ints"):
        return None
    return reading.span_ms("from_ints") / reading.units
