"""The GKR layers' sumcheck provers: the spans around each call of
``gkr_prove_lazy_fused`` that ``gkr/protocol.py`` makes, summed, in
milliseconds a proof."""

LAYER = "GKR sumcheck provers"
MOVES = "prove_s"
SPANS = {"gkr_prove_lazy_fused": "zktpu_torch.gkr.protocol:gkr_prove_lazy_fused"}


def read(reading):
    if not reading.spans.get("gkr_prove_lazy_fused"):
        return None
    return reading.span_ms("gkr_prove_lazy_fused") / reading.units
