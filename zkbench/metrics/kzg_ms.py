"""KZG and its MSMs: the spans around ``KZG.for_poly`` (the SRS), ``KZG.open``
and ``KZG.commit_with_proof_pair`` (the commitment and quotient MSMs), in
milliseconds a proof."""

LAYER = "KZG and MSMs"
MOVES = "prove_s"
SPANS = {
    "KZG.for_poly": "zktpu_torch.pcs.kzg:KZG.for_poly",
    "KZG.open": "zktpu_torch.pcs.kzg:KZG.open",
    "KZG.commit_with_proof_pair": "zktpu_torch.pcs.kzg:KZG.commit_with_proof_pair",
}


def read(reading):
    if not reading.spans.get("KZG.for_poly"):
        return None
    return reading.span_ms(*SPANS) / reading.units
