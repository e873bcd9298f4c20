"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name`` gives.

H100 SXM (NVIDIA's data sheet, at its 700 W limit): HBM3 at 3.35e12 bytes a
second; 32-bit integer multiply-adds at 132 SMs x 64 INT32 lanes x the 1.98 GHz
boost clock. A card not listed has no roofline: a share of a guessed peak would
read as a measurement.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "int32_mad_per_s": 132 * 64 * 1.98e9},
}


def montgomery_product_ops(words: int) -> int:
    """32-bit multiply-adds of one Montgomery product of ``words``-word
    elements: W^2 for the product, W^2 + W for the reduction, each counted
    twice (low and high halves)."""
    return 2 * (2 * words * words + words)
